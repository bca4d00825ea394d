"""Fused stem kernels and their plain versions: the stem pair (K4, K8,
K11 and K12), the deep pair (K12 at stages 4+6), the single stage K9 and
its NHWC spelling K10. Source: ``millieye_torch/csrc/stem.cu``.

K9 ``fused_stem_stage`` (port of
``millieye_tpu/ops/stem_pallas.py:fused_stem_planar``):

    out = maxpool2(leaky(conv3x3(x, w) + b))

x [N, H, W, Cin] float32 NHWC -> [N, H/2, W/2, Cout] NHWC in
``out_dtype`` (float32, bfloat16 or float16), w [Cout, Cin, 3, 3] OIHW.
``precision="default"`` rounds x and w to bf16 and accumulates the
products in float32; ``"highest"`` is float32 throughout; bias, leaky
and the pool follow in float32, then one rounding to ``out_dtype``. At
"default" the kernel multiplies on the tensor cores and is held within
``PAIR_DEFAULT_TOL`` of its plain version (see the pair below); at
"highest" it sums on the CUDA cores in the plain version's order.

K10 ``fused_stem`` (port of ``stem_pallas.py:fused_stem``, which the JAX
package runs only from its tests): the same function with the JAX
package's arguments, x [N, H, W, Cin] of any float type, w [3, 3, Cin,
Cout] HWIO, output in ``out_dtype`` (default x's type); float32 products
and sums, the taps in the order of the TPU kernel's patch build: (v, u,
c) for ``variant`` "vconcat" and "vroll", (u, v, c) for "im2col". The
row band ``th`` is checked (H/2 % th == 0) and changes nothing else. Any
Cin and Cout: on the card ``nhwc_route`` names the kernel a shape takes,
and both sum in that order.

The stem pair, two such stages in one kernel with the half-size
intermediate kept on chip:

    out = maxpool2(leaky(conv3x3(maxpool2(leaky(conv3x3(x, w0) + b0)), w1)
                   + b1))

x [N, H, W, Cin] float32 NHWC -> [N, H/4, W/4, Cout] NHWC in
``out_dtype``, with the port's OIHW weights w0 [Cmid, Cin, 3, 3], w1
[Cout, Cmid, 3, 3] and float32 biases. At ``precision="default"`` the
input and w0 are rounded to bf16, products accumulate in float32, the
float32 intermediate is rounded to bf16 as stage 1's operand, with w1 in
bf16; ``"highest"`` is float32 throughout; one rounding to ``out_dtype``
at the end. Four Pallas kernels compute this function on the TPU, each
with its own wrapper and launch count here:

* K4 ``fused_stem_pair``: ``stem_pallas.py:fused_stem2_phase`` (its
  ``bf16_only``, ``input_mode`` and ``scratch_dtype`` options buffer
  VMEM and give the same numbers);
* K8 ``fused_stem_pair_select``: ``stem_pallas.py:fused_stem2_planar``,
  whose pool picks its columns with a one-hot matmul split hi/lo: at
  "default" each pooled value becomes ``hi + bf16(v - hi)``, ``hi =
  bf16(v)``, at both stages (``_pool_select_dot``). That can differ from
  ``v`` where ``v`` has more than 16 significant bits, so a float16 store
  may round it one ulp the other way: not K4's function. At "highest"
  the select is exact;
* K11 ``fused_stem_pair_packed``: ``stem_pallas_rejected.py:
  fused_stem2_packed`` (stage 0 K-packed on the MXU);
* K12 ``fused_stem_pair_s2d``: ``stem_pallas_rejected.py:fused_stem2_s2d``
  (stage 1 as 2x2 space-to-depth), at the stem shape and as the deep pair
  of stages 4+6 (104 px, 32 -> 64 -> 128, bf16 store).

K4, K8 (in its own pool mode), K11 and K12 launch one CUDA kernel, which
holds both weight sets and an 8x8 tile's input halo in shared memory;
the packing and the space-to-depth regrouping are MXU layouts with no
meaning on the card. At "default" it runs its products on the tensor
cores (``mma.sync`` on bf16 operands, float32 accumulators), which sum
each k-group of 16 in an order and with a rounding that no PyTorch
spelling repeats: there the kernel is held to its plain version within
2^-6 of the largest output (``PAIR_DEFAULT_TOL``), not bit for bit. At
"highest" it sums on the CUDA cores in the plain version's order and is
bit-equal. Where the tile does not fit (the deep pair of stages 4+6, or
widths such as 16 -> 32 -> 64), each of the four wrappers runs
``fused_stem_pair_deep`` instead (``pair_route``, the same on the CPU
and the card; K8 with its select), which counts its own launches: at
"default" a tensor-core kernel that streams the second layer's weights
through shared memory, at "highest" two CUDA-core launches, one per
stage, through a float32 intermediate in device scratch (bit-equal).
``scratch_dtype`` and ``groups0`` are checked as the JAX package checks
them (bf16 scratches only at "default"; ``groups0`` in {2, 4, 8}) and
change nothing else.

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
raises (outside ``cuda_lib.plain_versions()``). ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import itertools

import torch
import torch.nn.functional as F

from millieye_torch.ops import cuda_lib


# the wrappers (names as cuda_lib.KERNELS has them) whose kernels run on
# the tensor cores at "default", and their bound there, as a share of the
# plain version's largest |output|
TENSOR_CORE_KERNELS = ("stem_pair", "stem_pair_select", "stem_pair_packed",
                       "stem_pair_s2d", "stem_pair_deep", "stem_stage")
PAIR_DEFAULT_TOL = 2.0 ** -6


def _leaky(x):
    return torch.where(x > 0, x, 0.1 * x)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _conv3x3(x, w, order):
    """3x3 convolution with zero padding 1, summed as the kernels sum it:
    one multiply and one add at a time into a float32 sum that starts at
    0, over the taps in ``order``, slowest first: "cuv" (K9 and the deep
    pair), "uvc" (the stem pair, K10's "im2col") or "vuc" (K10's
    "vconcat" and "vroll"). x [N, C, H, W], w [O, C, 3, 3]. With bf16
    operands every product is exact in float32, so the kernels' FMA rounds
    like this add; with float32 operands the kernels round the product
    first, as the multiply here does."""
    n, c, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = x.new_zeros((n, w.shape[0], h, wd))
    ranges = {"c": range(c), "u": range(3), "v": range(3)}
    for tap in itertools.product(*(ranges[a] for a in order)):
        idx = dict(zip(order, tap))
        ci, u, v = idx["c"], idx["u"], idx["v"]
        acc = acc + (xp[:, ci:ci + 1, u:u + h, v:v + wd]
                     * w[:, ci, u, v][None, :, None, None])
    return acc


_STORE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_stem_stage_plain(x, w, b, precision="default",
                           out_dtype=torch.float32):
    """K9's arithmetic, operation for operation, in PyTorch (at "default"
    the operands hold bf16 values, so each product is exact and the
    kernel's FMA rounds like this add)."""
    xc, wc = x.permute(0, 3, 1, 2).float(), w.float()
    if precision == "default":
        xc, wc = _bf16(xc), _bf16(wc)
    y = _conv3x3(xc, wc, "cuv") + b.float()[:, None, None]
    y = F.max_pool2d(_leaky(y), 2)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def _pool_select(v):
    """K8's pool select at "default": hi + bf16(v - hi), hi = bf16(v)
    (the difference and the sum are exact in float32)."""
    hi = _bf16(v)
    return hi + _bf16(v - hi)


def fused_stem_pair_plain(x, w0, b0, w1, b1, precision="default",
                          out_dtype=torch.float16, select=False):
    """The stem pair's function in PyTorch, summed in the CUDA-core
    order: K4, K11 and K12 at the stem shape, and K8 with ``select``. At
    "highest" the kernel gives bit-equal outputs; at "default" its tensor
    cores sum in their own order (within ``PAIR_DEFAULT_TOL``)."""
    if precision == "highest":
        op, sel = torch.Tensor.float, (lambda v: v)
    else:
        op, sel = _bf16, (_pool_select if select else (lambda v: v))
    y = _conv3x3(op(x.permute(0, 3, 1, 2)), op(w0), "uvc") \
        + b0.float()[:, None, None]
    y = sel(F.max_pool2d(_leaky(y), 2))
    y = _conv3x3(op(y), op(w1), "uvc") + b1.float()[:, None, None]
    y = sel(F.max_pool2d(_leaky(y), 2))
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def fused_stem_pair_deep_plain(x, w0, b0, w1, b1, precision="default",
                               out_dtype=torch.bfloat16, select=False):
    """The deep pair's function: two K9 stages, the float32 intermediate
    never stored in another type (at "default" stage 1 rounds it to bf16
    as its operand, as the kernels do), with K8's pool select after each
    stage at "default" when ``select``. The CUDA-core kernel sums in this
    order; the tensor-core kernel ("default") is held within
    ``PAIR_DEFAULT_TOL``."""
    sel = _pool_select if select and precision == "default" else (
        lambda v: v)
    y = sel(fused_stem_stage_plain(x, w0, b0, precision, torch.float32))
    y = sel(fused_stem_stage_plain(y, w1, b1, precision, torch.float32))
    return y.to(out_dtype)


def fused_stem_pair_f64(x, w0, b0, w1, b1):
    """The pair's function evaluated in float64: [N, H/4, W/4, Cout]
    float64, the yardstick for the rounding of the float32 sums at
    "highest" (the deep pair's too)."""
    y = x.permute(0, 3, 1, 2).double()
    for w, b in ((w0, b0), (w1, b1)):
        y = F.max_pool2d(_leaky(F.conv2d(y, w.double(), b.double(),
                                         padding=1)), 2)
    return y.permute(0, 2, 3, 1).contiguous()


def _lib():
    lib = cuda_lib.library("stem")
    lib.millieye_stem_pair.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p])
    lib.millieye_stem_pair_deep.argtypes = ([ctypes.c_void_p] * 7
                                            + [ctypes.c_int] * 9
                                            + [ctypes.c_void_p])
    lib.millieye_stem_stage.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.millieye_stem_nhwc.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.millieye_stem_nhwc_route.argtypes = [ctypes.c_int] * 2
    lib.millieye_stem_nhwc_route.restype = ctypes.c_int
    for fn in (lib.millieye_stem_pair, lib.millieye_stem_pair_deep,
               lib.millieye_stem_stage, lib.millieye_stem_nhwc):
        fn.restype = ctypes.c_int
    lib.millieye_stem_pair_deep_scratch_bytes.argtypes = [ctypes.c_int] * 7
    lib.millieye_stem_stage_scratch_bytes.argtypes = [ctypes.c_int] * 2
    for fn in (lib.millieye_stem_pair_deep_scratch_bytes,
               lib.millieye_stem_stage_scratch_bytes):
        fn.restype = ctypes.c_size_t
    return lib


def _check_cuda(name, x, *weights):
    for t in weights:
        if t.device != x.device:
            raise ValueError(f"{name}: x on {x.device}, a weight on "
                             f"{t.device}")
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"{name}: want a float32 CUDA input, got {x.dtype} "
                        f"on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous NHWC input")


def fused_stem_stage(x, w, b, precision="default", out_dtype=torch.float32):
    """K9: [N, H, W, Cin] float32 -> [N, H/2, W/2, Cout] ``out_dtype``
    (see module)."""
    if precision not in ("default", "highest"):
        raise ValueError(f"fused_stem_stage: unknown precision {precision!r}")
    if out_dtype not in _STORE_CODES:
        raise TypeError(f"fused_stem_stage: cannot store {out_dtype}")
    if cuda_lib.takes_plain(x, "stem_stage"):
        return fused_stem_stage_plain(x, w, b, precision, out_dtype)
    _check_cuda("fused_stem_stage", x, w, b)
    if x.dim() != 4:
        raise ValueError("fused_stem_stage: want an NHWC input")
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3) or b.shape != (cout,):
        raise ValueError(f"fused_stem_stage: weights {tuple(w.shape)}, "
                         f"{tuple(b.shape)} for {cin} input channels")
    if h % 2 or wd % 2 or cout % 8 or n == 0:
        raise ValueError(f"fused_stem_stage: need even H, W and Cout % 8 == "
                         f"0, got {tuple(x.shape)}, {cout}")
    # kernel layout: [cin, 3, 3, cout] float32; at "default" the kernel
    # rounds x and w to bf16 as it loads them, the weights into
    # ``scratch`` in the tensor cores' fragment order
    wk = w.float().permute(1, 2, 3, 0).contiguous()
    bk = b.float().contiguous()
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=out_dtype,
                      device=x.device)
    lib = _lib()
    scratch = torch.empty(lib.millieye_stem_stage_scratch_bytes(cin, cout),
                          dtype=torch.uint8, device=x.device)
    rc = lib.millieye_stem_stage(
        cuda_lib.ptr(x), cuda_lib.ptr(wk), cuda_lib.ptr(bk),
        cuda_lib.ptr(out), cuda_lib.ptr(scratch), n, h, wd, cin, cout,
        int(precision == "highest"), _STORE_CODES[out_dtype],
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(lib, rc, "fused_stem_stage")
    fused_stem_stage.launches += 1
    return out


# ------------------------------------------------------------------ K10
_NHWC_VARIANTS = ("vconcat", "vroll", "im2col")


def nhwc_route(cin, cout):
    """Which kernel K10 launches on the card for these channel counts
    (``nhwc_resident`` in csrc/stem.cu; ``millieye_stem_nhwc_route`` asks
    the library): "resident" where the whole [9, cin, cout] weight set
    (cout rounded up to 4) and the input halo of an 8 x 8 tile of pooled
    pixels (18 rows of 18 pixels at a pitch of 20, x cin) fit a block's
    shared memory, else "streamed", which streams the weights a tap and a
    chunk of input channels at a time and takes any width. Both sum in
    the variant's tap order, so the plain version is the same for both."""
    floats = 9 * cin * _round4(cout) + _round4(cout) + _round4(18 * 20 * cin)
    return "resident" if 4 * floats <= _SMEM_LIMIT else "streamed"


def _check_nhwc(x, w, b, th, out_dtype, variant):
    """The JAX wrapper's checks; returns the store type."""
    if variant not in _NHWC_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"fused_stem: want NHWC x and HWIO w, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin) or tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"fused_stem: weights {tuple(w.shape)}, "
                         f"{tuple(b.shape)} for {cin} input channels")
    if h % 2 or wd % 2 or th < 1 or (h // 2) % th:
        raise ValueError(f"fused_stem: need even H, W and (H/2) % th == 0, "
                         f"got {tuple(x.shape)}, th={th}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in _STORE_CODES:
        raise TypeError(f"fused_stem: cannot store {out_dtype}")
    return out_dtype


def fused_stem_plain(x, w, b, th=26, out_dtype=None, variant="vconcat"):
    """K10's arithmetic, operation for operation, in PyTorch."""
    out_dtype = _check_nhwc(x, w, b, th, out_dtype, variant)
    order = "uvc" if variant == "im2col" else "vuc"
    y = _conv3x3(x.permute(0, 3, 1, 2).float(),
                 w.float().permute(3, 2, 0, 1), order) \
        + b.float()[:, None, None]
    y = F.max_pool2d(_leaky(y), 2)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def fused_stem(x, w, b, th=26, out_dtype=None, variant="vconcat"):
    """K10: [N, H, W, Cin] -> [N, H/2, W/2, Cout] (see module)."""
    out_dtype = _check_nhwc(x, w, b, th, out_dtype, variant)
    if cuda_lib.takes_plain(x, "fused_stem"):
        return fused_stem_plain(x, w, b, th, out_dtype, variant)
    xk = x.float().contiguous()
    _check_cuda("fused_stem", xk, w, b)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    # HWIO as given: the kernel reads each tap's [cin, cout] block in the
    # variant's order
    wk = w.float().contiguous()
    bk = b.float().contiguous()
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=out_dtype,
                      device=x.device)
    lib = _lib()
    rc = lib.millieye_stem_nhwc(
        cuda_lib.ptr(xk), cuda_lib.ptr(wk), cuda_lib.ptr(bk),
        cuda_lib.ptr(out), n, h, wd, cin, cout, int(variant != "im2col"),
        _STORE_CODES[out_dtype], cuda_lib.stream_ptr(x.device))
    cuda_lib.check(lib, rc, "fused_stem")
    fused_stem.launches += 1
    return out


# ------------------------------------------------------------ the pairs
_SMEM_LIMIT = 232448          # bytes of shared memory a block may opt into


def _tile_fits(cin, cmid, cout, precision):
    """Whether the stem pair kernel holds its 8x8 output tile in shared
    memory (``pair_smem_bytes`` and ``pair_tc_smem_bytes`` in
    csrc/stem.cu): at "highest" the biases, both float32 weight sets, the
    18x18 intermediate and one 38x38 input halo (the kernel takes a second
    halo buffer where that fits too); at "default" both bf16 weight sets in
    fragment order, two float32 input halos, the bf16 intermediate and the
    store staging."""
    if precision == "highest":
        return _pair_highest_bytes(cin, cmid, cout) <= _SMEM_LIMIT
    ks0, cs = -(-9 * cin // 16), -(-cmid // 16)
    floats = (_round4(cmid) + _round4(cout) + 16 * ks0
              + 2 * _round4(38 * 38 * cin))
    return (256 * (ks0 * (cmid // 8) + 9 * cs * (cout // 8)) + 4 * floats
            + 32 * cs * 18 * 18 + 4 * 8 * 8 * 40) <= _SMEM_LIMIT


def _round4(v):
    return -(-v // 4) * 4


def _pair_highest_bytes(cin, cmid, cout):
    """``pair_smem_bytes(cin, cmid, cout, 1)`` of csrc/stem.cu."""
    return 4 * (_round4(cmid) + _round4(cout) + 9 * cin * cmid
                + 9 * cmid * cout + 18 * 18 * cmid + _round4(38 * 38 * cin))


def pair_route(cin, cmid, cout, precision):
    """Which kernel a pair wrapper (K4, K8, K11, K12) runs for these
    channel counts, on the card and, through its plain version, on the
    CPU alike: "pair" where the stem pair kernel holds its tile in shared
    memory (``_tile_fits``), else "deep", the deep pair, which streams
    weights and takes every channel count, and counts its own
    launches."""
    return "pair" if _tile_fits(cin, cmid, cout, precision) else "deep"


def _check_pair(name, x, w0, b0, w1, b1, precision, out_dtype,
                scratch_dtype=None, h_multiple=4):
    """The pair wrappers' argument checks (the JAX kernels' asserts), made
    for CPU and CUDA tensors alike; returns ``pair_route``'s answer."""
    if precision not in ("default", "highest"):
        raise ValueError(f"{name}: unknown precision {precision!r}")
    if out_dtype not in _STORE_CODES:
        raise TypeError(f"{name}: cannot store {out_dtype}")
    if scratch_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: scratch_dtype {scratch_dtype}")
    if scratch_dtype == torch.bfloat16 and precision != "default":
        raise ValueError(f"{name}: bf16 scratches change the numbers unless "
                         f"precision is 'default'")
    if x.dim() != 4:
        raise ValueError(f"{name}: want an NHWC input, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    cmid, cout = w0.shape[0], w1.shape[0]
    if (w0.shape != (cmid, cin, 3, 3) or w1.shape != (cout, cmid, 3, 3)
            or b0.shape != (cmid,) or b1.shape != (cout,)):
        raise ValueError(f"{name}: weights {tuple(w0.shape)}, "
                         f"{tuple(w1.shape)} for {cin} input channels")
    if h % h_multiple or w % 4 or cmid % 8 or cout % 8 or n == 0:
        raise ValueError(f"{name}: need H % {h_multiple} == 0, W % 4 == 0 "
                         f"and Cmid, Cout % 8 == 0, got {tuple(x.shape)}, "
                         f"{cmid}, {cout}")
    return pair_route(cin, cmid, cout, precision)


def _launch_pair(name, x, w0, b0, w1, b1, precision, out_dtype, deep=False,
                 select=False):
    """One launch of the stem pair kernel, or with ``deep`` of the deep
    pair; returns the output."""
    _check_cuda(name, x, w0, b0, w1, b1)
    n, h, w, cin = x.shape
    cmid, cout = w0.shape[0], w1.shape[0]
    # float32 weights, [I, 3, 3, O] for the deep pair and for the pair at
    # "highest" (a fresh, 16-byte aligned copy: that kernel copies them 16
    # bytes at a time), OIHW for the pair at "default" (no copy: its
    # blocks round them to bf16 in fragment order as they load them; the
    # deep pair's first launch does so into ``scratch``)
    order = (1, 2, 3, 0) if deep or precision == "highest" else (0, 1, 2, 3)
    w0k = w0.float().permute(*order).contiguous()
    w1k = w1.float().permute(*order).contiguous()
    b0k, b1k = b0.float().contiguous(), b1.float().contiguous()
    out = torch.empty((n, h // 4, w // 4, cout), dtype=out_dtype,
                      device=x.device)
    lib = _lib()
    args = [cuda_lib.ptr(t) for t in (x, w0k, b0k, w1k, b1k, out)]
    flags = [int(precision == "highest"), int(select),
             _STORE_CODES[out_dtype], cuda_lib.stream_ptr(x.device)]
    if deep:
        scratch = torch.empty(
            lib.millieye_stem_pair_deep_scratch_bytes(
                n, h, w, cin, cmid, cout, int(precision == "highest")),
            dtype=torch.uint8, device=x.device)
        rc = lib.millieye_stem_pair_deep(*args, cuda_lib.ptr(scratch), n, h,
                                         w, cin, cmid, cout, *flags)
    else:
        rc = lib.millieye_stem_pair(*args, n, h, w, cin, cmid, cout, *flags)
    cuda_lib.check(lib, rc, name)
    return out


def _pair(name, fn, x, w0, b0, w1, b1, precision, out_dtype, route,
          select=False):
    """Run one pair wrapper: the deep pair where ``route`` says so (it
    counts its own launch), else the plain version on a CPU tensor or the
    stem pair kernel, counted on ``fn``."""
    if route == "deep":
        return fused_stem_pair_deep(x, w0, b0, w1, b1, precision, out_dtype,
                                    select)
    if cuda_lib.takes_plain(x, name):
        return fused_stem_pair_plain(x, w0, b0, w1, b1, precision, out_dtype,
                                     select)
    out = _launch_pair(fn.__name__, x, w0, b0, w1, b1, precision, out_dtype,
                       select=select)
    fn.launches += 1
    return out


def fused_stem_pair(x, w0, b0, w1, b1, precision="default",
                    out_dtype=torch.float16, scratch_dtype=None):
    """K4: [N, H, W, Cin] float32 -> [N, H/4, W/4, Cout] (see module)."""
    route = _check_pair("fused_stem_pair", x, w0, b0, w1, b1, precision,
                        out_dtype, scratch_dtype)
    return _pair("stem_pair", fused_stem_pair, x, w0, b0, w1, b1, precision,
                 out_dtype, route)


def fused_stem_pair_select(x, w0, b0, w1, b1, precision="default",
                           out_dtype=torch.float16):
    """K8: the pair with the hi/lo pool select at "default" (see
    module); H % 32 == 0."""
    route = _check_pair("fused_stem_pair_select", x, w0, b0, w1, b1,
                        precision, out_dtype, h_multiple=32)
    return _pair("stem_pair_select", fused_stem_pair_select, x, w0, b0, w1,
                 b1, precision, out_dtype, route, precision == "default")


def fused_stem_pair_packed(x, w0, b0, w1, b1, precision="default",
                           out_dtype=torch.float16, scratch_dtype=None):
    """K11: K4's function (see module); H % 32 == 0."""
    route = _check_pair("fused_stem_pair_packed", x, w0, b0, w1, b1,
                        precision, out_dtype, scratch_dtype, h_multiple=32)
    return _pair("stem_pair_packed", fused_stem_pair_packed, x, w0, b0, w1,
                 b1, precision, out_dtype, route)


def fused_stem_pair_s2d(x, w0, b0, w1, b1, precision="default",
                        out_dtype=torch.float16, scratch_dtype=None,
                        groups0=4):
    """K12: K4's function (see module)."""
    route = _check_pair("fused_stem_pair_s2d", x, w0, b0, w1, b1, precision,
                        out_dtype, scratch_dtype)
    if groups0 not in (2, 4, 8):
        raise ValueError(f"fused_stem_pair_s2d: groups0 {groups0!r} not in "
                         f"(2, 4, 8)")
    return _pair("stem_pair_s2d", fused_stem_pair_s2d, x, w0, b0, w1, b1,
                 precision, out_dtype, route)


def fused_stem_pair_deep(x, w0, b0, w1, b1, precision="default",
                         out_dtype=torch.bfloat16, select=False):
    """K12's deep pair: the pair's function for any channel counts (see
    module), with K8's pool select at "default" when ``select``."""
    _check_pair("fused_stem_pair_deep", x, w0, b0, w1, b1, precision,
                out_dtype)
    select = select and precision == "default"
    if cuda_lib.takes_plain(x, "stem_pair_deep"):
        return fused_stem_pair_deep_plain(x, w0, b0, w1, b1, precision,
                                          out_dtype, select)
    out = _launch_pair("fused_stem_pair_deep", x, w0, b0, w1, b1, precision,
                       out_dtype, deep=True, select=select)
    fused_stem_pair_deep.launches += 1
    return out


fused_stem_stage.launches = 0
fused_stem.launches = 0
fused_stem_pair.launches = 0
fused_stem_pair_select.launches = 0
fused_stem_pair_packed.launches = 0
fused_stem_pair_s2d.launches = 0
fused_stem_pair_deep.launches = 0
