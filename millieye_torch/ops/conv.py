"""The float32 convolution of a channels_last input: kernel K15 and its
plain version.

``conv2d_nhwc(x, w, stride, pad)`` is ``F.conv2d(x, w, stride=stride,
padding=pad)`` for an NCHW-indexed float32 ``x`` (made channels_last,
NHWC, where it is not) and OIHW float32 weights ``w``: kernel 1x1 or
3x3, padding (k - 1) // 2, stride 1 or 2, groups 1, dilation 1; Cin a
multiple of 4, or kh * kw * Cin <= 32 (the 3-channel first
convolution). The output is float32 and channels_last. ``pack_weight``
repacks ``w`` to [kh, kw, Cin, Cout] once per weight tensor, Cout padded
with zeros to a multiple of 4 (kept while the tensor lives, and made
again after an in-place change to it); the op ``millieye::conv2d_nhwc``
takes the packed weights and Cout.

K15 (``millieye_torch/csrc/conv.cu``) is an implicit GEMM on the CUDA
cores, exact float32 (FFMA, no TF32): each output sums its products over
K = (r, s, c) in that order, in one float32 accumulator (two halves
added from K = 256 on) or, where the kernel splits K across blocks
(small maps), in a few consecutive ranges added in a fixed order, so
that two runs give the same bits. The plain
version repeats that arithmetic as PyTorch can: the input unfolded in
(r, s, c) order, then one float32 product with the packed weights. It
replaces no TPU kernel (XLA ran these convolutions); its bound is the
operations at the 67 TFLOP/s float32 peak. The tile and the split are
chosen from the shapes alone (``plan``); ``tile()`` forces one, for
tests and timing.

On a CPU tensor the op runs the plain version; on a CUDA tensor the
kernel, or it raises where the kernel cannot take the tensors
(``conv_form``), outside ``cuda_lib.plain_versions()``. ``takes_form``
states the kernel's form from the shapes alone, as a model's config
settles them. ``conv2d_nhwc.launches`` counts kernel launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from millieye_torch.device import per_tensor
from millieye_torch.ops import cuda_lib

KERNEL_SIZES = (1, 3)
STRIDES = (1, 2)
# the largest K the small-K route (Cin % 4 != 0) takes in one tile
SMALL_K = 32
# the kernel's tiles, as millieye_conv2d_plan numbers them
TILES = ("main", "narrow", "small")

_forced = None


def takes_form(cin, kh, kw, stride, pad):
    """Whether the kernel takes a convolution of ``cin`` input channels
    with a kh x kw kernel at ``stride`` and ``pad``: a square kernel of
    ``KERNEL_SIZES``, a stride of ``STRIDES``, padding (k - 1) // 2, and
    Cin a multiple of 4 or kh * kw * Cin <= ``SMALL_K``."""
    return (kh == kw and kh in KERNEL_SIZES and stride in STRIDES
            and pad == (kh - 1) // 2
            and (cin % 4 == 0 or kh * kw * cin <= SMALL_K))


def conv_form(x, w, stride, pad):
    """Raise ValueError unless the kernel takes input ``x`` (NCHW-indexed,
    in either layout) and OIHW weights ``w`` at ``stride`` and ``pad``:
    4-D float32 tensors, groups 1, and ``takes_form``."""
    if x.dim() != 4 or x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"conv2d_nhwc: want 4-D float32 tensors, got "
                         f"{x.dtype} {tuple(x.shape)}, weights {w.dtype}")
    if w.dim() != 4 or w.shape[1] != x.shape[1]:
        raise ValueError(f"conv2d_nhwc: weights {tuple(w.shape)} for "
                         f"{x.shape[1]} input channels (groups 1 only)")
    if not takes_form(x.shape[1], w.shape[2], w.shape[3], stride, pad):
        raise ValueError(f"conv2d_nhwc: {x.shape[1]} input channels, kernel "
                         f"{tuple(w.shape[2:])}, stride {stride}, padding "
                         f"{pad}; want a square kernel of {KERNEL_SIZES}, a "
                         f"stride of {STRIDES}, padding (k - 1) // 2, and Cin "
                         f"a multiple of 4 or kh * kw * Cin <= {SMALL_K}")


def pack_weight(w):
    """OIHW ``w`` as the kernel reads it: [kh, kw, Cin, Cout + -Cout % 4],
    dense, the channels past Cout zero, so that the kernel reads four
    channels at a time (and a traced program keeps one dense constant).
    Made once per weight tensor (``device.per_tensor``)."""
    return per_tensor(w, _pack)


def _pack(w):
    cout, cin, kh, kw = w.shape
    rows = w.new_zeros((kh, kw, cin, cout + -cout % 4))
    rows[..., :cout] = w.detach().permute(2, 3, 1, 0)
    return rows


def conv2d_nhwc(x, w, stride=1, pad=0):
    """K15: ``F.conv2d(x, w, stride=stride, padding=pad)`` of a float32
    ``x`` and OIHW float32 ``w`` through the op (the plain version on the
    CPU), ``x`` made channels_last where it is not; the output is
    channels_last float32."""
    conv_form(x, w, stride, pad)
    return _op(x.contiguous(memory_format=torch.channels_last),
               pack_weight(w), w.shape[0], stride, pad)


@contextlib.contextmanager
def tile(name, splits=1):
    """Inside this block every launch takes the tile ``name`` (of
    ``TILES``) and splits K in ``splits`` (fewer where K has fewer
    tiles), not the plan's: for tests and timing."""
    global _forced
    if name not in TILES:
        raise ValueError(f"unknown tile {name!r} (have {TILES})")
    prev, _forced = _forced, (TILES.index(name), splits)
    try:
        yield
    finally:
        _forced = prev


def out_size(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def _plain(x, wp, cout, stride, pad):
    kh, kw, cin, _ = wp.shape
    n, _, h, w = x.shape
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pad, pad, pad, pad))
    cols = [xp[:, r:r + stride * (ho - 1) + 1:stride,
               s:s + stride * (wo - 1) + 1:stride]
            for r in range(kh) for s in range(kw)]
    a = torch.stack(cols, 3).reshape(n * ho * wo, kh * kw * cin)
    y = a.float() @ wp[..., :cout].reshape(kh * kw * cin, cout).float()
    return y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


@functools.cache
def _lib():
    lib = cuda_lib.library("conv")
    lib.millieye_conv2d_plan.argtypes = [ctypes.c_int] * 11 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.millieye_conv2d_plan.restype = ctypes.c_int
    lib.millieye_conv2d_nhwc.argtypes = [ctypes.c_void_p] * 6
    lib.millieye_conv2d_nhwc.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=4096)
def plan(dims, ld, forced=None):
    """(tile index, splits, the launch's int array, the output's NHWC
    shape) the kernel takes for ``dims`` = (batch, H, W, Cin, Cout, kh,
    kw, stride, pad) with weight rows of ``ld`` floats on the current
    device, or ``forced`` (tile index, splits), the splits clipped to K's
    tiles."""
    lib = _lib()
    cfg, splits = ctypes.c_int(), ctypes.c_int()
    f_cfg, f_splits = forced if forced is not None else (-1, 1)
    rc = lib.millieye_conv2d_plan(*dims, f_cfg, f_splits, ctypes.byref(cfg),
                                  ctypes.byref(splits))
    cuda_lib.check(lib, rc, f"conv2d_nhwc plan {dims} {forced}")
    n, h, w, cin, cout, kh, kw, stride, pad = dims
    args = (ctypes.c_int * 12)(n, h, w, cin, cout, ld, kh, kw, stride, pad,
                               cfg.value, splits.value)
    return (cfg.value, splits.value, args,
            (n, out_size(h, kh, stride, pad), out_size(w, kw, stride, pad),
             cout))


def _launch(x, wp, cout, stride, pad):
    # the weights' layout is the op's contract; the input's is read here,
    # at each call. The checks and the plan are what this op's host time
    # a call is made of, beside the launch: kept to what the kernel needs
    if (x.dim() != 4 or wp.dim() != 4 or x.dtype != torch.float32
            or wp.dtype != torch.float32 or x.shape[1] != wp.shape[2]
            or wp.shape[3] != cout + -cout % 4 or not wp.is_contiguous()
            or not x.is_contiguous(memory_format=torch.channels_last)
            or x.get_device() != wp.get_device()):
        raise ValueError(f"conv2d_nhwc: want a channels_last float32 x and "
                         f"float32 weights as pack_weight lays them out for "
                         f"{cout} channels, on one device, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}, "
                         f"{wp.dtype} {tuple(wp.shape)} strides "
                         f"{wp.stride()}")
    n, cin, h, w = x.shape
    kh, kw, _, ld = wp.shape
    _, splits, args, nhwc = plan((n, h, w, cin, cout, kh, kw, stride, pad),
                                 ld, _forced)
    y = torch.empty(nhwc, device=x.device)
    ws = (torch.empty(splits * y.numel(), device=x.device)
          if splits > 1 else None)
    lib = _lib()
    rc = lib.millieye_conv2d_nhwc(
        x.data_ptr(), wp.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), args,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    cuda_lib.check(lib, rc, "conv2d_nhwc")
    return y.permute(0, 3, 1, 2)


def _fake(x, wp, cout, stride, pad):
    kh, kw = wp.shape[:2]
    return x.new_empty((x.shape[0], cout, out_size(x.shape[2], kh, stride,
                                                   pad),
                        out_size(x.shape[3], kw, stride, pad))).to(
        memory_format=torch.channels_last)


conv2d_nhwc.launches = 0
_op = cuda_lib.kernel_op(
    "conv2d_nhwc",
    "(Tensor x, Tensor w, int cout, int stride, int pad) -> Tensor",
    _plain, _launch, _fake, conv2d_nhwc, contiguous=False)
