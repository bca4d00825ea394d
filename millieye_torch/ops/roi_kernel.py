"""RoI crops of the fusion networks: CUDA kernels K2, K3, K6 and K7 with
their plain versions (port of ``millieye_tpu/ops/roi_pallas.py``).

* K2 ``ps_roi_align_padded`` replaces ``ps_roi_align_pallas_padded_g1``
  (precision="default"): PS-RoIAlign over a score map whose channels
  were permuted and padded with ``ps_channel_perm_pad``, features
  [B, H, W, ph*128] -> [B, N, ph, pw, c_out] float32. Its ``reduce``
  option picks how the TPU runs the segmented w-sum: "dot" (an S-matrix
  matmul) or "vpu" (a vector-unit sum). Both sum the same bf16-rounded
  products, in orders of their own; the card has one order for both, so
  ``reduce="vpu"`` launches the same kernel through
  ``ps_roi_align_padded_vpu_kernel``, which counts its launches apart.
* K3 ``roi_align`` replaces ``roi_align_pallas`` (pack_p=True,
  precision="default"): RoIAlign over the radar score map, features
  [B, H, W, C] -> [B, N, ph, pw, C] float32. Off "default" it takes
  float32 operands (the ladder below), as the TPU kernel did.
* K6 ``ps_roi_align`` replaces ``ps_roi_align_pallas`` (``_launch``):
  PS-RoIAlign over the unpadded float32 map in torch's bin-major channel
  order ("upq") or permuted with ``ps_channel_perm`` ("puq"), features
  [B, H, W, c_out*ph*pw] -> [B, N, ph, pw, c_out] float32;
  ``roi_align(pack_p=False)`` goes through the same kernel.
* K7 ``ps_roi_align_padded`` at precision "split"/"highest" replaces
  ``ps_roi_align_pallas_padded``: K2's function on float32 operands.

The precision ladder of K6, K7 and K3's float32 mode is the TPU's
meaning of ``roi_pallas._dot``, spelled out in ``_crop_plain``:
"default" rounds both operands of each stage-1 product to bf16,
accumulates in float32 and rounds ``t * bx`` to bf16 before the w-sum;
"split" is the three-product hi/lo expansion of stage 1 and the
two-term one of stage 2 (lo parts rounded to bf16); "highest" is
float32 throughout.

Source: ``millieye_torch/csrc/roi_align.cu``. The interpolation matrices
come from ``ops/roi_align.py:_batched_prep`` in float32; K2 and K3's
bf16 mode round them to bf16 with the features, accumulate the products
in float32 and round each ``t * bx`` product to bf16 before the float32
sum over w, as the TPU kernels do at precision="default".

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
raises (outside ``cuda_lib.plain_versions()``). Each wrapper calls its
custom op (``cuda_lib.kernel_op``); ``<wrapper>.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from millieye_torch.ops import cuda_lib
from millieye_torch.ops.roi_align import _batched_prep


def ps_channel_perm_pad(c_out, ph, pw, block=128):
    """Destination slots of the padded score-map layout: source channel
    (u*ph + p)*pw + q (torch's bin-major order) lands at
    p*block + u*pw + q of a ``ph*block``-wide map."""
    if c_out * pw > block:
        raise ValueError(f"c_out*pw = {c_out * pw} > block {block}")
    dst = np.empty(c_out * ph * pw, np.int64)
    for u in range(c_out):
        for p in range(ph):
            for q in range(pw):
                dst[(u * ph + p) * pw + q] = p * block + u * pw + q
    return dst


def _bf16_round(x):
    return x.to(torch.bfloat16).float()


# ------------------------------------------------------------------ plain
# The plain versions repeat the kernels' arithmetic operation for
# operation: t sums h and the output sums w in ascending order, only over
# the nonzero spans, one add at a time from 0, so kernel and plain
# version are bit-equal. (by and
# the features hold bf16 values, so each by*F product is exact in float32
# and the kernels' FMA rounds like the add here.)
def _span_mask(nonzero):
    """True from the first to the last True along the last axis: the
    span the crop kernels sum over (all False where there is no True)."""
    idx = torch.arange(nonzero.shape[-1], device=nonzero.device)
    lo = torch.where(nonzero, idx, nonzero.shape[-1]).amin(-1, keepdim=True)
    hi = torch.where(nonzero, idx, -1).amax(-1, keepdim=True)
    return (idx >= lo) & (idx <= hi)


def ps_roi_align_padded_plain(features, by, bx, c_out):
    """K2: features [B, H, W, ph*block] bf16, by [B, N, ph, H], bx
    [B, N, pw, W] bf16 -> [B, N, ph, pw, c_out] float32. As the kernel,
    t of bin row p sums only the span of nonzero by[p, :] and the output
    only the span of columns where some bx[q, :] is nonzero; the terms
    left out are exact zeros, so on a finite map this equals the sum over
    every row and column bit for bit."""
    b, h, w, c_pad = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    ol = c_out * pw
    f = features.float().reshape(b, h, w, ph, c_pad // ph)[..., :ol]
    byf, bxf = by.float(), bx.float()
    rows = _span_mask(byf != 0)                            # [B, N, ph, H]
    cols = _span_mask((bxf != 0).any(2))                   # [B, N, W]
    t = f.new_zeros((b, n, ph, w, ol))
    for y in range(h):
        t = torch.where(rows[:, :, :, y, None, None],
                        t + byf[:, :, :, y, None, None]
                        * f[:, None, y].transpose(2, 3), t)
    q_of_j = torch.arange(ol, device=features.device) % pw
    bxj = bxf.transpose(2, 3)[..., q_of_j]                 # [B, N, W, ol]
    out = f.new_zeros((b, n, ph, ol))
    for x in range(w):
        out = torch.where(cols[:, :, x, None, None],
                          out + _bf16_round(t[:, :, :, x]
                                            * bxj[:, :, None, x]), out)
    return out.reshape(b, n, ph, c_out, pw).transpose(3, 4)


def roi_align_plain(features, by, bx):
    """K3: features [B, H, W, C] bf16, by [B, N, ph, H], bx [B, N, pw, W]
    bf16 -> [B, N, ph, pw, C] float32. As the kernel, t of bin row p
    sums only the span of nonzero by[p, :], and output column q only the
    span of nonzero bx[q, :]; the terms left out are exact zeros, so on a
    finite map this equals the sum over every row and column bit for
    bit."""
    b, h, w, c = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    f, byf, bxf = features.float(), by.float(), bx.float()
    rows = _span_mask(byf != 0)                            # [B, N, ph, H]
    cols = _span_mask(bxf != 0)                            # [B, N, pw, W]
    t = f.new_zeros((b, n, ph, w, c))
    for y in range(h):
        t = torch.where(rows[:, :, :, y, None, None],
                        t + byf[:, :, :, y, None, None] * f[:, None, None, y],
                        t)
    out = f.new_zeros((b, n, ph, pw, c))
    for x in range(w):
        out = torch.where(cols[:, :, None, :, x, None],
                          out + _bf16_round(t[:, :, :, None, x]
                                            * bxf[:, :, None, :, x, None]),
                          out)
    return out


PRECISIONS = {"default": 0, "split": 1, "highest": 2}


def _crop_plain(f, by, t_of, bxe, precision):
    """The float32-operand kernels' arithmetic, operation for operation.
    f [B, H, P or 1, W, L] float32 (the map's lanes for each bin row), by
    [B, N, P, H]; ``t_of`` reshapes t [B, N, P, W, L] so that it
    broadcasts against bxe [B, N, ..., W, L'] with W second to last. As
    K6 and K7, t of bin row p sums only the span of nonzero by[p, :] and
    the output only the span of columns where some bx[q, :] is nonzero
    (``_span_mask``, on the values as given), in ascending order, one add
    at a time from 0; the terms left out are exact zeros, so on a finite
    map this equals the sum over every row and column bit for bit. At
    "highest" every product is rounded before its add, elsewhere the
    products of two bf16 values are exact."""
    hi = _bf16_round
    h, w = f.shape[1], f.shape[3]
    rows = _span_mask(by != 0)                             # [B, N, P, H]
    cols = _span_mask((bxe != 0).transpose(-1, -2).flatten(2, -2).any(2))

    def sum_h(a, m):
        t = 0.0
        for y in range(h):
            t = torch.where(rows[:, :, :, y, None, None],
                            t + a[:, :, :, y, None, None] * m[:, None, y], t)
        return t

    if precision == "highest":
        t = sum_h(by, f)
    elif precision == "default":
        t = sum_h(hi(by), hi(f))
    else:
        ah, bh = hi(by), hi(f)
        al, bl = hi(by - ah), hi(f - bh)
        t = (sum_h(ah, bh) + sum_h(al, bh)) + sum_h(ah, bl)
    t = t_of(t)
    o1, o2 = 0.0, 0.0
    for x in range(w):
        prod = t[..., x, :] * bxe[..., x, :]
        col = cols[:, :, x].reshape(cols.shape[:2] + (1,) * (prod.dim() - 2))
        if precision == "highest":
            o1 = torch.where(col, o1 + prod, o1)
        else:
            o1 = torch.where(col, o1 + hi(prod), o1)
            if precision == "split":
                o2 = torch.where(col, o2 + hi(prod - hi(prod)), o2)
    return o1 + o2 if precision == "split" else o1


def _ps_lanes(features, ph, pw, c_out, layout):
    """[B, H, W, C] -> [B, H, ph, W, c_out*pw]: for each bin row p the
    lanes (u, q) of the map, by channel layout."""
    b, h, w, c = features.shape
    ol = c_out * pw
    if layout == "upq":
        f = features.reshape(b, h, w, c_out, ph, pw).permute(0, 1, 4, 2, 3, 5)
    elif layout == "puq":
        f = features.reshape(b, h, w, ph, c_out, pw).permute(0, 1, 3, 2, 4, 5)
    else:                                   # "padded": p*block + u*pw + q
        f = features.reshape(b, h, w, ph, c // ph)[..., :ol].permute(
            0, 1, 3, 2, 4)
    return f.reshape(b, h, ph, w, ol)


def ps_roi_align_f32_plain(features, by, bx, c_out, precision="default",
                           layout="upq"):
    """K6 ("upq"/"puq") and K7 ("padded"): float32 features, by
    [B, N, ph, H], bx [B, N, pw, W] -> [B, N, ph, pw, c_out] float32."""
    b, n, ph, pw = by.shape[0], by.shape[1], by.shape[2], bx.shape[2]
    q_of_j = torch.arange(c_out * pw, device=features.device) % pw
    bxe = bx.transpose(2, 3)[..., q_of_j][:, :, None]      # [B, N, 1, W, ol]
    out = _crop_plain(_ps_lanes(features, ph, pw, c_out, layout), by,
                      lambda t: t, bxe, precision)
    return out.reshape(b, n, ph, c_out, pw).transpose(3, 4)


def roi_align_f32_plain(features, by, bx, precision="highest"):
    """K3 on float32 operands, and ``roi_align(pack_p=False)`` through
    K6: features [B, H, W, C] -> [B, N, ph, pw, C] float32. K3's kernel
    sums output column q over the span of nonzero bx[q, :] alone, inside
    the union span this takes; the terms between are exact zeros, so it
    equals this bit for bit on a finite map."""
    return _crop_plain(features[:, :, None], by, lambda t: t[:, :, :, None],
                       bx[:, :, None, :, :, None], precision)


# ---------------------------------------------------------------- kernels
def _check(name, features, by, bx, dtype=torch.bfloat16):
    for t in (features, by, bx):
        if t.device != features.device or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors on {features.device}, "
                             f"{by.device}, {bx.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: want {dtype} operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    b, h, w, _ = features.shape
    if (by.dim() != 4 or bx.dim() != 4 or by.shape[0] != b
            or bx.shape[:2] != by.shape[:2] or by.shape[3] != h
            or bx.shape[3] != w or b == 0 or by.shape[1] == 0):
        raise ValueError(f"{name}: shapes {tuple(features.shape)}, "
                         f"{tuple(by.shape)}, {tuple(bx.shape)}")


def _lib():
    lib = cuda_lib.library("roi_align")
    lib.millieye_ps_roi_align.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 8
                                          + [ctypes.c_void_p])
    lib.millieye_ps_roi_align.restype = ctypes.c_int
    lib.millieye_roi_align.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.millieye_roi_align.restype = ctypes.c_int
    lib.millieye_roi_align_group.argtypes = [ctypes.c_int] * 2
    lib.millieye_roi_align_group.restype = ctypes.c_int
    for fn, n_int in ((lib.millieye_ps_roi_align_f32, 12),
                      (lib.millieye_ps_roi_align_padded_f32, 9),
                      (lib.millieye_roi_align_f32, 8)):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch_k2(features, by, bx, c_out):
    _check("ps_roi_align_padded", features, by, bx)
    b, h, w, c_pad = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    block = c_pad // ph if ph else 0
    if (c_pad % ph or block % 8 or -(-c_out * pw // 8) * 8 > block
            or features.data_ptr() % 16):
        raise ValueError(f"ps_roi_align_padded: {c_pad} channels, ph={ph}, "
                         f"c_out*pw={c_out * pw}: the kernel reads 16-byte "
                         f"groups of 8 lanes from a 16-byte aligned map")
    out = torch.empty((b, n, ph, pw, c_out), dtype=torch.float32,
                      device=features.device)
    lib = _lib()
    rc = lib.millieye_ps_roi_align(
        cuda_lib.ptr(features), cuda_lib.ptr(by), cuda_lib.ptr(bx),
        cuda_lib.ptr(out), b, n, h, w, c_pad, ph, pw, c_out,
        cuda_lib.stream_ptr(features.device))
    cuda_lib.check(lib, rc, "ps_roi_align_padded")
    return out


def ps_roi_align_padded_kernel(features, by, bx, c_out):
    """K2 (the plain version's contract); the op
    ``millieye::ps_roi_align``."""
    return _k2_op(features, by, bx, int(c_out))


def ps_roi_align_padded_vpu_kernel(features, by, bx, c_out):
    """K2 for ``reduce="vpu"`` (see module): the same function and
    kernel, its launches counted here; the op
    ``millieye::ps_roi_align_vpu``."""
    return _k2_vpu_op(features, by, bx, int(c_out))


def roi_align_kernel(features, by, bx, precision="default"):
    """K3 (the plain versions' contracts): bf16 operands at "default",
    float32 operands at "split"/"highest"; the op
    ``millieye::roi_align``."""
    if precision not in PRECISIONS:
        raise ValueError(f"roi_align: unknown precision {precision!r}")
    return _k3_op(features, by, bx, precision)


def _roi_align_plain(features, by, bx, precision):
    if precision != "default":
        return roi_align_f32_plain(features, by, bx, precision)
    return roi_align_plain(features, by, bx)


def _launch_k3(features, by, bx, precision):
    f32 = precision != "default"
    _check("roi_align", features, by, bx,
           torch.float32 if f32 else torch.bfloat16)
    b, h, w, c = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    out = torch.empty((b, n, ph, pw, c), dtype=torch.float32,
                      device=features.device)
    lib = _lib()
    args = (cuda_lib.ptr(features), cuda_lib.ptr(by), cuda_lib.ptr(bx),
            cuda_lib.ptr(out), b, n, h, w, c, ph, pw)
    if f32:
        rc = lib.millieye_roi_align_f32(
            *args, PRECISIONS[precision], cuda_lib.stream_ptr(features.device))
    else:
        rc = lib.millieye_roi_align(*args,
                                    cuda_lib.stream_ptr(features.device))
    cuda_lib.check(lib, rc, "roi_align")
    return out


def roi_align_group(batch, n_roi):
    """The RoIs one block of K3's kernel takes at this batch and RoI
    count on the current card (its grid is ``batch * ceil(n_roi /
    group)`` blocks)."""
    group = _lib().millieye_roi_align_group(batch, n_roi)
    if group <= 0:
        raise RuntimeError("roi_align_group: no CUDA device")
    return group


_STRIDES = {  # channel of (p, u, q) = p*sp + u*su + q*sq, by layout
    "upq": lambda ph, pw, c_out: (pw, ph * pw, 1),
    "puq": lambda ph, pw, c_out: (c_out * pw, pw, 1),
    "c": lambda ph, pw, c_out: (0, 1, 0),
}


def ps_roi_align_f32_kernel(features, by, bx, c_out, precision="default",
                            layout="upq"):
    """K6: float32 operands; ``layout`` "upq", "puq", or "c" (a map
    without bin channels: RoIAlign, [B, N, ph, pw, C]); the op
    ``millieye::ps_roi_align_f32``."""
    if precision not in PRECISIONS or layout not in _STRIDES:
        raise ValueError(f"ps_roi_align: precision {precision!r}, layout "
                         f"{layout!r}")
    return _k6_op(features, by, bx, int(c_out), precision, layout)


def _ps_roi_align_f32_plain(features, by, bx, c_out, precision, layout):
    if layout == "c":
        return roi_align_f32_plain(features, by, bx, precision)
    return ps_roi_align_f32_plain(features, by, bx, c_out, precision, layout)


def _launch_k6(features, by, bx, c_out, precision, layout):
    _check("ps_roi_align", features, by, bx, torch.float32)
    b, h, w, c = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    if c != (c_out if layout == "c" else c_out * ph * pw):
        raise ValueError(f"ps_roi_align: {c} channels for c_out={c_out}, "
                         f"bins {ph}x{pw}, layout {layout!r}")
    out = torch.empty((b, n, ph, pw, c_out), dtype=torch.float32,
                      device=features.device)
    lib = _lib()
    rc = lib.millieye_ps_roi_align_f32(
        cuda_lib.ptr(features), cuda_lib.ptr(by), cuda_lib.ptr(bx),
        cuda_lib.ptr(out), b, n, h, w, c, ph, pw, c_out,
        *_STRIDES[layout](ph, pw, c_out), PRECISIONS[precision],
        cuda_lib.stream_ptr(features.device))
    cuda_lib.check(lib, rc, "ps_roi_align")
    return out


def ps_roi_align_padded_f32_kernel(features, by, bx, c_out,
                                   precision="highest"):
    """K7: K2's padded map with float32 operands; the op
    ``millieye::ps_roi_align_padded_f32``."""
    if precision not in PRECISIONS:
        raise ValueError(f"ps_roi_align_padded: unknown precision "
                         f"{precision!r}")
    return _k7_op(features, by, bx, int(c_out), precision)


def _launch_k7(features, by, bx, c_out, precision):
    _check("ps_roi_align_padded", features, by, bx, torch.float32)
    b, h, w, c_pad = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    if c_pad % ph or c_out * pw > c_pad // ph:
        raise ValueError(f"ps_roi_align_padded: {c_pad} channels, ph={ph}, "
                         f"c_out*pw={c_out * pw}")
    out = torch.empty((b, n, ph, pw, c_out), dtype=torch.float32,
                      device=features.device)
    lib = _lib()
    rc = lib.millieye_ps_roi_align_padded_f32(
        cuda_lib.ptr(features), cuda_lib.ptr(by), cuda_lib.ptr(bx),
        cuda_lib.ptr(out), b, n, h, w, c_pad, ph, pw, c_out,
        PRECISIONS[precision], cuda_lib.stream_ptr(features.device))
    cuda_lib.check(lib, rc, "ps_roi_align_padded")
    return out


def _fake_crop(features, by, bx, c_out, *_):
    """[B, N, ph, pw, c_out] float32 from the operands' shapes."""
    return features.new_empty(tuple(by.shape[:3]) + (bx.shape[2], c_out),
                              dtype=torch.float32)


def _fake_roi(features, by, bx, precision):
    return _fake_crop(features, by, bx, features.shape[3])


ps_roi_align_padded_kernel.launches = 0
ps_roi_align_padded_vpu_kernel.launches = 0
roi_align_kernel.launches = 0
ps_roi_align_f32_kernel.launches = 0
ps_roi_align_padded_f32_kernel.launches = 0
_K2_SCHEMA = "(Tensor features, Tensor by, Tensor bx, int c_out) -> Tensor"
_k2_op = cuda_lib.kernel_op("ps_roi_align", _K2_SCHEMA,
                            ps_roi_align_padded_plain, _launch_k2, _fake_crop,
                            ps_roi_align_padded_kernel)
_k2_vpu_op = cuda_lib.kernel_op("ps_roi_align_vpu", _K2_SCHEMA,
                                ps_roi_align_padded_plain, _launch_k2,
                                _fake_crop, ps_roi_align_padded_vpu_kernel)
_k3_op = cuda_lib.kernel_op(
    "roi_align", "(Tensor features, Tensor by, Tensor bx, str precision) -> "
    "Tensor", _roi_align_plain, _launch_k3, _fake_roi, roi_align_kernel)
_k6_op = cuda_lib.kernel_op(
    "ps_roi_align_f32", "(Tensor features, Tensor by, Tensor bx, int c_out, "
    "str precision, str layout) -> Tensor", _ps_roi_align_f32_plain,
    _launch_k6, _fake_crop, ps_roi_align_f32_kernel)
_k7_op = cuda_lib.kernel_op(
    "ps_roi_align_padded_f32", "(Tensor features, Tensor by, Tensor bx, "
    "int c_out, str precision) -> Tensor",
    lambda f, by, bx, c_out, precision: ps_roi_align_f32_plain(
        f, by, bx, c_out, precision, "padded"),
    _launch_k7, _fake_crop, ps_roi_align_padded_f32_kernel)


# ------------------------------------------------------ public entry points
def ps_channel_perm(c_out, ph, pw):
    """Torch's bin-major channel order (u*ph + p)*pw + q -> the p-major
    order p*(c_out*pw) + u*pw + q that ``channel_order="puq"`` reads:
    ``perm[dst] = src``, to apply to the output channels of the conv
    that produces the score map."""
    perm = np.empty(c_out * ph * pw, np.int64)
    for p in range(ph):
        for u in range(c_out):
            for q in range(pw):
                perm[(p * c_out + u) * pw + q] = (u * ph + p) * pw + q
    return perm


def _f32(*tensors):
    return [t.float().contiguous() for t in tensors]


def ps_roi_align(features, boxes, output_size=(7, 7), spatial_scale=1.0 / 16,
                 sampling_ratio=-1, sampling_max=4, precision="default",
                 channel_order="upq"):
    """PS-RoIAlign over the unpadded map (kernel K6): features [B, H, W,
    c_out*ph*pw] in torch's bin-major order ("upq") or permuted with
    ``ps_channel_perm`` ("puq"), boxes [B, N, 4] xyxy -> [B, N, ph, pw,
    c_out] float32 (tv0.6: -0.5 offset, RoI size at least 0.1)."""
    if channel_order not in ("upq", "puq"):
        raise ValueError(f"unknown channel_order {channel_order!r}")
    _, h, w, c_in = features.shape
    ph, pw = output_size
    c_out = c_in // (ph * pw)
    if c_out * ph * pw != c_in:
        raise ValueError(f"{c_in} channels do not factor as C_out*{ph}*{pw}")
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, -0.5,
                           0.1, sampling_ratio, sampling_max)
    return ps_roi_align_f32_kernel(*_f32(features, by, bx), c_out, precision,
                                   channel_order)


REDUCES = ("dot", "vpu")


def ps_roi_align_padded(features, boxes, output_size=(7, 7),
                        spatial_scale=1.0 / 16, sampling_ratio=-1,
                        sampling_max=4, c_out=None, precision="default",
                        reduce="dot"):
    """PS-RoIAlign over the perm+padded map: features [B, H, W, ph*128],
    boxes [B, N, 4] xyxy -> [B, N, ph, pw, c_out] float32 (tv0.6: -0.5
    offset, RoI size at least 0.1). "default" runs kernel K2 on bf16
    operands, through the wrapper ``reduce`` names; "split" and "highest"
    run kernel K7 on float32 operands (the TPU has no ``reduce`` there)."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}")
    _, h, w, _ = features.shape
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, -0.5,
                           0.1, sampling_ratio, sampling_max)
    if precision != "default":
        return ps_roi_align_padded_f32_kernel(*_f32(features, by, bx), c_out,
                                              precision)
    k2 = (ps_roi_align_padded_vpu_kernel if reduce == "vpu"
          else ps_roi_align_padded_kernel)
    return k2(
        features.to(torch.bfloat16).contiguous(),
        by.to(torch.bfloat16).contiguous(),
        bx.to(torch.bfloat16).contiguous(), c_out)


def roi_align(features, boxes, output_size=(7, 7), spatial_scale=1.0 / 16,
              sampling_ratio=-1, sampling_max=4, precision="default",
              pack_p=True):
    """RoIAlign: features [B, H, W, C], boxes [B, N, 4] xyxy -> [B, N, ph,
    pw, C] float32 (tv0.6 aligned=False, RoI size at least 1.0). Operands
    are bf16 at "default" and float32 elsewhere. ``pack_p`` (all bin rows
    in one pass) is kernel K3; ``pack_p=False`` (a pass per bin row) goes
    through kernel K6. Both compute the same function."""
    _, h, w, c = features.shape
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, 0.0,
                           1.0, sampling_ratio, sampling_max)
    ops = (features, by, bx)
    if precision == "default":
        ops = [t.to(torch.bfloat16).contiguous() for t in ops]
    if pack_p:
        if precision != "default":
            ops = _f32(*ops)
        return roi_align_kernel(*ops, precision)
    return ps_roi_align_f32_kernel(*_f32(*ops), c, precision, "c")
