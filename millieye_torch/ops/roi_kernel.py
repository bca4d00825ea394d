"""RoI crops of the fusion network: CUDA kernels K2 and K3 with their
plain versions (port of ``millieye_tpu/ops/roi_pallas.py``).

* K2 ``ps_roi_align_padded`` replaces ``ps_roi_align_pallas_padded_g1``
  (reduce="dot", precision="default"): PS-RoIAlign over a score map
  whose channels were permuted and padded with ``ps_channel_perm_pad``,
  features [B, H, W, ph*128] -> [B, N, ph, pw, c_out] float32.
* K3 ``roi_align`` replaces ``roi_align_pallas`` (pack_p=True,
  precision="default"): RoIAlign over the radar score map, features
  [B, H, W, C] -> [B, N, ph, pw, C] float32.

Source: ``millieye_torch/csrc/roi_align.cu``. The interpolation matrices
come from ``ops/roi_align.py:_batched_prep`` in float32 and are rounded
to bf16 with the features, products accumulate in float32 and each
``t * bx`` product is rounded to bf16 before the float32 sum over w, as
the TPU kernels do at precision="default".

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
raises (outside ``cuda_lib.plain_versions()``). ``<wrapper>.launches``
counts kernel launches.
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
# operation: t sums h = 0..H-1 and the output sums w = 0..W-1, one add
# at a time from 0, so kernel and plain version are bit-equal. (by and
# the features hold bf16 values, so each by*F product is exact in float32
# and the kernels' FMA rounds like the add here.)
def ps_roi_align_padded_plain(features, by, bx, c_out):
    """K2: features [B, H, W, ph*block] bf16, by [B, N, ph, H], bx
    [B, N, pw, W] bf16 -> [B, N, ph, pw, c_out] float32."""
    b, h, w, c_pad = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    ol = c_out * pw
    f = features.float().reshape(b, h, w, ph, c_pad // ph)[..., :ol]
    byf = by.float()
    t = f.new_zeros((b, n, ph, w, ol))
    for y in range(h):
        t = t + byf[:, :, :, y, None, None] * f[:, None, y].transpose(2, 3)
    q_of_j = torch.arange(ol, device=features.device) % pw
    bxj = bx.float().transpose(2, 3)[..., q_of_j]          # [B, N, W, ol]
    out = f.new_zeros((b, n, ph, ol))
    for x in range(w):
        out = out + _bf16_round(t[:, :, :, x] * bxj[:, :, None, x])
    return out.reshape(b, n, ph, c_out, pw).transpose(3, 4)


def roi_align_plain(features, by, bx):
    """K3: features [B, H, W, C] bf16, by [B, N, ph, H], bx [B, N, pw, W]
    bf16 -> [B, N, ph, pw, C] float32."""
    b, h, w, c = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    f, byf, bxf = features.float(), by.float(), bx.float()
    t = f.new_zeros((b, n, ph, w, c))
    for y in range(h):
        t = t + byf[:, :, :, y, None, None] * f[:, None, None, y]
    out = f.new_zeros((b, n, ph, pw, c))
    for x in range(w):
        out = out + _bf16_round(t[:, :, :, None, x]
                                * bxf[:, :, None, :, x, None])
    return out


# ---------------------------------------------------------------- kernels
def _check(name, features, by, bx):
    for t in (features, by, bx):
        if t.device != features.device or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors on {features.device}, "
                             f"{by.device}, {bx.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: want bfloat16 operands, got {t.dtype}")
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
    return lib


def ps_roi_align_padded_kernel(features, by, bx, c_out):
    """K2 on CUDA tensors (the plain version's contract)."""
    if cuda_lib.takes_plain(features):
        return ps_roi_align_padded_plain(features, by, bx, c_out)
    _check("ps_roi_align_padded", features, by, bx)
    b, h, w, c_pad = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    if c_pad % ph or c_out * pw > c_pad // ph:
        raise ValueError(f"ps_roi_align_padded: {c_pad} channels, ph={ph}, "
                         f"c_out*pw={c_out * pw}")
    out = torch.empty((b, n, ph, pw, c_out), dtype=torch.float32,
                      device=features.device)
    lib = _lib()
    rc = lib.millieye_ps_roi_align(
        cuda_lib.ptr(features), cuda_lib.ptr(by), cuda_lib.ptr(bx),
        cuda_lib.ptr(out), b, n, h, w, c_pad, ph, pw, c_out,
        cuda_lib.stream_ptr(features.device))
    cuda_lib.check(lib, rc, "ps_roi_align_padded")
    ps_roi_align_padded_kernel.launches += 1
    return out


def roi_align_kernel(features, by, bx):
    """K3 on CUDA tensors (the plain version's contract)."""
    if cuda_lib.takes_plain(features):
        return roi_align_plain(features, by, bx)
    _check("roi_align", features, by, bx)
    b, h, w, c = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    out = torch.empty((b, n, ph, pw, c), dtype=torch.float32,
                      device=features.device)
    lib = _lib()
    rc = lib.millieye_roi_align(
        cuda_lib.ptr(features), cuda_lib.ptr(by), cuda_lib.ptr(bx),
        cuda_lib.ptr(out), b, n, h, w, c, ph, pw,
        cuda_lib.stream_ptr(features.device))
    cuda_lib.check(lib, rc, "roi_align")
    roi_align_kernel.launches += 1
    return out


ps_roi_align_padded_kernel.launches = 0
roi_align_kernel.launches = 0


# ------------------------------------------------------ public entry points
def ps_roi_align_padded(features, boxes, output_size=(7, 7),
                        spatial_scale=1.0 / 16, sampling_ratio=-1,
                        sampling_max=4, c_out=None):
    """PS-RoIAlign over the perm+padded map: features [B, H, W, ph*128],
    boxes [B, N, 4] xyxy -> [B, N, ph, pw, c_out] float32 (tv0.6: -0.5
    offset, RoI size at least 0.1)."""
    _, h, w, _ = features.shape
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, -0.5,
                           0.1, sampling_ratio, sampling_max)
    return ps_roi_align_padded_kernel(
        features.to(torch.bfloat16).contiguous(),
        by.to(torch.bfloat16).contiguous(),
        bx.to(torch.bfloat16).contiguous(), c_out)


def roi_align(features, boxes, output_size=(7, 7), spatial_scale=1.0 / 16,
              sampling_ratio=-1, sampling_max=4):
    """RoIAlign: features [B, H, W, C], boxes [B, N, 4] xyxy -> [B, N, ph,
    pw, C] float32 (tv0.6 aligned=False, RoI size at least 1.0)."""
    _, h, w, _ = features.shape
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, 0.0,
                           1.0, sampling_ratio, sampling_max)
    return roi_align_kernel(features.to(torch.bfloat16).contiguous(),
                            by.to(torch.bfloat16).contiguous(),
                            bx.to(torch.bfloat16).contiguous())
