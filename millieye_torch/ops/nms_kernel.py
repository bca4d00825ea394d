"""Greedy NMS keep mask: the CUDA kernel K1 and its plain version.

Port of ``millieye_tpu/ops/nms_pallas.py:nms_keep_mask_pallas_blocked``.
Source: ``millieye_torch/csrc/nms.cu``. Contract: boxes [B, K, 4] float32
sorted by descending score (class-offset for class-aware NMS), valid
[B, K] bool -> keep [B, K] bool, bit-equal to the sequential greedy
reference ``ops/nms.py:nms_keep_mask_ref``. K % 128 == 0 and K <= 1024,
as the blocked TPU kernel required.

A CPU tensor takes ``nms_keep_mask_blocked_plain``; a CUDA tensor takes
the kernel or raises (outside ``cuda_lib.plain_versions()``).
``nms_keep_mask_blocked.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from millieye_torch.ops import cuda_lib
from millieye_torch.ops.boxes import iou_matrix

MAX_K = 1024


def nms_keep_mask_blocked_plain(boxes, valid, iou_thresh):
    """The kernel's arithmetic in PyTorch: the [B, K, K] float32 IoU,
    elementwise, then the greedy pass in rank order."""
    k = boxes.shape[1]
    iou = iou_matrix(boxes, boxes, plus_one=False)
    idx = torch.arange(k, device=boxes.device)
    keep = valid.clone()
    for i in range(k):
        keep &= ~((iou[:, i] > iou_thresh) & (idx > i) & keep[:, i:i + 1])
    return keep


def _lib():
    lib = cuda_lib.library("nms")
    fn = lib.millieye_nms_keep_mask
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def nms_keep_mask_blocked(boxes, valid, iou_thresh):
    """keep [B, K] bool for score-sorted boxes [B, K, 4] (see module)."""
    if cuda_lib.takes_plain(boxes):
        return nms_keep_mask_blocked_plain(boxes, valid, iou_thresh)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"nms_keep_mask_blocked: boxes on {boxes.device}, "
                         f"valid on {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms_keep_mask_blocked: want float32 boxes and bool "
                        f"valid, got {boxes.dtype}, {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or valid.shape != boxes.shape[:2]:
        raise ValueError(f"nms_keep_mask_blocked: shapes {tuple(boxes.shape)}"
                         f", {tuple(valid.shape)}")
    b, k, _ = boxes.shape
    if k % 128 or k > MAX_K or b == 0:
        raise ValueError(f"nms_keep_mask_blocked: K={k}, B={b} (need "
                         f"K % 128 == 0, K <= {MAX_K}, B > 0)")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep_mask_blocked: inputs must be contiguous")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    lib = _lib()
    rc = lib.millieye_nms_keep_mask(
        cuda_lib.ptr(boxes), cuda_lib.ptr(valid), cuda_lib.ptr(keep), b, k,
        float(iou_thresh), cuda_lib.stream_ptr(boxes.device))
    cuda_lib.check(lib, rc, "nms_keep_mask_blocked")
    nms_keep_mask_blocked.launches += 1
    return keep


nms_keep_mask_blocked.launches = 0
