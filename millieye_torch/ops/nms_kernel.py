"""Greedy NMS keep mask: the CUDA kernels K1 and K5 and their plain
versions.

Port of ``millieye_tpu/ops/nms_pallas.py``: ``nms_keep_mask_blocked`` (K1)
replaces ``nms_keep_mask_pallas_blocked`` and needs K % 128 == 0, as the
blocked TPU kernel did; ``nms_keep_mask_full`` (K5) replaces the
whole-matrix ``nms_keep_mask_pallas`` and takes any K. Source:
``millieye_torch/csrc/nms.cu``. Contract of both: boxes [B, K, 4] float32
sorted by descending score (class-offset for class-aware NMS), valid
[B, K] bool -> keep [B, K] bool, bit-equal to the sequential greedy
reference ``ops/nms.py:nms_keep_mask_ref``; K <= 1024. On the card both
launch one routine (the rows up to the last valid one only, the overlap
bits over a thread block cluster, the greedy scan in 32-row tiles); the
plain versions keep the whole-matrix form, which gives the same bits.

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
raises (outside ``cuda_lib.plain_versions()``). Each wrapper calls its
custom op (``cuda_lib.kernel_op``); ``<wrapper>.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

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


def nms_keep_mask_full_plain(boxes, valid, iou_thresh, plus_one=False):
    """K5's arithmetic in PyTorch: the overlap matrix (IoU(i, j) > t for
    j > i, the [B, K, K] float32 IoU taken elementwise), then the greedy
    scan that ORs row i into the removed set when row i is alive. The
    kernel has no ``plus_one``; this version takes it (the reference's +1
    pixel IoU) for ``nms.nms_xyxy``."""
    k = boxes.shape[1]
    idx = torch.arange(k, device=boxes.device)
    overlap = ((iou_matrix(boxes, boxes, plus_one=plus_one) > iou_thresh)
               & (idx[None, :] > idx[:, None]))
    removed = ~valid
    for i in range(k):
        removed = removed | (overlap[:, i] & ~removed[:, i:i + 1])
    return ~removed


@functools.cache
def _lib():
    lib = cuda_lib.library("nms")
    for fn in (lib.millieye_nms_keep_mask, lib.millieye_nms_keep_mask_full):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.millieye_nms_cluster_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.millieye_nms_cluster_size.restype = ctypes.c_int
    return lib


def cluster_size(batch, k):
    """The CTAs an image that K1's or K5's launch at (batch, K) takes on
    the current card (8 while batch x 8 fits the SM count, down to 1)."""
    return _lib().millieye_nms_cluster_size(batch, k)


def _launch(name, symbol, boxes, valid, iou_thresh, multiple):
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"{name}: boxes on {boxes.device}, valid on "
                         f"{valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: want float32 boxes and bool valid, got "
                        f"{boxes.dtype}, {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or valid.shape != boxes.shape[:2]:
        raise ValueError(f"{name}: shapes {tuple(boxes.shape)}, "
                         f"{tuple(valid.shape)}")
    b, k, _ = boxes.shape
    if k % multiple or k > MAX_K or b == 0 or k == 0:
        raise ValueError(f"{name}: K={k}, B={b} (need K % {multiple} == 0, "
                         f"0 < K <= {MAX_K}, B > 0)")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    lib = _lib()
    rc = getattr(lib, symbol)(
        cuda_lib.ptr(boxes), cuda_lib.ptr(valid), cuda_lib.ptr(keep), b, k,
        float(iou_thresh), cuda_lib.stream_ptr(boxes.device))
    cuda_lib.check(lib, rc, name)
    return keep


def _fake_keep(boxes, valid, iou_thresh):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


_SCHEMA = "(Tensor boxes, Tensor valid, float iou_thresh) -> Tensor"


def nms_keep_mask_blocked(boxes, valid, iou_thresh):
    """K1: keep [B, K] bool for score-sorted boxes [B, K, 4], K % 128 == 0
    (see module); the op ``millieye::nms``."""
    return _blocked_op(boxes, valid, float(iou_thresh))


def nms_keep_mask_full(boxes, valid, iou_thresh):
    """K5: keep [B, K] bool for score-sorted boxes [B, K, 4], any
    K <= 1024 (see module); the op ``millieye::nms_full``."""
    return _full_op(boxes, valid, float(iou_thresh))


nms_keep_mask_blocked.launches = 0
nms_keep_mask_full.launches = 0
_blocked_op = cuda_lib.kernel_op(
    "nms", _SCHEMA, nms_keep_mask_blocked_plain,
    lambda b, v, t: _launch("nms_keep_mask_blocked", "millieye_nms_keep_mask",
                            b, v, t, 128),
    _fake_keep, nms_keep_mask_blocked)
_full_op = cuda_lib.kernel_op(
    "nms_full", _SCHEMA, nms_keep_mask_full_plain,
    lambda b, v, t: _launch("nms_keep_mask_full",
                            "millieye_nms_keep_mask_full", b, v, t, 1),
    _fake_keep, nms_keep_mask_full)
