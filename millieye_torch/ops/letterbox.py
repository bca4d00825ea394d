"""Camera-frame and radar-map preprocessing (port of
``millieye_tpu/ops/letterbox.py``). HWC tensors; interpolation follows
torch: nearest is src = floor(dst*in/out), bilinear is align_corners."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_square(img, pad_value=0.0):
    """img [H, W, C] -> ([S, S, C], (left, right, top, bottom)); the
    difference splits as diff//2 leading, the rest trailing."""
    h, w = img.shape[0], img.shape[1]
    diff = abs(h - w)
    p1, p2 = diff // 2, diff - diff // 2
    if h <= w:
        pad = (0, 0, 0, 0, p1, p2)          # F.pad runs last dim first
        pad_ltrb = (0, 0, p1, p2)
    else:
        pad = (0, 0, p1, p2, 0, 0)
        pad_ltrb = (p1, p2, 0, 0)
    return F.pad(img, pad, value=pad_value), pad_ltrb


def resize_nearest(img, size):
    h, w = img.shape[0], img.shape[1]
    ar = torch.arange(size, dtype=torch.float32, device=img.device)
    ri = torch.floor(ar * (h / size)).long()
    ci = torch.floor(ar * (w / size)).long()
    return img[ri][:, ci]


def _ac_weights(in_size, out_size, device):
    if out_size == 1:
        src = torch.zeros(1, device=device)
    else:
        src = (torch.arange(out_size, dtype=torch.float32, device=device)
               * ((in_size - 1) / (out_size - 1)))
    lo = torch.floor(src).long().clamp(0, in_size - 1)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, src - lo


def resize_bilinear_align_corners(img, size):
    """img [H, W, C] -> [size, size, C]."""
    h, w = img.shape[0], img.shape[1]
    rlo, rhi, rf = _ac_weights(h, size, img.device)
    clo, chi, cf = _ac_weights(w, size, img.device)
    top = img[rlo] * (1 - rf)[:, None, None] + img[rhi] * rf[:, None, None]
    return (top[:, clo] * (1 - cf)[None, :, None]
            + top[:, chi] * cf[None, :, None])


def letterbox_image(img_u8, size):
    """uint8 HWC frame -> float32 [size, size, C] in [0, 1] + pads:
    ToTensor -> pad_to_square(0) -> nearest resize."""
    img, pad = pad_to_square(img_u8.float() / 255.0, 0.0)
    return resize_nearest(img, size), pad
