"""Host-side (numpy) preprocessing, a copy of
``millieye_tpu/data/preprocessing.py`` (the numpy calls kept as they are,
so the two packages give the same arrays).

Datasets run in loader threads without touching the card; the math
matches ``millieye_torch.ops.letterbox`` (and therefore torch's
F.pad/F.interpolate, which the reference uses) so host- and device-side
ingest are interchangeable.
"""
from __future__ import annotations

import numpy as np


def np_pad_to_square(img, pad_value=0.0):
    """[H, W, C] -> ([S, S, C], (left, right, top, bottom))."""
    h, w = img.shape[:2]
    diff = abs(h - w)
    p1, p2 = diff // 2, diff - diff // 2
    if h <= w:
        out = np.pad(img, ((p1, p2), (0, 0), (0, 0)),
                     constant_values=pad_value)
        pad = (0, 0, p1, p2)
    else:
        out = np.pad(img, ((0, 0), (p1, p2), (0, 0)),
                     constant_values=pad_value)
        pad = (p1, p2, 0, 0)
    return out, pad


def np_resize_nearest(img, size):
    h, w = img.shape[:2]
    ri = np.floor(np.arange(size) * (h / size)).astype(np.int64)
    ci = np.floor(np.arange(size) * (w / size)).astype(np.int64)
    return img[ri][:, ci]


def np_resize_bilinear_ac(img, size):
    """torch bilinear align_corners=True."""
    h, w = img.shape[:2]

    def weights(n, m):
        src = (np.arange(m) * ((n - 1) / (m - 1))) if m > 1 else np.zeros(1)
        lo = np.clip(np.floor(src).astype(np.int64), 0, n - 1)
        hi = np.minimum(lo + 1, n - 1)
        return lo, hi, (src - lo).astype(np.float32)

    rlo, rhi, rf = weights(h, size)
    clo, chi, cf = weights(w, size)
    top = img[rlo] * (1 - rf)[:, None, None] + img[rhi] * rf[:, None, None]
    return top[:, clo] * (1 - cf)[None, :, None] + top[:, chi] * cf[None, :, None]


def horizontal_flip(img, targets):
    """Mirror image + normalized-xywh targets (utils/augmentations.py:6-9)."""
    img = img[:, ::-1].copy()
    if targets is not None and len(targets):
        targets = targets.copy()
        targets[:, 1] = 1.0 - targets[:, 1]
    return img, targets


def load_image_rgb(path):
    """Decode to float32 [H, W, 3] in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return arr
