"""Host-side padding of radar pipeline outputs (the two helpers of
``millieye_tpu/radar/pipeline.py`` that ``FusionEngine.pack_radar``
uses; numpy only)."""
from __future__ import annotations

import numpy as np


def normalize_boxes_to_padded(xyxy, frame_size):
    """Apply the letterbox pad offset and normalize to (0, 1) of the
    padded square. Returns (boxes [k, 4], valid [k])."""
    w, h = frame_size
    s = max(w, h)
    p1 = abs(h - w) // 2
    out = np.array(xyxy, np.float64).reshape(-1, 4)
    if h <= w:   # pad rows (y)
        out[:, 1] += p1
        out[:, 3] += p1
    else:
        out[:, 0] += p1
        out[:, 2] += p1
    out = np.clip(out / s, 0.0, 1.0)
    valid = (out[:, 0] < out[:, 2]) & (out[:, 1] < out[:, 3])
    return out, valid


def pad_rows(arr, n_rows, width):
    """Pad/trim [k, width] to [n_rows, width] float32 + validity mask."""
    arr = np.asarray(arr, np.float32).reshape(-1, width)[:n_rows]
    out = np.zeros((n_rows, width), np.float32)
    mask = np.zeros(n_rows, bool)
    out[:len(arr)] = arr
    mask[:len(arr)] = True
    return out, mask
