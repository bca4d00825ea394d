"""The device side of a collated batch (port of the ingest part of
``millieye_tpu/train/recipes.py``: ``_map_ingest``, ``_HOST_BATCH_KEYS``
and ``fusion_device_batch``; the trainer and the stage recipes are not
ported yet).

Radar heatmaps are rasterized on the device from the padded point
clouds, image by image (the JAX package ``vmap``s one image's function).
"""
from __future__ import annotations

import numpy as np
import torch

from millieye_torch.device import resolve_device
from millieye_torch.ops import letterbox as lb
from millieye_torch.ops.rasterize import radar_heatmap


def _map_ingest(points, pmask, frame_size, img_size):
    """points [B, P, 4], pmask [B, P] -> radar maps [B, S/16, S/16, 3]:
    each image's heatmap padded to a square and resized (bilinear,
    align_corners) to ``img_size // 16``."""
    maps = []
    for p, m in zip(points, pmask):
        heat = radar_heatmap(p, m, frame_size)
        heat, _ = lb.pad_to_square(heat, 0.0)
        maps.append(lb.resize_bilinear_align_corners(heat, img_size // 16))
    return torch.stack(maps)


_HOST_BATCH_KEYS = ("paths", "frame_size", "radar_points", "pmask",
                    "_n", "brightness", "host")
_HOST_COPY_KEYS = ("targets", "tmask")


def _to(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def fusion_device_batch(batch, img_size, device="cuda"):
    """Collated host batch (numpy, or a ``DeviceCache`` batch already on
    the device) -> a batch of tensors on ``device`` with rasterized radar
    maps. Host-side metadata (``_n``, ``brightness``)
    pass through unconverted, and ``batch["host"]`` keeps a numpy copy
    of ``targets`` and ``tmask``, so an evaluation never fetches them
    from the device."""
    dev = resolve_device(device)
    out = {k: _to(v, dev) for k, v in batch.items()
           if k not in _HOST_BATCH_KEYS}
    for k in ("_n", "brightness"):
        if k in batch:
            out[k] = batch[k]
    out["host"] = batch.get("host") or {
        k: np.asarray(batch[k]) for k in _HOST_COPY_KEYS if k in batch}
    if "radar_points" in batch:
        w, h = batch.get("frame_size", (640, 480))
        out["radar_maps"] = _map_ingest(_to(batch["radar_points"], dev),
                                        _to(batch["pmask"], dev),
                                        (int(w), int(h)), img_size)
    return out
