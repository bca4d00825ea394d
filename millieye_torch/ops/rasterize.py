"""Radar heatmap rasterizer (port of ``millieye_tpu/ops/rasterize.py``).

Three channels over the image plane at ~1/16 scale: point count scaled
by (0, 5), mean depth per bin (empty or < 1 -> 100) scaled by (12, 0)
reversed, |mean velocity| scaled by (0, 4). The histogram is a masked
scatter-add, spelled as a one-hot matrix product so that it is
deterministic: CUDA's ``index_put_(accumulate=True)`` adds in an order
that changes from run to run. The counts are exact either way; the
depth and velocity sums are float32 sums in another order than the JAX
package's sequential scatter.
"""
from __future__ import annotations

import torch

from millieye_torch.device import constant

RANGES = ((0.0, 5.0), (12.0, 0.0), (0.0, 4.0))


def heatmap_bins(img_size, map_size=32):
    """(bin_w, bin_h): scale = max(img)/map_size, bins = round(dim/scale)."""
    scale = max(img_size) / map_size
    return int(round(img_size[0] / scale)), int(round(img_size[1] / scale))


def radar_heatmap(points, pmask, img_size, map_size=32):
    """points [P, 4] (u, v, z, V) float32, pmask [P] bool, img_size
    (w, h) -> [bin_h, bin_w, 3] float32 in [0, 1]."""
    w, h = img_size
    bin_w, bin_h = heatmap_bins(img_size, map_size)
    u, v, z, vel = points[:, 0], points[:, 1], points[:, 2], points[:, 3]
    in_range = (u >= 0) & (u <= w) & (v >= 0) & (v <= h) & pmask
    bx = (u / w * bin_w).to(torch.int64).clamp(0, bin_w - 1)
    by = (v / h * bin_h).to(torch.int64).clamp(0, bin_h - 1)
    # out-of-range points go to a spare bin that is cut off below
    n_bins = bin_h * bin_w
    idx = torch.where(in_range, by * bin_w + bx, torch.full_like(by, n_bins))
    onehot = (idx[:, None] == torch.arange(n_bins + 1, device=idx.device)
              ).float()
    vals = torch.stack([torch.ones_like(u), z, vel]).float()   # [3, P]
    sums = (vals @ onehot)[:, :n_bins].reshape(3, bin_h, bin_w)
    h0, zsum, vsum = sums
    depth = zsum / (h0 + 1e-6)
    depth = torch.where(depth < 1, torch.full_like(depth, 100.0), depth)
    speed = torch.abs(vsum / (h0 + 1e-6))
    maps = torch.stack([h0, depth, speed], -1)
    lo = constant(tuple(r[0] for r in RANGES), points.device)
    hi = constant(tuple(r[1] for r in RANGES), points.device)
    return ((maps - lo) / (hi - lo)).clamp(0.0, 1.0)
