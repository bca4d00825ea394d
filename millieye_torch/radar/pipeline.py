"""Per-frame radar processing: points -> filtered cloud -> tracked
clusters -> 2D box proposals, and the host-side padding that
``FusionEngine.pack_radar`` applies to them (port of
``millieye_tpu/radar/pipeline.py``; numpy on the host over tens of points,
the JAX package's operations in its order, so both give equal arrays).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from millieye_torch.radar.dbscan import cluster_points, filter_clusters
from millieye_torch.radar.projection import (
    project_camera_xyz_to_uv,
    radar_points_to_image,
)
from millieye_torch.radar.tracker import ClusterTracker


@dataclass
class RadarParams:
    """The demo's defaults."""
    radar_fps: int = 20
    num_nearest: int = 3        # radar frames matched per video frame
    overlay_num: int = 2        # radar frames aggregated per video frame
    dbscan_weights: tuple = (2, 1, 3, 1)
    dbscan_eps: float = 1.5
    num_pts_filter: int = 5     # min points per cluster
    min_velocity: float = 0.1
    max_size: float = 20.0      # 3D box size cap
    max_depth: float = 10.0
    max_age: int = 4
    min_hits: int = 4
    frame_size: tuple = (640, 480)


# proposal position compensation: shift down by 0.8*h/5 and scale (w, h)
# by (1.2, 1.4)
_COMP_TRANSLATIONS = ((0.0, 0.8 / 5.0),)   # fractions of (w, h)
_COMP_SCALES = ((1.2, 1.4),)


def clusters_to_proposals(tracked, calib, max_size):
    """Tracked cluster snapshots -> xyxy proposals in image coordinates.

    Projects the front face (z_multi=0 plane through the center) of each
    cluster's 3D box and applies the compensation augments.
    """
    if not len(tracked):
        return np.zeros((0, 4), np.float64)
    sizes = np.asarray([c["size"] for c in tracked], np.float64)
    centers = np.asarray([c["center"] for c in tracked], np.float64)
    keep = sizes.max(1) < max_size
    if not keep.any():
        return np.zeros((0, 4), np.float64)
    sizes, centers = sizes[keep], centers[keep]
    k = len(sizes)
    # one projection call for all clusters' front-face corner pairs
    half = sizes * (0.5, 0.5, 0.0)
    corners = np.concatenate([centers + half, centers - half], 0)
    u, v = project_camera_xyz_to_uv(corners.T, calib)
    x, y = (u[:k] + u[k:]) / 2, (v[:k] + v[k:]) / 2
    w, h = u[:k] - u[k:], v[:k] - v[k:]
    boxes = []
    for (dx, dy) in _COMP_TRANSLATIONS:
        for (sw, sh) in _COMP_SCALES:
            cx, cy = x + dx * w, y + dy * h
            bw, bh = w * sw, h * sh
            boxes.append(np.stack([cx - bw / 2, cy - bh / 2,
                                   cx + bw / 2, cy + bh / 2], -1))
    # per-cluster-major order, as the reference's per-cluster augment loop
    return (np.stack(boxes, 1).reshape(-1, 4)
            if len(boxes) > 1 else boxes[0])


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


class RadarPipeline:
    """Stateful per-recording pipeline (owns the tracker)."""

    def __init__(self, calib, params: RadarParams = None):
        self.calib = calib
        self.p = params or RadarParams()
        self.tracker = ClusterTracker(self.p.radar_fps, self.p.max_age,
                                      self.p.min_hits)

    def process(self, points_3d):
        """points_3d [4, n] radar-frame (x, y, z, velocity), typically the
        aggregate of ``overlay_num`` consecutive radar frames.

        Returns dict:
          points_uvzv [m, 4]  filtered cloud in (u, v, depth, velocity)
                              form for the heatmap rasterizer
          proposals   [k, 4]  xyxy box proposals in image coordinates
          tracked             the tracker's reported cluster snapshots
        """
        p = self.p
        uv, xyzv = radar_points_to_image(np.asarray(points_3d, np.float64),
                                         self.calib)
        w, h = p.frame_size
        keep = ((uv[:, 0] >= 0) & (uv[:, 0] < w)
                & (uv[:, 1] >= 0) & (uv[:, 1] < h)
                & (xyzv[:, 2] < p.max_depth)
                & (np.abs(xyzv[:, 3]) >= p.min_velocity))
        uv, xyzv = uv[keep], xyzv[keep]
        points_uvzv = np.concatenate([uv.astype(np.float64), xyzv[:, 2:]], -1)

        clusters, _ = cluster_points(xyzv, p.dbscan_weights, p.dbscan_eps)
        clusters = filter_clusters(clusters, p.num_pts_filter)
        tracked = self.tracker.update(clusters)
        proposals = clusters_to_proposals(tracked, self.calib, p.max_size)
        return {"points_uvzv": points_uvzv, "proposals": proposals,
                "tracked": tracked}
