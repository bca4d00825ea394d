"""Drawing helpers for the demo: projected radar points, cluster boxes,
detections (port of ``millieye_tpu/radar/viz.py``). PIL on the host
(imported where a helper draws); all take and return numpy uint8 RGB
frames.
"""
from __future__ import annotations

import numpy as np

from millieye_torch.radar.projection import project_camera_xyz_to_uv


def _depth_color(depth, max_depth=10.0):
    """Near -> red, far -> blue (the reference's depth colormap role)."""
    t = float(np.clip(depth / max_depth, 0.0, 1.0))
    return (int(255 * (1 - t)), 40, int(255 * t))


def draw_radar_points(frame, points_uvzv, max_depth=10.0, radius=2):
    """Depth-colored dots for the projected cloud. points_uvzv [n, 4]
    (u, v, depth, |v|)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(frame)
    d = ImageDraw.Draw(im)
    for u, v, z, _ in np.asarray(points_uvzv):
        c = _depth_color(z, max_depth)
        d.ellipse([u - radius, v - radius, u + radius, v + radius], fill=c)
    return np.asarray(im)


def cluster_corners_3d(center, size):
    """8 corners of a cluster's camera-frame box, [3, 8]."""
    c = np.asarray(center, np.float64)
    s = np.asarray(size, np.float64) / 2
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float64)
    return (c[None, :] + signs * s[None, :]).T


_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_cluster_boxes(frame, tracked, calib, color=(255, 160, 0)):
    """Wireframe 3D boxes for tracked clusters projected to the image."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(frame)
    d = ImageDraw.Draw(im)
    for c in tracked:
        corners = cluster_corners_3d(c["center"], c["size"])
        if (corners[2] <= 0.1).any():     # behind / at the camera
            continue
        u, v = project_camera_xyz_to_uv(corners, calib)
        for a, b in _EDGES:
            d.line([float(u[a]), float(v[a]), float(u[b]), float(v[b])],
                   fill=color, width=1)
    return np.asarray(im)


def draw_detections(frame, boxes, valid, color=(0, 255, 0), labels=None):
    """2D detection rectangles (+ optional class names + scores)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(frame)
    d = ImageDraw.Draw(im)
    for i, (b, ok) in enumerate(zip(np.asarray(boxes), np.asarray(valid))):
        if not ok:
            continue
        d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                    outline=color, width=2)
        if len(b) > 4:
            tag = f"{b[4]:.2f}"
            if labels is not None and len(b) > 5:
                tag = f"{labels[int(b[5])]} {b[4]:.2f}"
            d.text((float(b[0]) + 2, float(b[1]) + 2), tag, fill=color)
    return np.asarray(im)
