"""Radar -> camera projection and calibration (port of
``millieye_tpu/radar/projection.py``; numpy on the host, the JAX
package's operations in its order).

* calibration comes from a ROS camera_info YAML (projection fx/cx/fy/cy
  and distortion k1, k2, t1, t2, k3) plus the radar -> camera translation
  (-0.07, -0.05, 0);
* radar axes (x right, y forward, z up) map to camera axes as
  (x, -z, y) -> (x_cam, y_cam, depth);
* distortion: r^2 polynomial radial terms + tangential terms, then the
  focal/principal transform.
"""
from __future__ import annotations

import numpy as np

DEFAULT_RADAR_TO_CAMERA = (-0.07, -0.05, 0.0)


def load_calib(path, translation=DEFAULT_RADAR_TO_CAMERA):
    """Read fx, cx, fy, cy, k1, k2, t1, t2, k3 (+ translation) from a ROS
    camera_info YAML. Returns a 12-element float array (same layout as the
    reference's calib_param so downstream code is interchangeable)."""
    import yaml

    with open(path) as fh:
        doc = yaml.safe_load(fh)
    cm = np.asarray(doc["camera_matrix"]["data"], np.float64).reshape(3, 3)
    dist = np.asarray(doc["distortion_coefficients"]["data"], np.float64)
    return np.concatenate([
        [cm[0, 0], cm[0, 2], cm[1, 1], cm[1, 2]], dist, translation])


def project_camera_xyz_to_uv(xyz, calib):
    """Camera-frame metric points -> pixel coordinates.

    xyz: [3, n] (x right, y down, depth); calib: load_calib output.
    Returns (u [n], v [n]).
    """
    fx, cx, fy, cy, k1, k2, t1, t2, k3, tx, ty, tz = calib
    # points at/behind the camera plane produce inf/nan here and are
    # dropped by the FOV filter downstream — suppress the fp warnings
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        x = (xyz[0] + tx) / (xyz[2] + tz)
        y = (xyz[1] + ty) / (xyz[2] + tz)
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        xd = x * radial + 2 * t1 * x * y + t2 * (r2 + 2 * x * x)
        yd = y * radial + 2 * t2 * x * y + t1 * (r2 + 2 * y * y)
        return xd * fx + cx, yd * fy + cy


def radar_points_to_image(points, calib):
    """Radar detections -> image plane.

    points: [4, n] radar-frame (x, y, z, velocity).
    Returns (uv [n, 2] int64 pixels, xyzv [n, 4] camera-frame
    (x, y, depth, velocity)) — the layout downstream filtering expects
    (run_mp.py:80-86).
    """
    x, y_depth, z_up, vel = points[0], points[1], points[2], points[3]
    cam = np.stack([x, -z_up, y_depth])      # radar (x,-z,y) -> camera
    u, v = project_camera_xyz_to_uv(cam, calib)
    tz = calib[11]
    with np.errstate(invalid="ignore"):
        uv = np.stack([u, v], axis=-1).astype(np.int64)
    xyzv = np.stack([cam[0], cam[1], cam[2] + tz, vel], axis=-1)
    return uv, xyzv
