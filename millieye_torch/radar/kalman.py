"""9-state constant-velocity Kalman filter for radar clusters (port of
``millieye_tpu/radar/kalman.py``; float64 numpy, the same operations):

  state  x = (px, py, pz, vx, vy, vz, sx, sy, sz)   (u, v, depth order)
  obs    z = (px, py, pz, vz, sx, sy, sz)           (7 observations)

with the covariance tuning of the reference tracker: position (x, y) x10,
unobservable velocities/sizes x1000, Q *= .03 (sizes *= .05 further),
R = I.
"""
from __future__ import annotations

import numpy as np


# observation selector: H picks these state rows (H @ x == x[_OBS]);
# keeping it as an index set turns the update's H-matmuls into slicing
_OBS = np.array([0, 1, 2, 5, 6, 7, 8])
_OBS_IX = np.ix_(_OBS, _OBS)
_DIAG7 = np.arange(7)


class ClusterKalman:
    def __init__(self, center, avg_v, size, dt):
        self.dt = dt

        p = np.eye(9)
        p[0:2, 0:2] *= 10.0
        p[3:5, 3:5] *= 1000.0
        p[6:, 6:] *= 1000.0
        self.P = p
        q = np.eye(9) * 0.03
        q[6:, 6:] *= 0.05
        self.Q = q
        self.R = np.eye(7)

        self.x = np.zeros(9)
        self.x[0:3] = center
        self.x[5] = avg_v
        self.x[6:9] = size

    def predict(self):
        # x = F @ x; P = F P F^T + Q with F = I + dt*E expanded to the
        # three row/col axpys it actually is
        dt = self.dt
        self.x[0:3] += dt * self.x[3:6]
        p = self.P
        p[0:3] += dt * p[3:6]
        p[:, 0:3] += dt * p[:, 3:6]
        p += self.Q

    def update(self, center, avg_v, size):
        z = np.concatenate([center, [avg_v], size])
        x, p = self.x, self.P
        y = z - x[_OBS]
        s = p[_OBS_IX].copy()
        s[_DIAG7, _DIAG7] += 1.0                      # + R = I
        k = np.linalg.solve(s, p[:, _OBS].T).T        # P H^T S^-1 (S sym)
        self.x = x + k @ y
        self.P = p - k @ p[_OBS, :]                   # (I - K H) P

    @property
    def center(self):
        return self.x[0:3].copy()

    @property
    def avg_v(self):
        return float(self.x[5])

    @property
    def size(self):
        return self.x[6:9].copy()
