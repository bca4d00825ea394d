"""Multi-frame cluster tracker: associate -> predict -> spawn -> update
-> prune (port of ``millieye_tpu/radar/tracker.py``; numpy on the host).

Association cost is the weighted squared distance between new cluster
centers and existing tracks' centers with depth extrapolated one frame by
the track velocity (weights (1, 1, 10)), one vectorized cost matrix,
solved by ``hungarian.assign``.

A track is reported once its (current or pre-interruption) hit streak
reaches ``min_hits`` (or during warm-up), and survives ``max_age`` missed
frames. Track ids come from a counter on ``_Track`` shared by the whole
process, as in the JAX package: they depend on how many tracks the
process has made before.
"""
from __future__ import annotations

import numpy as np

from millieye_torch.radar.hungarian import assign
from millieye_torch.radar.kalman import ClusterKalman

ASSOC_WEIGHTS = np.array([1.0, 1.0, 10.0])


class _Track:
    _count = 0

    def __init__(self, cluster, dt, max_age):
        self.kf = ClusterKalman(cluster["center"], cluster["avg_v"],
                                cluster["size"], dt)
        self.num_points = int(cluster["num_points"])
        self.max_age = max_age
        self.time_since_update = 0
        self.hit_streak = 0
        self.prev_hit_streak = 0
        self.id = _Track._count
        _Track._count += 1

    def predict(self):
        if self.time_since_update == self.max_age:
            self.prev_hit_streak = self.hit_streak
            self.hit_streak = 0
        self.kf.predict()
        self.time_since_update += 1

    def update(self, cluster):
        self.time_since_update = 0
        self.hit_streak += 1
        self.kf.update(cluster["center"], cluster["avg_v"], cluster["size"])
        self.num_points = int(cluster["num_points"])

    def snapshot(self):
        return {
            "num_points": self.num_points,
            "center": self.kf.center,
            "size": self.kf.size,
            "avg_v": self.kf.avg_v,
            "id": self.id,
        }


class ClusterTracker:
    def __init__(self, fps=20, max_age=4, min_hits=4):
        self.fps = fps
        self.max_age = max_age
        self.min_hits = min_hits
        self.tracks = []
        self.frame_count = 0

    def _associate(self, new_clusters):
        """Vectorized weighted-distance cost + Hungarian. Returns matched
        (track_idx, new_idx) plus unmatched new indices."""
        n_old = len(self.tracks)
        n_new = len(new_clusters["center"])
        if n_old == 0 or n_new == 0:
            return [], list(range(n_new))
        old_c = np.stack([t.kf.center for t in self.tracks])
        old_v = np.array([t.kf.avg_v for t in self.tracks])
        pred = old_c.copy()
        pred[:, 2] += old_v / self.fps
        diff = new_clusters["center"][None, :, :] - pred[:, None, :]
        cost = (diff**2 * ASSOC_WEIGHTS).sum(-1)
        rows, cols = assign(cost)
        matched = list(zip(rows.tolist(), cols.tolist()))
        unmatched_new = [j for j in range(n_new) if j not in set(cols.tolist())]
        return matched, unmatched_new

    def update(self, new_clusters):
        """new_clusters: dict of arrays (see radar.dbscan.cluster_points).
        Returns the list of reportable cluster snapshots."""
        self.frame_count += 1
        matched, unmatched_new = self._associate(new_clusters)

        for t in self.tracks:
            t.predict()

        for j in unmatched_new:
            c = {k: v[j] for k, v in new_clusters.items()}
            self.tracks.append(_Track(c, 1.0 / self.fps, self.max_age))

        for i, j in matched:
            c = {k: v[j] for k, v in new_clusters.items()}
            self.tracks[i].update(c)

        self.tracks = [t for t in self.tracks
                       if t.time_since_update <= self.max_age]

        out = []
        for t in self.tracks:
            streak = max(t.hit_streak, t.prev_hit_streak)
            if (t.time_since_update <= self.max_age
                    and (streak >= self.min_hits
                         or self.frame_count <= self.min_hits)):
                out.append(t.snapshot())
        return out
