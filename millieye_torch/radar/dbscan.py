"""DBSCAN clustering for radar point clouds (port of
``millieye_tpu/radar/dbscan.py``; numpy on the host, the JAX package's
operations in its order).

Point counts are tens, so the host is the right place. ``dbscan`` takes
the native C++ backend (``millieye_torch.native``) where it loads, else
the dependency-free O(n^2) numpy loop, as the JAX package does;
``dbscan.backends`` counts the calls each answered. Both number clusters
by their first core point and give one labelling.

The reference tracker's quirk is kept: every cluster gets the GLOBAL
mean velocity (the mean over all points) unless ``global_avg_v=False``,
since the tracker's depth prediction was tuned against it.
"""
from __future__ import annotations

from collections import Counter

import numpy as np


def dbscan(points, eps, min_samples):
    """Euclidean DBSCAN. points [n, d]; returns labels [n] (noise = -1).

    Matches sklearn semantics: a core point has >= min_samples neighbors
    within eps (itself included); clusters are numbered in order of the
    first core point encountered by index.
    """
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n == 0:
        return np.empty(0, np.int64)
    try:
        from millieye_torch.native import dbscan_native
        labels = dbscan_native(pts, eps, min_samples)
        dbscan.backends["native"] += 1
        return labels
    except Exception:
        pass
    dbscan.backends["numpy"] += 1

    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    neighbor = d2 <= eps * eps
    core = neighbor.sum(1) >= min_samples

    labels = np.full(n, -1, np.int64)
    cluster = 0
    for seed in range(n):
        if labels[seed] != -1 or not core[seed]:
            continue
        frontier = [seed]
        labels[seed] = cluster
        while frontier:
            i = frontier.pop()
            if not core[i]:
                continue
            for j in np.flatnonzero(neighbor[i]):
                if labels[j] == -1:
                    labels[j] = cluster
                    if core[j]:
                        frontier.append(j)
        cluster += 1
    return labels


dbscan.backends = Counter()


def cluster_points(xyzv, weights=(2, 1, 3, 1), eps=1.5, min_samples=2,
                   global_avg_v=True):
    """Cluster [n, 4] camera-frame (x, y, depth, velocity) points.

    Returns a dict of arrays (the cluster record):
      num_points [k], center [k, 3], size [k, 3], avg_v [k]
    plus the raw labels [n].
    """
    xyzv = np.asarray(xyzv, np.float64)
    if xyzv.size == 0:
        return _empty_clusters(), np.empty(0, np.int64)
    labels = dbscan(xyzv * np.asarray(weights), eps, min_samples)
    valid = labels >= 0
    if not valid.any():
        return _empty_clusters(), labels
    # one bincount/ufunc.at pass over all clusters
    lab = labels[valid]
    ids, lab = np.unique(lab, return_inverse=True)
    k = len(ids)
    pts = xyzv[valid, :3]
    counts = np.bincount(lab, minlength=k)
    center = np.stack([np.bincount(lab, pts[:, d], k) for d in range(3)],
                      axis=1) / counts[:, None]
    mx = np.full((k, 3), -np.inf)
    mn = np.full((k, 3), np.inf)
    np.maximum.at(mx, lab, pts)
    np.minimum.at(mn, lab, pts)
    if global_avg_v:
        avg_v = np.full(k, xyzv[:, 3].mean())
    else:
        avg_v = np.bincount(lab, xyzv[valid, 3], k) / counts
    out = {
        "num_points": counts.astype(np.int64),
        "center": center,
        "size": mx - mn,
        "avg_v": avg_v,
    }
    return out, labels


def _empty_clusters():
    return {
        "num_points": np.zeros(0, np.int64),
        "center": np.zeros((0, 3)),
        "size": np.zeros((0, 3)),
        "avg_v": np.zeros(0),
    }


def filter_clusters(clusters, min_points):
    """Drop clusters with too few points."""
    keep = clusters["num_points"] >= min_points
    return {k: v[keep] for k, v in clusters.items()}


def take_cluster(clusters, i):
    return {k: v[i] for k, v in clusters.items()}


def concat_clusters(list_of):
    if not list_of:
        return _empty_clusters()
    return {k: np.stack([c[k] for c in list_of]) if list_of else None
            for k in list_of[0]}
