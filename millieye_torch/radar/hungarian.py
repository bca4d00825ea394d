"""Minimum-cost assignment (Hungarian) for cluster association (port of
``millieye_tpu/radar/hungarian.py``).

The cost matrices are tiny (tracked clusters x new clusters, both single
digits), so this runs on the host, in the JAX package's branches and
order: a row or a column alone, an exhaustive search up to 4 x 4, the
native C++ solver (``millieye_torch.native``) where it loads, else
scipy's ``linear_sum_assignment``. On tied costs the native solver and
scipy may pick different assignments, so the two packages agree only
where they take the same branch, as they do on one machine.
``assign.backends`` counts the calls each branch answered.
"""
from __future__ import annotations

from collections import Counter

import numpy as np


def assign(cost):
    """cost [n, m] -> (row_idx, col_idx) minimizing total cost."""
    cost = np.asarray(cost, np.float64)
    if cost.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    n, m = cost.shape
    # tiny matrices (the tracker's usual 1-3 tracks) solve exactly in a
    # few numpy ops, without the ctypes or scipy round trip
    if n == 1:
        assign.backends["row"] += 1
        return (np.zeros(1, np.int64),
                np.array([int(cost[0].argmin())], np.int64))
    if m == 1:
        assign.backends["column"] += 1
        return (np.array([int(cost[:, 0].argmin())], np.int64),
                np.zeros(1, np.int64))
    if n <= 4 and m <= 4:
        from itertools import permutations
        assign.backends["search"] += 1
        rows = np.arange(min(n, m), dtype=np.int64)
        best, best_cols = np.inf, None
        if n <= m:
            for cols in permutations(range(m), n):
                tot = cost[rows, cols].sum()
                if tot < best:
                    best, best_cols = tot, cols
            return rows, np.asarray(best_cols, np.int64)
        for rsel in permutations(range(n), m):
            tot = cost[rsel, rows].sum()
            if tot < best:
                best, best_cols = tot, rsel
        order = np.argsort(best_cols)
        return (np.asarray(best_cols, np.int64)[order],
                rows[order])
    try:
        from millieye_torch.native import hungarian_native
        out = hungarian_native(cost)
        assign.backends["native"] += 1
        return out
    except Exception:
        from scipy.optimize import linear_sum_assignment
        r, c = linear_sum_assignment(cost)
        assign.backends["scipy"] += 1
        return np.asarray(r, np.int64), np.asarray(c, np.int64)


assign.backends = Counter()
