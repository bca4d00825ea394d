"""Traffic: the scene generator (``scenes.py``) and the mixes, one data
file each (``perfbench/traffic/<name>.json``), which ``pool`` reads.

A mix of batched detection holds: ``illumination`` ("H" or "L"),
``radar`` (whether scenes carry radar points and proposals), ``pool``
(distinct scenes rendered from the seed), ``repeat`` (copies of the pool
a loader epoch holds) and ``batch`` (frames a step)."""
from __future__ import annotations

from perfbench.traffic.scenes import SyntheticScenes


class Pool:
    """``pool`` scenes of one illumination rendered once from ``seed``;
    ``get(i)`` gives scene ``i % pool``, so an epoch of ``repeat`` copies
    holds every scene ``repeat`` times."""

    def __init__(self, mix, seed):
        n = int(mix["pool"])
        gen = SyntheticScenes(2 * n, seed=int(seed),
                              illumination=(mix["illumination"],),
                              radar=bool(mix["radar"]))
        self.items = [gen.get(i) for i in range(n)]
        self.repeat = int(mix.get("repeat", 1))

    def __len__(self):
        return len(self.items) * self.repeat

    def get(self, i):
        return self.items[i % len(self.items)]
