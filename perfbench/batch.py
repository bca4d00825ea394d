"""What the batched-detection drivers share: the pool of scenes put on the
card by the program's ``DeviceCache`` and served by its loader, one step
a batch with the benchmark's spans around its calls into each layer, the
answers kept for the check, and the check's frame bookkeeping.

A driver module (``perfbench/drivers/<name>.py``) defines ``Driver``, a
subclass that builds the program (``build``), runs its forward on a
batch (``forward``) and holds the kept answers against the reference
(``check``)."""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import check
from perfbench.traffic import Pool


class BatchDriver:
    """One cell's program and traffic. ``step()`` answers one batch and
    returns its frame count; ``keep`` lists the steps whose answers the
    check compares; ``mode`` is the detector's mode of the last step (0
    fusion, 1 the detector alone)."""

    mode = 1

    def __init__(self, config, mix, seed, device):
        self.config, self.mix = config, mix
        self.seed, self.device = int(seed), torch.device(device)
        self.steps = 0
        self.keep = set()
        self.kept = {}          # step -> (rows numpy, scene keys, extras)
        self.answered = []      # every step's rows on the host

    # ------------------------------------------------------- set-up
    def setup(self):
        from millieye_torch.data.device_cache import DeviceCache
        from millieye_torch.data.loader import PaddedCollate
        t = time.perf_counter()
        self.pool = Pool(self.mix, self.seed)
        self.phases = {"pool": time.perf_counter() - t}
        keys = [self._key(it["targets"]) for it in self.pool.items]
        if len(set(keys)) != len(keys):
            raise RuntimeError("two scenes of the pool share their targets")
        self.scene_of = {k: i for i, k in enumerate(keys)}
        kw = dict(max_targets=64)
        if self.mix["radar"]:
            kw.update(max_radar=32, max_points=256)
        t = time.perf_counter()
        self.build()
        self.phases["build"] = time.perf_counter() - t
        t = time.perf_counter()
        self.cache = DeviceCache.build(
            self.pool, PaddedCollate(self.config["img_size"], **kw),
            device=self.device)
        self.phases["cache"] = time.perf_counter() - t
        self.loader = self.cache.loader(int(self.mix["batch"]), shuffle=True,
                                        seed=self.seed)
        self.it = iter(self.loader)

    @staticmethod
    def _key(targets):
        """A scene's key: the bytes of its first target row."""
        return np.asarray(targets, np.float32).reshape(-1, 5)[0].tobytes()

    # --------------------------------------------------------- step
    def _next_batch(self):
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)

    def step(self):
        with torch.inference_mode():
            with record_function("perfbench.ingest"):
                batch = self.ingest(self._next_batch())
            with record_function("perfbench.forward"):
                boxes, valid = self.forward(batch)
            with record_function("perfbench.copy"):
                rows = torch.cat([boxes[..., :7].float(),
                                  valid[..., None].float()], -1).cpu()
        self.answered.append(rows)
        if self.steps in self.keep:
            self.kept[self.steps] = (
                rows.numpy(), [self._key(t) for t in batch["host"]["targets"]],
                self.extras(batch))
        self.steps += 1
        return rows.shape[0]

    def ingest(self, batch):
        return batch

    def extras(self, batch):
        """Device tensors of a kept step that the check compares besides
        the rows."""
        return {}

    # -------------------------------------------------------- check
    def failed(self):
        """Frames whose answer holds a number that is not finite."""
        return sum(int((~torch.isfinite(r)).flatten(1).any(1).sum())
                   for r in self.answered)

    def free(self):
        """Drop the program's state, so the reference has the card."""
        for name in ("model", "params", "state", "cache", "loader", "it"):
            self.__dict__.pop(name, None)
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def answers(self):
        """[(valid rows [n, 6] of a kept frame, scene index, step)]."""
        out = []
        for step, (rows, keys, _) in sorted(self.kept.items()):
            for r, k in zip(rows, keys):
                out.append((torch.from_numpy(r[r[:, 7] != 0][:, :6].copy()),
                            self.scene_of[k], step))
        return out

    def step_scenes(self):
        """{step: [scene index of each frame]} of the kept steps."""
        return {s: [self.scene_of[k] for k in keys]
                for s, (_, keys, _) in self.kept.items()}

    def check(self, prec=None):
        """The numbers of the kept steps' answers against the reference;
        with ``prec``, the reference at that precision answers in the
        program's place (the control)."""
        raise NotImplementedError

    def row_numbers(self, scenes, control=None):
        """``scenes``: {scene key: reference Scene}; ``control``: {scene
        key: a Scene whose kept rows answer in the program's place}."""
        answers = []
        for rows, idx, step in self.answers():
            key = self.scene_key(idx, step)
            got = control[key].kept if control is not None else rows
            answers.append((got, key))
        return check.row_numbers(answers, scenes)

    def scene_key(self, idx, step):
        return idx
