"""Device-resident dataset cache (port of
``millieye_tpu/data/device_cache.py``): the whole padded set is copied to
the device once, and each batch is an index gather there.

Detection datasets at this scale (thousands of padded 416x416 scenes)
fit in the card's memory, so the classic accelerator-resident cache
(tf.data ``cache().device()``, FFCV's "OS-cache" mode) is the simple
design: put the whole padded set on the device once, and per batch copy
only its index vector (a few dozen bytes).

Usage::

    cache = DeviceCache.build(dataset, PaddedCollate(...), device="cuda")
    for batch in cache.loader(batch_size=16, shuffle=True, seed=0):
        ...  # dict of tensors on the device: images f32, targets, masks,
             # radar_*; batch["host"] holds targets and tmask as numpy

Images are stored float16 (half the memory and the copy, ~1e-3 relative
error, far below sensor noise) and cast back to float32 at the gather;
all other arrays keep their collate dtypes. Brightness, frame size,
paths, and a host copy of the targets and their mask stay on the host,
so an evaluation never fetches them from the card.
"""
from __future__ import annotations

import numpy as np
import torch

from millieye_torch.device import resolve_device
from millieye_torch.runtime.profiler import trace_annotation

_F16_KEYS = ("images",)
_HOST_KEYS = ("paths", "frame_size", "brightness")
HOST_COPY_KEYS = ("targets", "tmask")


def _gather(arrays, idx, f16_keys):
    out = {k: v.index_select(0, idx) for k, v in arrays.items()}
    for k in f16_keys:
        if k in out:
            out[k] = out[k].float()
    return out


class DeviceCache:
    """Whole padded dataset as tensors on one device + host-side
    metadata."""

    def __init__(self, arrays, host_meta=None, device="cuda"):
        self.device = resolve_device(device)
        self.arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .to(self.device) for k, v in arrays.items()}
        self.host_meta = host_meta or {}
        self.host_arrays = {k: np.asarray(arrays[k]) for k in HOST_COPY_KEYS
                            if k in arrays}
        self.n = len(next(iter(arrays.values())))

    @classmethod
    def build(cls, dataset, collate, device="cuda", image_dtype=np.float16):
        """Collate the whole dataset once (host) and copy it to
        ``device``."""
        cols, paths, bright = {}, [], []
        step = 64
        for lo in range(0, len(dataset), step):
            items = [dataset.get(i)
                     for i in range(lo, min(lo + step, len(dataset)))]
            b = collate(items)
            paths.extend(b.get("paths", ()))
            # per-item brightness stays on the host so auto-mode selection
            # never fetches from the device (harness.evaluate_fusion)
            bright.extend(np.asarray(b["images"],
                                     np.float32).mean(axis=(1, 2, 3)))
            for k, v in b.items():
                if k in _HOST_KEYS:
                    continue
                if k in _F16_KEYS and image_dtype is not None:
                    v = np.asarray(v, image_dtype)
                cols.setdefault(k, []).append(v)
        arrays = {k: np.concatenate(v, 0) for k, v in cols.items()}
        meta = {"paths": paths, "brightness": np.asarray(bright, np.float32)}
        # frame_size is per-dataset constant (collate takes item[0]'s)
        if hasattr(dataset, "get") and "frame_size" in dataset.get(0):
            meta["frame_size"] = dataset.get(0)["frame_size"]
        return cls(arrays, meta, device=device)

    def __len__(self):
        return self.n

    def loader(self, batch_size, shuffle=False, seed=0, drop_last=None):
        """``drop_last=None`` resolves to ``shuffle``: training loaders
        (shuffle=True) keep full fixed batches, eval loaders keep the
        tail (padded to the fixed shape, true count in ``batch["_n"]``)
        so no sample is silently skipped."""
        if drop_last is None:
            drop_last = shuffle
        return _CacheLoader(self, batch_size, shuffle, seed, drop_last)


class _CacheLoader:
    """DataLoader-shaped view over a DeviceCache: ``__iter__`` yields
    dicts of device tensors; reshuffles each epoch like data.loader."""

    def __init__(self, cache, batch_size, shuffle, seed, drop_last):
        self.cache = cache
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n, b = len(self.cache), self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def __iter__(self):
        self.epoch += 1
        n, b = len(self.cache), self.batch_size
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        f16 = tuple(k for k in _F16_KEYS if k in self.cache.arrays)
        fs = self.cache.host_meta.get("frame_size")
        bright = self.cache.host_meta.get("brightness")
        for lo in range(0, n, b):
            chunk = true_chunk = idx[lo:lo + b]
            if len(chunk) < b:
                if self.drop_last:
                    return
                # pad the tail by repeating the last row: fixed shapes;
                # callers see the true count via batch["_n"]
                chunk = np.concatenate(
                    [chunk, np.full(b - len(chunk), chunk[-1])])
            with trace_annotation("millieye.ingest"):
                batch = _gather(self.cache.arrays,
                                torch.from_numpy(chunk).to(self.cache.device),
                                f16)
                batch["host"] = {k: v[chunk]
                                 for k, v in self.cache.host_arrays.items()}
            batch["_n"] = min(b, n - lo)
            if bright is not None:
                batch["brightness"] = float(bright[true_chunk].mean())
            if fs is not None:
                batch["frame_size"] = fs
            yield batch
