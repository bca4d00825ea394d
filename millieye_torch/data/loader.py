"""Threaded data loader with fixed-shape padded collate: a copy of
``millieye_tpu/data/loader.py``.

Replaces torch's DataLoader(num_workers=16, collate_fn=...) (module3
train.py:154-161) with a dependency-free threaded prefetcher. The collate
produces PADDED arrays: every batch has identical shapes, so the eval
and serving steps see one shape (multiscale training rolls one of a few).
"""
from __future__ import annotations

import queue
import random
import threading

import numpy as np

from millieye_torch.data.preprocessing import np_resize_nearest


class PaddedCollate:
    """items -> dict of fixed-shape numpy arrays.

    Padded slots are zero with False masks. Multiscale mode re-rolls the
    image size every 10 batches from {img_size-96 .. img_size+96 step 32}
    (ListDataset.collate_fn, module2 utils/datasets.py:158-162).
    """

    def __init__(self, img_size=416, max_targets=64, max_radar=32,
                 max_points=256, multiscale=False, seed=0):
        self.base_size = img_size
        self.cur_size = img_size
        self.max_targets = max_targets
        self.max_radar = max_radar
        self.max_points = max_points
        self.multiscale = multiscale
        self.batch_count = 0
        self._rng = random.Random(seed)

    def _roll_size(self):
        if self.multiscale and self.batch_count % 10 == 0:
            lo, hi = self.base_size - 3 * 32, self.base_size + 3 * 32
            self.cur_size = self._rng.choice(range(lo, hi + 1, 32))
        self.batch_count += 1
        return self.cur_size

    @staticmethod
    def _pad(rows, n, width):
        out = np.zeros((n, width), np.float32)
        mask = np.zeros(n, bool)
        rows = np.asarray(rows, np.float32).reshape(-1, width)[:n]
        out[:len(rows)] = rows
        mask[:len(rows)] = True
        return out, mask

    def __call__(self, items):
        size = self._roll_size()
        # preallocate + resize directly into the batch tensor: np.stack
        # of per-item resize results costs an extra full-batch copy
        images = np.empty((len(items),) + (size, size) +
                          items[0]["image"].shape[2:], np.float32)
        for j, it in enumerate(items):
            img = it["image"]
            if img.shape[0] == size and img.shape[1] == size:
                images[j] = img
            else:
                iy = (np.arange(size) * (img.shape[0] / size)).astype(int)
                ix = (np.arange(size) * (img.shape[1] / size)).astype(int)
                images[j] = img[np.ix_(iy, ix)]
        batch = {
            "paths": [it["path"] for it in items],
            "images": images,
            # host-side batch brightness for auto-mode selection
            # (test_fusion.py:24-32 img.mean() < 0.1) — computed here so
            # eval never pays a per-batch device->host fetch for it
            "brightness": float(images.mean()),
        }
        t = [self._pad(it["targets"], self.max_targets, 5) for it in items]
        batch["targets"] = np.stack([x[0] for x in t])
        batch["tmask"] = np.stack([x[1] for x in t])

        if "radar_boxes" in items[0]:
            rb = [self._pad(it["radar_boxes"], self.max_radar, 4)
                  for it in items]
            batch["radar_boxes"] = np.stack([x[0] for x in rb])
            batch["rmask"] = np.stack([x[1] for x in rb])
        if "radar_points" in items[0]:
            rp = [self._pad(it["radar_points"], self.max_points, 4)
                  for it in items]
            batch["radar_points"] = np.stack([x[0] for x in rp])
            batch["pmask"] = np.stack([x[1] for x in rp])
            batch["frame_size"] = items[0]["frame_size"]
        return batch


class DataLoader:
    """Iterate padded batches with background worker threads."""

    def __init__(self, dataset, batch_size, collate: PaddedCollate,
                 shuffle=False, num_workers=4, drop_last=False, seed=0,
                 prefetch_batches=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch_batches

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self):
        self.epoch += 1
        out_q = queue.Queue(maxsize=self.prefetch)
        batches = list(self._index_batches())
        stop = threading.Event()
        failure = []

        def produce():
            # item fetch fans out over a thread pool (numpy generation /
            # JPEG decode release the GIL for their heavy ops); collate
            # stays sequential in batch order so its multiscale rolls and
            # padding are deterministic. Worker exceptions propagate to
            # the consumer (the reference's demo threads swallow all
            # errors, run_mp.py:159-160 — don't).
            import collections
            from concurrent.futures import ThreadPoolExecutor
            def put_checked(obj):
                # timeout-put that rechecks stop: a consumer that exits
                # its iteration early (e.g. a calibration loop's break)
                # must not leave this thread blocked on a full queue for
                # the life of the process
                while not stop.is_set():
                    try:
                        out_q.put(obj, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                with ThreadPoolExecutor(self.num_workers) as ex:
                    window = collections.deque()
                    it = iter(batches)

                    def submit_next():
                        chunk = next(it, None)
                        if chunk is not None:
                            window.append(ex.submit(
                                lambda c: [self.dataset.get(i) for i in c],
                                chunk))

                    for _ in range(self.num_workers + self.prefetch):
                        submit_next()
                    while window:
                        if stop.is_set():
                            return
                        items = window.popleft().result()
                        submit_next()
                        if not put_checked(self.collate(items)):
                            return
            except BaseException as e:          # noqa: BLE001
                failure.append(e)
            finally:
                put_checked(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
            if failure:
                raise failure[0]
        finally:
            stop.set()
