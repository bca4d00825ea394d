"""Streaming demo pipeline: host producer -> bounded queue -> the
engine's step on the card (port of ``millieye_tpu/runtime/stream.py``).

A producer *thread* decodes frames, runs the radar chain (sync ->
projection -> DBSCAN -> Kalman/Hungarian tracker -> proposals, numpy on
the host) and packs fixed-shape arrays; a bounded queue with
drop-on-full (the live contract) or blocking puts (lossless replay)
hands them to the consumer, which runs ``FusionEngine.step_fn`` per
frame or ``batched_step_fn`` per window. Preprocessing (letterbox,
heatmap) happens on the device inside the step, so the queue carries a
uint8 frame and a few KB of radar arrays.

``run`` keeps up to ``inflight_depth`` frames in flight: the step returns
CUDA tensors without waiting for the card (its only host sync is the
fetch in ``drain_one``), so the next frames' host work and steps overlap
the oldest frame's completion. The producer stages each frame on the
card itself: a copy from pinned memory, enqueued without blocking on the
stream the consumer's steps run on, so a step is ordered after its
inputs' copies.
"""
from __future__ import annotations

import collections
import os
import queue
import threading
import time

import numpy as np
import torch

from millieye_torch.collection.prepare import iter_frames
from millieye_torch.collection.sync import (load_timestamps, load_pointcloud,
                                            match_frames)
from millieye_torch.radar.pipeline import RadarPipeline, RadarParams
from millieye_torch.runtime.profiler import StageTimer


class FrameSource:
    """Recorded-session frame iterator (video.mp4 through OpenCV or
    imageio when present, else a frames/*.jpg directory)."""

    def __init__(self, rec_dir):
        self.rec_dir = rec_dir

    def __iter__(self):
        return iter_frames(self.rec_dir)


class StreamingPipeline:
    """Producer thread (decode + radar tracking) -> bounded queue ->
    consumer step on the engine's device."""

    def __init__(self, engine, rec_dir, calib, params: RadarParams = None,
                 queue_size=3, mode=0, frames=None, drop_on_full=True):
        # drop_on_full=True is the LIVE contract (the reference demo's
        # queue of 3 with drop-on-full): a slow consumer costs freshness,
        # not latency. False = lossless per-frame replay (offline
        # processing must touch every frame; batched windows always
        # block).
        self.drop_on_full = drop_on_full
        self.engine = engine
        self.rec_dir = rec_dir
        # optional pre-decoded frames [(idx, array), ...]: bypasses video
        # or jpg decode
        self.frames = frames
        self.params = params or RadarParams()
        self.radar = RadarPipeline(calib, self.params)
        self.q = queue.Queue(maxsize=queue_size)
        self.timer = StageTimer(("track", "device", "e2e"))
        self.mode = mode
        self.dropped = 0
        self._stop = threading.Event()
        self._error = None

    def _put(self, item, drop_on_full):
        """Queue put that can't wedge the producer: drop-on-full never
        blocks (single producer); the lossless mode blocks with a timeout
        and rechecks the stop flag so an early consumer exit
        (``max_frames``) doesn't leave this thread parked on a full
        queue holding decoded frames."""
        if drop_on_full:
            if self.q.full():
                try:
                    self.q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass
            self.q.put(item)
            return True
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, frame, packed, stream):
        """Host arrays -> tensors on the engine's device. On the card each
        goes through pinned memory with a non-blocking copy on ``stream``
        (the consumer's), so this thread never waits for the card."""
        dev = self.engine.device
        arrays = (frame,) + tuple(packed)
        tensors = [torch.from_numpy(np.require(a, requirements="CW"))
                   for a in arrays]
        if dev.type == "cuda":
            with torch.cuda.stream(stream):
                tensors = [t.pin_memory().to(dev, non_blocking=True)
                           for t in tensors]
        return tensors[0], tuple(tensors[1:])

    # -------------------------------------------------------------- producer
    def _produce(self, device_stage=True, drop_on_full=None, stream=None):
        if drop_on_full is None:
            drop_on_full = self.drop_on_full
        p = self.params
        vtimes = load_timestamps(os.path.join(self.rec_dir, "timestamps.txt"))
        rtimes, rframes = load_pointcloud(
            os.path.join(self.rec_dir, "pointcloud.pkl"))
        matches = match_frames(vtimes, rtimes, p.num_nearest)
        overlay = []
        source = (self.frames if self.frames is not None
                  else FrameSource(self.rec_dir))
        for idx, frame in source:
            if idx >= len(matches) or self._stop.is_set():
                break
            with self.timer("track"):
                for ri in matches[idx]:
                    overlay.append(rframes[ri])
                overlay = overlay[-p.overlay_num:]
                pts = (np.concatenate(overlay, axis=1) if overlay
                       else np.zeros((4, 0)))
                out = self.radar.process(pts)
                packed = self.engine.pack_radar(out["points_uvzv"],
                                                out["proposals"])
                # mode 3 = per-frame auto selection on brightness,
                # decided while the frame is still on the host
                sel = self.mode
                if sel == 3:
                    sel = 0 if float(np.mean(frame)) < 0.1 * 255 else 1
                if device_stage:
                    frame, packed = self._stage(frame, packed, stream)
            item = (idx, frame, packed, sel)
            # drop-on-full back-pressure; batched windows instead block
            if not self._put(item, drop_on_full):
                return
        self._put(None, drop_on_full)

    def _start_producer(self, **kw):
        """The producer thread. An error in it ends the stream (the
        consumer gets the end mark) and is raised again by ``_finish``."""
        def target():
            try:
                self._produce(**kw)
            except Exception as e:          # handed to the consumer
                self._error = e
                self._put(None, kw.get("drop_on_full", self.drop_on_full))

        self._stop.clear()
        self._error = None
        t = threading.Thread(target=target, daemon=True)
        t.start()
        return t

    def _finish(self, thread):
        """Stop the producer and wait for it; raise its error, if any."""
        self._stop.set()
        thread.join()
        if self._error is not None:
            raise RuntimeError("the stream's producer failed") \
                from self._error

    # -------------------------------------------------------------- consumer
    def run(self, on_result=None, max_frames=None, inflight_depth=24):
        """Returns (n_frames, fps_report).

        Results are drained through an ``inflight_depth``-deep window:
        the step is asynchronous (it returns CUDA tensors before the card
        has finished), so the next frames' host work and steps overlap
        the oldest frame's completion instead of blocking per frame.
        """
        # builds and loads every kernel the step launches before the
        # producer starts
        self.engine.warmup(self.mode)
        stream = (torch.cuda.current_stream(self.engine.device)
                  if self.engine.device.type == "cuda" else None)
        producer = self._start_producer(stream=stream)

        inflight = collections.deque()
        n = 0
        t_start = time.perf_counter()

        def drain_one():
            nonlocal n
            idx, boxes, valid = inflight.popleft()
            with self.timer("device"):
                boxes = boxes.cpu().numpy()     # waits for the step
                valid = valid.cpu().numpy()
            if on_result is not None:
                on_result(idx, boxes, valid)
            n += 1

        try:
            while True:
                item = self.q.get()
                if item is None:
                    break
                idx, frame, (pts, pmask, rb, rmask), sel = item
                boxes, valid = self.engine.step_fn(sel)(frame, pts, pmask,
                                                        rb, rmask)
                inflight.append((idx, boxes, valid))
                if len(inflight) > inflight_depth:
                    drain_one()
                if max_frames and n + len(inflight) >= max_frames:
                    break
            while inflight:
                drain_one()
        finally:
            self._finish(producer)
        wall = time.perf_counter() - t_start
        report = dict(self.timer.report(), dropped=self.dropped,
                      e2e_fps=round(n / wall, 1) if wall else 0.0)
        return n, report

    # ------------------------------------------------------- batched windows
    def run_batched(self, window=128, on_result=None, max_frames=None,
                    staged=None):
        """Lossless throughput mode: frames accumulate into windows of
        ``window`` on the host; each window crosses to the device once
        (one stacked copy, one batched step, one result fetch) and runs
        the network at batch = window. Returns (n_frames, report) with
        dropped always 0.

        ``staged``: optional device-resident replay, an iterable of
        ``(frame_indices, device_input_tuple)`` windows already on the
        engine's device (the tuple layout the batched step takes). The
        producer and the per-window copy are skipped; the same
        step/fetch/result consumer path runs, which measures the
        pipeline's sustained device rate.
        """
        if self.mode == 3:
            raise ValueError("auto mode is per-frame; use run() or pick "
                             "a static mode for batched windows")
        step = self.engine.batched_step_fn(self.mode)
        dev = self.engine.device

        if staged is not None:
            staged = list(staged)
            step(*staged[0][1])[1].cpu()           # warm + barrier
            n = 0
            t_start = time.perf_counter()
            for idxs, tens in staged:
                with self.timer("device"):
                    boxes, valid = step(*tens)
                    boxes = boxes.cpu().numpy()    # fetch barrier
                    valid = valid.cpu().numpy()
                if on_result is not None:
                    for i, idx in enumerate(idxs):
                        on_result(idx, boxes[i], valid[i])
                n += len(idxs)
            wall = time.perf_counter() - t_start
            report = dict(self.timer.report(), dropped=0, window=window,
                          device_resident=True,
                          e2e_fps=round(n / wall, 1) if wall else 0.0)
            return n, report

        # warm the window's step before timing (fetch barrier)
        w, h = self.engine.frame_size
        warm = (np.zeros((window, h, w, 3), np.uint8),
                np.zeros((window, self.engine.max_points, 4), np.float32),
                np.zeros((window, self.engine.max_points), bool),
                np.zeros((window, self.engine.model.cfg.max_radar, 4),
                         np.float32),
                np.zeros((window, self.engine.model.cfg.max_radar), bool))
        step(*(torch.as_tensor(a, device=dev) for a in warm))[1].cpu()

        n = 0
        t_start = time.perf_counter()
        producer = self._start_producer(device_stage=False,
                                        drop_on_full=False)

        buf = []

        def flush():
            nonlocal n
            if not buf:
                return
            k = len(buf)
            idxs = [b[0] for b in buf]
            frames = np.stack([np.ascontiguousarray(b[1]) for b in buf])
            packed = [np.stack([b[2][j] for b in buf]) for j in range(4)]
            if k < window:                     # pad the tail window
                reps = window - k
                frames = np.concatenate([frames, np.repeat(
                    frames[-1:], reps, 0)])
                packed = [np.concatenate([p, np.repeat(p[-1:], reps, 0)])
                          for p in packed]
            with self.timer("device"):
                tens = [torch.from_numpy(a).to(dev)
                        for a in (frames, *packed)]
                boxes, valid = step(*tens)
                boxes = boxes.cpu().numpy()    # fetch barrier
                valid = valid.cpu().numpy()
            if on_result is not None:
                for i, idx in enumerate(idxs):
                    on_result(idx, boxes[i], valid[i])
            n += k
            buf.clear()

        try:
            while True:
                item = self.q.get()
                if item is None:
                    break
                buf.append(item)
                if len(buf) == window:
                    flush()
                if max_frames and n + len(buf) >= max_frames:
                    del buf[max(0, max_frames - n):]   # honor the cap
                    break
            flush()
        finally:
            self._finish(producer)             # unblock the producer
        wall = time.perf_counter() - t_start
        report = dict(self.timer.report(), dropped=self.dropped,
                      window=window,
                      e2e_fps=round(n / wall, 1) if wall else 0.0)
        return n, report
