"""Stage timing and profiler hooks for the streaming runtime (port of
``millieye_tpu/runtime/profiler.py``).

``StageTimer`` gives per-stage FPS from smoothed wall times, as in the
JAX package. ``trace_annotation`` names a span in a ``torch.profiler``
trace, and ``device_trace`` records one (host and CUDA activity) into a
Chrome trace file.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class StageTimer:
    """Exponentially-smoothed per-stage wall time -> FPS.

    >>> t = StageTimer(("track", "preproc", "device", "post"))
    >>> with t("device"): run_step()
    >>> t.fps("device")
    """

    def __init__(self, stages=(), alpha=0.1):
        self.alpha = alpha
        self._ema = {s: None for s in stages}
        self._last = {}

    @contextlib.contextmanager
    def __call__(self, stage):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def add(self, stage, dt):
        prev = self._ema.get(stage)
        self._ema[stage] = dt if prev is None else (
            (1 - self.alpha) * prev + self.alpha * dt)
        self._last[stage] = dt

    def fps(self, stage):
        e = self._ema.get(stage)
        return 0.0 if not e else 1.0 / e

    def report(self):
        return {s: round(self.fps(s), 1) for s, e in self._ema.items()
                if e is not None}


@contextlib.contextmanager
def trace_annotation(name):
    """A named span in a ``torch.profiler`` trace.
    An error in the body propagates as it is."""
    with record_function(name):
        yield


@contextlib.contextmanager
def device_trace(logdir):
    """Record host and CUDA activity of the enclosed block into
    ``logdir/trace.json`` (Chrome trace format). Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
