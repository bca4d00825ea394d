"""Stage timing, spans and counters (port of
``millieye_tpu/runtime/profiler.py``).

``StageTimer`` gives per-stage FPS from smoothed wall times, as in the
JAX package. ``trace_annotation`` names a span of the program (a layer:
``millieye.ingest``, ``millieye.backbone``, ``millieye.heads``,
``millieye.nms``) and ``count`` adds to a counter at the same boundary.
Both act only while a ``torch.profiler`` session is on: a span is then a
range on the profiler's clock, in the trace that holds the kernels it
launched, and a count is kept on the device without a host sync until
``counters()`` reads it. With no session on, each costs one check of
the flag the profiler sets. The JAX package's ``device_trace`` (a trace
written to a file) has no counterpart: the caller that holds the
session writes or reduces its trace.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_counts = []    # (name, value): the process's one profiler session's counts


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


def trace_annotation(name):
    """A named span: a context manager that, while a profiler session is
    on, records ``name`` as a range on the host's row of the trace, with
    the operations it launches as its children. It is a function-scope
    record, not a user annotation, so the profiler draws no range of it
    on the device's row: a reader of the device's busy time counts only
    the kernels. With no session on, the shared no-op context. An error
    in the body propagates as it is."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def count(name, value):
    """Add ``value`` to the counter ``name`` while a profiler session is
    on; with none on, keep nothing. ``value`` is a host number, or a
    callable that returns one or a 0-d tensor (called only while a
    session is on, so an untraced call launches nothing). A device value
    is kept as the tensor, with no host sync, and never updated in
    place."""
    if _autograd_profiler._is_profiler_enabled:
        _counts.append((name, value() if callable(value) else value))


def counters():
    """{name: total} of the counts kept since the last read, and clears
    them: one host sync for all the device values."""
    if not _counts:
        return {}
    kept = _counts.copy()
    del _counts[:len(kept)]     # a count added meanwhile stays for later
    totals, dev = {}, {}
    for name, v in kept:
        if torch.is_tensor(v):
            dev.setdefault(name, []).append(v.double())
        else:
            totals[name] = totals.get(name, 0) + v
    if dev:
        sums = [torch.stack(vs).sum() for vs in dev.values()]
        at = sums[0].device
        for name, s in zip(dev, torch.stack([s.to(at) for s in sums])
                           .tolist()):
            totals[name] = totals.get(name, 0) + s
    return totals
