"""A ``torch.profiler`` trace of a stretch of timed steps, reduced to what
the per-layer metrics read: the benchmark's own spans around its calls
into each layer (``perfbench.<name>`` ``record_function`` ranges), each
span's host time and the device time of the kernels launched inside it,
the launches of the port's kernels (the ``millieye::<name>`` custom ops)
with their recorded shapes, the device's busy time, and the breakdown:
the device operations that took most time and the idle gaps by what the
host was doing."""
from __future__ import annotations

import bisect
import time

SPAN_PREFIX = "perfbench."
OP_PREFIX = "millieye::"


class Trace:
    """``steps``: timed steps traced; ``window_us``: from the first
    span's start to the last span's end; ``busy_us``: the time in which
    an operation ran on the device; ``spans[name]``: [(host us, device
    us)] one for each occurrence; ``ops``: [(name, input shapes, input
    dtypes or None, concrete inputs or None, device us)] one for each
    outermost port-kernel op; ``device_ops`` and ``idle_gaps``: [[name,
    seconds]], at most 10 each."""

    def __init__(self, steps, window_us, busy_us, spans, ops, device_ops,
                 idle_gaps):
        self.steps, self.window_us, self.busy_us = steps, window_us, busy_us
        self.spans, self.ops = spans, ops
        self.device_ops, self.idle_gaps = device_ops, idle_gaps


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _outermost_op(e):
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith(OP_PREFIX):
            return False
        p = p.cpu_parent
    return True


def reduce(events, steps):
    """``events``: ``profile.events()`` of ``steps`` timed steps."""
    from torch.autograd import DeviceType
    dev, spans, ops = [], {}, []
    span_events = []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(SPAN_PREFIX):
                continue        # the spans' own ranges on the device's row
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith(SPAN_PREFIX):
            span_events.append(e)
            spans.setdefault(e.name[len(SPAN_PREFIX):], []).append(
                (e.time_range.elapsed_us(), e.device_time_total))
        elif e.name.startswith(OP_PREFIX) and _outermost_op(e):
            ops.append((e.name[len(OP_PREFIX):], e.input_shapes,
                        getattr(e, "input_dtypes", None),
                        getattr(e, "concrete_inputs", None),
                        e.device_time_total))
    if not span_events:
        return None
    lo = min(e.time_range.start for e in span_events)
    hi = max(e.time_range.end for e in span_events)
    merged = _merge([[a, b] for a, b, _ in dev if b > lo and a < hi])
    busy = sum(min(b, hi) - max(a, lo) for a, b in merged)
    totals = {}
    for a, b, name in dev:
        totals[name] = totals.get(name, 0.0) + (b - a)
    device_ops = [[n, t / 1e6] for n, t in
                  sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
    return Trace(steps, hi - lo, busy, spans, ops, device_ops,
                 _idle_gaps(merged, span_events, lo, hi))


def _idle_gaps(merged, span_events, lo, hi):
    """The device's idle time between ``lo`` and ``hi``, summed by what
    the host was doing at each gap's middle: the benchmark's span and its
    child op running then."""
    span_events = sorted(span_events, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in span_events]
    children = [sorted(e.cpu_children, key=lambda c: c.time_range.start)
                for e in span_events]
    child_starts = [[c.time_range.start for c in cs] for cs in children]
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    by_what = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        what = "between steps"
        if i >= 0 and span_events[i].time_range.end >= mid:
            what = span_events[i].name[len(SPAN_PREFIX):]
            j = bisect.bisect_right(child_starts[i], mid) - 1
            if j >= 0 and children[i][j].time_range.end >= mid:
                what += "/" + children[i][j].name
        by_what[what] = by_what.get(what, 0.0) + (b - a)
    return [[n, t / 1e6] for n, t in
            sorted(by_what.items(), key=lambda kv: -kv[1])[:10]]


def trace_steps(step, steps, sync, tries=3):
    """Run ``step()`` ``steps`` times under the profiler (CPU and CUDA
    activities, shapes recorded) and reduce the trace. The profiler may
    keep no device record of a short trace late in a long process: a
    trace without one is taken again, up to ``tries`` times. Returns
    (Trace or None, seconds the reduction took)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(steps):
                step()
            sync()
        t = time.perf_counter()
        tr = reduce(prof.events(), steps)
        if tr is not None and tr.busy_us > 0:
            return tr, time.perf_counter() - t
    return None, 0.0
