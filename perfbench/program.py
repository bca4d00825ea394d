"""The program's own spans and counters (``millieye_torch/runtime/
profiler.py``) as the benchmark reads them.

``counters(run)``: the counters that the traced stretch kept, read from
the program once a run and shared by the metric readers that use them;
None for a program without counters. ``reduce(events, steps)``: from a
profiler trace, each ``millieye.`` span's host, device and self device
time (self: less the ``millieye.`` spans nested in it), and the CUDA
runtime's synchronising calls a step by where they sit: the reduction
that ``perfbench/trace.py:reduce`` would take on to read the program's
layers as per-layer metrics. Run as a module, a diagnostic of one cell:

    python3 -m perfbench.program --workload <name> --seed <n> [--steps 30]

sets the cell up as ``perfbench.run`` does, traces ``--steps`` steps
after the warm-up and prints one line of JSON: the program's spans and
counters, the synchronising calls, the benchmark's own readings of the
same trace, and the convolutions (input and weight shapes) under which
the kernels named by ``--kernels`` ran.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

PREFIX = "millieye."
BENCH_PREFIX = "perfbench."
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def counters(run):
    """{name: total} of the program's counters over the traced stretch,
    or None: no trace, or a program that keeps no counters."""
    if not run.trace:
        return None
    if "program_counters" not in run.__dict__:
        try:
            from millieye_torch.runtime.profiler import counters as read
        except ImportError:
            read = None
        run.program_counters = read() if read else None
    return run.program_counters


def _nested_device_us(e):
    """Device time of the outermost program spans nested in ``e``."""
    total, todo = 0.0, list(e.cpu_children)
    while todo:
        c = todo.pop()
        if c.name.startswith(PREFIX):
            total += c.device_time_total
        else:
            todo.extend(c.cpu_children)
    return total


def _where(e):
    """The innermost benchmark span, the innermost program span and the
    operation around ``e``, joined by '/'."""
    bench = prog = None
    op = e.cpu_parent.name if e.cpu_parent is not None else None
    p = e.cpu_parent
    while p is not None:
        if prog is None and p.name.startswith(PREFIX):
            prog = p.name
        if bench is None and p.name.startswith(BENCH_PREFIX):
            bench = p.name[len(BENCH_PREFIX):]
        p = p.cpu_parent
    parts = [bench or "between steps", prog, op]
    return "/".join(dict.fromkeys(x for x in parts if x is not None))


def reduce(events, steps):
    """(spans, syncs): ``spans[name]`` = [(host us, device us, self
    device us)] one for each ``millieye.<name>`` range on the host's row;
    ``syncs`` = {where: synchronising runtime calls a step}."""
    from torch.autograd import DeviceType
    spans, syncs = {}, {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith(PREFIX):
            dev = e.device_time_total
            spans.setdefault(e.name[len(PREFIX):], []).append(
                (e.time_range.elapsed_us(), dev, dev - _nested_device_us(e)))
        elif e.name in SYNCS:
            w = _where(e)
            syncs[w] = syncs.get(w, 0) + 1
    return spans, {w: n / steps for w, n in syncs.items()}


def call_sites(events, patterns, steps):
    """{pattern: [[conv2d input and weight shapes, launches a step, device
    ms a step]]}: the kernels whose name holds ``pattern``, by the
    convolution that launched them (None: not under a convolution)."""
    from torch.autograd import DeviceType
    out = {pat: {} for pat in patterns}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        conv = e
        while conv is not None and conv.name != "aten::conv2d":
            conv = conv.cpu_parent
        site = (json.dumps(conv.input_shapes[:2]) if conv is not None
                else None)
        for k in e.kernels:
            for pat in patterns:
                if pat in k.name:
                    n, us = out[pat].get(site, (0, 0.0))
                    out[pat][site] = (n + 1, us + k.duration)
    return {pat: sorted(([s, n / steps, us / steps / 1e3]
                         for s, (n, us) in sites.items()),
                        key=lambda r: -r[2])
            for pat, sites in out.items()}


def per_step_ms(spans, steps):
    """{name: each column of the span's rows, in ms a step}."""
    return {name: [sum(col) / steps / 1e3 for col in zip(*rows)]
            for name, rows in spans.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--kernels", default="nchwToNhwc,nhwcToNchw,fft")
    args = p.parse_args(argv)

    from perfbench import run, trace
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, workload, config, mix = run.cell(bench, args.workload)
    run.cache_env(run.ROOT)
    os.chdir(run.ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.set_num_threads(1)
    drv = run.load_module("drivers", workload["driver"]).Driver(
        config, mix, args.seed, "cuda")
    drv.setup()
    for _ in range(run.WARM_STEPS):
        drv.step()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(args.steps):
            drv.step()
        torch.cuda.synchronize()
    events = prof.events()
    tr = trace.reduce(events, args.steps)
    spans, syncs = reduce(events, args.steps)
    result = {
        "steps": args.steps,
        "program_spans_ms": per_step_ms(spans, args.steps),
        "counters": counters(run.Run(trace=tr)),
        "syncs": syncs,
        "bench_spans_ms": per_step_ms(tr.spans, args.steps),
        "idle_share": 100.0 * (1.0 - tr.busy_us / tr.window_us),
        "kernels_ms": sum(op[4] for op in tr.ops) / args.steps / 1e3,
        "idle_gaps": tr.idle_gaps,
        "device_ops": tr.device_ops,
        "call_sites": call_sites(events, args.kernels.split(","),
                                 args.steps)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
