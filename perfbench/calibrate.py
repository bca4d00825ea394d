"""The readings the limits of ``correct`` are set from: for each seed, the
program's numbers over a stretch of the cell's own steps that keeps as
many steps for the check as a run does (the lower reading is their
largest), and the control's (the reference at the precision one step
below the configuration's, answering in the program's place; the upper
reading is their smallest); and, with ``--faults``, the program's
numbers with each fault of ``perfbench/faults.py`` planted.

    python3 -m perfbench.calibrate --workload <name> --seeds 1,2,3
        [--control 1,2,3] [--faults 1,2,3] [--steps N]
        [--config <name> --traffic <name>]

``--config`` and ``--traffic`` name a cell's configuration and mix where
BENCHMARK.json does not list the cell yet. One JSON line a seed on
standard output. Not run by the benchmark's own runs."""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from perfbench import run


def readings(workload, seed, steps, control, base=run.BASE, root=run.ROOT,
             device="cuda", fault=None, entry=None):
    """{"program": numbers[, "control": numbers]} of one seed; with
    ``fault``, the program runs with that fault planted. ``steps``: the
    steps run after the warm-up (None: the kept steps and 8 more);
    ``entry``: the cell's BENCHMARK.json entry where the file lacks
    it."""
    import torch
    from perfbench.reference.precision import Precision
    bench = run.load_json(root / "BENCHMARK.json")
    if entry is not None:
        bench["workloads"].append(entry)
    _, wl, config, mix = run.cell(bench, workload, base)
    n = int(wl["check_steps"])
    steps = n + 8 if steps is None else steps
    mod = run.load_module("drivers", wl["driver"], base)
    drv = mod.Driver(config, mix, seed, device)
    with mod.plant(fault) if fault else contextlib.nullcontext():
        drv.setup()
        drv.keep = {run.WARM_STEPS + int(s) for s in np.random.default_rng(
            [seed, 1]).choice(steps, size=min(n, steps), replace=False)}
        for _ in range(run.WARM_STEPS + steps):
            drv.step()
        if device == "cuda":
            torch.cuda.synchronize()
    drv.free()
    out = {"program": drv.check()}
    if control:
        out["control"] = drv.check(prec=Precision.control(
            config["precision"]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--config")
    p.add_argument("--traffic")
    args = p.parse_args(argv)
    run.cache_env(run.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    from perfbench import faults
    entry = None
    if args.config:
        entry = {"name": args.workload, "config": args.config,
                 "traffic": args.traffic, "chips": 1}
    ctl = {int(s) for s in args.control.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        r = readings(args.workload, s, args.steps, s in ctl, entry=entry)
        print(json.dumps({"workload": args.workload, "seed": s,
                          "seconds": time.perf_counter() - t, **r}),
              flush=True)
    for s in [int(s) for s in args.faults.split(",") if s]:
        for fault in sorted(faults.FAULTS):
            t = time.perf_counter()
            r = readings(args.workload, s, args.steps, False, fault=fault,
                         entry=entry)
            print(json.dumps({"workload": args.workload, "seed": s,
                              "fault": fault,
                              "seconds": time.perf_counter() - t, **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
