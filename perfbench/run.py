"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json``
names its configuration and traffic; ``perfbench/workloads/<name>.json``
its driver (``perfbench/drivers/<driver>.py``), the steps whose answers
are compared and the limits of the comparison;
``perfbench/configs/<config>.json`` and ``perfbench/traffic/
<traffic>.json`` the model and the mix. Each metric is read by
``perfbench/metrics/<metric>.py``.

Set-up (weights, the pool on the card, a warm-up of the cell's shapes)
runs from process start to the first timed step; then steps run for
``--seconds``, one batch in flight; with ``--trace 1`` a bounded stretch
of steps after the window runs under the profiler. Once the window has
closed and the peak memory has been read, the program's state is freed
and the kept answers are held against the plain reference
(``perfbench/check.py``). The last line of standard output is the
result; the last lines of standard error the numbers compared, each
with its limit.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "millieye_tpu")
WARM_STEPS = 3
TRACE_TARGET_S = 1.0        # the traced stretch: about this long
TRACE_STEPS = (2, 30)       # and within these many steps


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cache_env(root):
    """Every build and kernel cache of the program at a fixed directory
    inside the checkout, so only a checkout's first run builds."""
    build = Path(root) / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind, name, base=BASE):
    """``perfbench/<kind>/<name>.py`` as a module, found by name."""
    import importlib.util
    path = Path(base) / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"perfbench: no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench, name, base=BASE):
    """(BENCHMARK.json entry, workload file, config file, traffic file)
    of the cell ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"perfbench: no workload named {name!r}")
    base = Path(base)
    return (entry, load_json(base / "workloads" / f"{name}.json"),
            load_json(base / "configs" / f"{entry['config']}.json"),
            load_json(base / "traffic" / f"{entry['traffic']}.json"))


def metrics_of(bench, name, traced):
    """The metric entries this cell reports: its per-layer metrics when
    traced, else its end-to-end ones."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_info(torch, chips):
    """The cards this run uses: name, count, and the power limit
    ``nvidia-smi`` reads (None where it cannot)."""
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"platform": "gpu", "kind": name, "count": chips,
            "power_limit": out[0].split(",")[-1].strip() if out else None}


class Run:
    """What one run measured, for the metric readers: ``setup_s``,
    ``window_s``, ``frames``, ``step_ms`` (one per timed step, CUDA
    events from the batch fetch to the rows on the host), ``trace`` (a
    ``perfbench.trace.Trace`` or None), and ``flops_per_frame`` and
    ``peak_flop_s`` of the configuration."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def window(torch, driver, seconds, cuda=True):
    """Steps for ``seconds``: (window seconds, frames, step ms list). On
    the card each step is timed by CUDA events; elsewhere (the CPU tests)
    by the host's clock."""
    times = []
    frames = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            frames += driver.step()
            b.record()
            times.append((a, b))
        else:
            t = time.perf_counter()
            frames += driver.step()
            times.append((time.perf_counter() - t) * 1e3)
    if cuda:
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in times]
    return time.perf_counter() - t0, frames, times


def main(argv=None, base=BASE, root=ROOT, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(Path(root) / "BENCHMARK.json")
    entry, workload, config, mix = cell(bench, args.workload, base)
    cache_env(root)
    os.chdir(root)
    import torch
    from perfbench import check, flops
    from perfbench.roofline import PEAKS
    # the host only launches and copies: one thread, so the few CPU
    # operations of a step do not wake a pool on shared cores
    torch.set_num_threads(1)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < entry["chips"]:
            log(f"perfbench: the cell needs {entry['chips']} CUDA card(s); "
                f"this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        info = card_info(torch, entry["chips"])
        log(f"perfbench: {info['kind']} x{info['count']}, power.limit "
            f"{info['power_limit']}, torch {torch.__version__}")
    else:
        info = {"platform": device, "kind": device, "count": 1,
                "power_limit": None}

    t_ready = time.perf_counter()
    drv = load_module("drivers", workload["driver"], base).Driver(
        config, mix, args.seed, device)
    drv.setup()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(WARM_STEPS):
        t = time.perf_counter()
        drv.step()
        sync()
        warm.append(time.perf_counter() - t)
    warm_s = warm[-1]
    # what set-up made stays: collections in the window skip it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T0
    log("perfbench: set-up phases (s): imports and card "
        f"{t_ready - T0:.3f}, " + ", ".join(
            f"{k} {v:.3f}" for k, v in drv.phases.items())
        + ", warm-up steps " + " ".join(f"{w:.3f}" for w in warm))
    # the steps whose answers the check compares, drawn from the seed
    # among those the window is sure to reach
    reach = max(1, int(0.5 * args.seconds / max(warm_s, 1e-3)))
    n = min(int(workload["check_steps"]), reach)
    drv.keep = {WARM_STEPS + int(s) for s in np.random.default_rng(
        [args.seed, 1]).choice(reach, size=n, replace=False)}

    drv.answered = []
    window_s, frames, step_ms = window(torch, drv, args.seconds,
                                       device == "cuda")
    gc.unfreeze()
    failed = drv.failed()
    log(f"perfbench: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
        f"{len(step_ms)} steps, {frames} frames")

    tr = None
    if args.trace:
        from perfbench.trace import trace_steps
        step_s = window_s / max(len(step_ms), 1)
        n_tr = int(np.clip(round(TRACE_TARGET_S / step_s), *TRACE_STEPS))
        tr, red_s = trace_steps(drv.step, n_tr, sync)
        if tr is None:
            log("perfbench: the profiler kept no device record")
            return 3
        log(f"perfbench: traced {n_tr} steps, reduced in {red_s:.1f} s")
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    drv.free()
    t = time.perf_counter()
    numbers = drv.check()
    ok, lines = check.judge(numbers, workload["limits"])
    ok = ok and failed == 0 and bool(drv.kept)
    if failed or not drv.kept:
        log(f"perfbench: {failed} frames answered a number that is not "
            f"finite; {len(drv.kept)} steps kept for the check")
    log(f"perfbench: check {time.perf_counter() - t:.1f} s over "
        f"{sum(len(r[0]) for r in drv.kept.values())} frames of "
        f"{len(drv.kept)} steps")

    run = Run(setup_s=setup_s, window_s=window_s, frames=frames,
              step_ms=step_ms, trace=tr,
              flops_per_frame=flops.frame_flops(config, drv.mode),
              peak_flop_s=PEAKS[config["peak"]])
    metrics = {}
    for m in metrics_of(bench, args.workload, args.trace):
        value = load_module("metrics", m["name"], base).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {k: info[k] for k in ("platform", "kind", "count")}
    dev["memory_peak_bytes"] = int(peak)
    if tr is not None:
        dev["busy_s"] = tr.busy_us / 1e6
        dev["window_s"] = tr.window_us / 1e6
    result = {"correct": bool(ok), "attempted": frames, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in lines}
    # after the window, the check and the metric readers: whatever any of
    # them loaded into this process is there now
    found = forbidden_modules()
    if found:
        log(f"perfbench: the process holds {', '.join(found)}; no result")
        return 4
    for name, v, lim in lines:
        log(f"check {name} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
