"""A small copy of the benchmark's tree for CPU runs of the harness: the
same files, the configurations at ``SIZE`` px, pools of a few scenes and
batches of a few frames, the real limits unless a test sets others."""
import json
import shutil
from pathlib import Path

import pytest
import torch

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent
SIZE = 128
# cells whose workload files are ready but which BENCHMARK.json does not
# list yet (PERF.md, Open questions): the small tree lists them, so the
# tests drive their driver and limits all the same
DORMANT_CONFIGS = [
    {"name": "millieye-tiny416",
     "source": "https://github.com/sxontheway/milliEye",
     "file": "perfbench/configs/millieye-tiny416.json", "reduced": [],
     "why": "the milliEye fusion detector"}]
DORMANT = [
    {"name": "tiny416-auto-dark-b256", "config": "millieye-tiny416",
     "traffic": "dark-b256", "chips": 1, "why": "dark frames: fusion"},
    {"name": "tiny416-auto-bright-b256", "config": "millieye-tiny416",
     "traffic": "bright-b256", "chips": 1,
     "why": "bright frames: the detector alone"}]


def with_dormant(bench):
    """``bench`` with the dormant cells and their configurations listed."""
    have = {c["name"] for c in bench["configs"]}
    bench["configs"] += [c for c in DORMANT_CONFIGS if c["name"] not in have]
    have = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [w for w in DORMANT if w["name"] not in have]
    return bench


def small_tree(dst, size=SIZE, limits=None):
    """``dst``/BENCHMARK.json and ``dst``/perfbench, cut small. Returns
    (root, base)."""
    base = dst / "perfbench"
    shutil.copytree(BASE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = with_dormant(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for c in bench["configs"]:
        path = base / "configs" / f"{c['name']}.json"
        cfg = json.loads(path.read_text())
        cfg["img_size"] = size
        cfg["blocks"][0]["height"] = cfg["blocks"][0]["width"] = str(size)
        if "weights" in cfg:
            cfg["weights"] = str(ROOT / cfg["weights"])
        path.write_text(json.dumps(cfg))
    for path in (base / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(pool=4, repeat=1, batch=4 if mix["batch"] > 8 else 2)
        path.write_text(json.dumps(mix))
    for path in (base / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        wl["check_steps"] = 2
        if limits is not None:
            wl["limits"] = dict(limits)
        path.write_text(json.dumps(wl))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst, base


def run_small(root, base, workload, seed=4_000_000_777, seconds=1.0,
              capsys=None):
    """``perfbench.run.main`` on the CPU: (exit code, result dict)."""
    import os
    from perfbench import run
    cwd = os.getcwd()
    try:
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      base=base, root=root, device="cpu")
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return rc, (json.loads(out[-1]) if out else None)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    yield
    torch.set_num_threads(prev)
