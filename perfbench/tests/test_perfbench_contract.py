"""``BENCHMARK.json`` holds to the benchmark's format: the keys of each
entry, names, units, bounds and the files it names, and every cell
finds its workload, configuration, traffic, driver and metric files."""
import json
import re
from pathlib import Path

import pytest

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("perfbench/")
        assert json.loads(f.read_text())["name"] == c["name"]
        assert c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    assert {w["config"] for w in BENCH["workloads"]} == names


def test_workloads():
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        wl = json.loads((BASE / "workloads" / f"{w['name']}.json")
                        .read_text())
        assert (BASE / "drivers" / f"{wl['driver']}.py").is_file()
        assert (BASE / "traffic" / f"{w['traffic']}.json").is_file()
        assert wl["limits"], w["name"]


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("m", metrics(), ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert (BASE / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200


def test_every_cell_reports_enough():
    e2e = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) == len(set(e2e))
    names = [m["name"] for m in metrics()]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["per_layer"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert mine and any("mfu" in m["name"] for m in mine)
        assert len([m for m in BENCH["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]) >= 2


def test_dormant_cells_are_ready():
    """The cells PERF.md keeps for later (``conftest.DORMANT``) are
    complete files a later PR lists by entries alone: workload with the
    limits of every number the harness compares, configuration, traffic
    and driver."""
    from conftest import DORMANT, DORMANT_CONFIGS
    listed = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in DORMANT_CONFIGS + BENCH["configs"]}
    d53 = json.loads((BASE / "workloads" / "d53-416-b8.json").read_text())
    for w in DORMANT:
        assert w["name"] not in listed
        wl = json.loads((BASE / "workloads" / f"{w['name']}.json")
                        .read_text())
        assert (BASE / "drivers" / f"{wl['driver']}.py").is_file()
        assert (BASE / "traffic" / f"{w['traffic']}.json").is_file()
        cfg = ROOT / configs[w["config"]]["file"]
        assert json.loads(cfg.read_text())["name"] == w["config"]
        assert set(d53["limits"]) - {"row_gap"} <= set(wl["limits"])
