"""The harness finds a cell, a configuration, a traffic mix, a driver and
a metric by name from their files: a throwaway one of each, added as
files and entries, runs with no edit to a file that is there."""
import json

from conftest import run_small, small_tree

OPEN = {"row_gap": 1e9, "row_mean": 1e9, "rows_missing": 1.0,
        "map_gap": 1.0}


def test_a_throwaway_cell_runs_by_name(tmp_path, capsys):
    root, base = small_tree(tmp_path, limits=OPEN)
    cfg = json.loads((base / "configs" / "millieye-tiny416.json").read_text())
    cfg["name"] = "tiny-copy"
    (base / "configs" / "tiny-copy.json").write_text(json.dumps(cfg))
    (base / "traffic" / "few-dark.json").write_text(json.dumps(
        {"illumination": "L", "radar": True, "pool": 3, "repeat": 1,
         "batch": 3}))
    (base / "drivers" / "fusion_copy.py").write_text(
        (base / "drivers" / "fusion_batch.py").read_text())
    (base / "metrics" / "frames_total.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    (base / "workloads" / "throwaway-cell.json").write_text(json.dumps(
        {"driver": "fusion_copy", "check_steps": 1, "limits": OPEN}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-copy", "source": "x",
                             "file": "perfbench/configs/tiny-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "throwaway-cell",
                               "config": "tiny-copy", "traffic": "few-dark",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "frames_total", "unit": "frames",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res = run_small(root, base, "throwaway-cell", capsys=capsys)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["frames_total"]["value"] == res["attempted"] > 0
    assert res["attempted"] % 3 == 0
    # step_ms_p95 lists the cells that report it; this one is not among them
    assert {"frames_per_s", "setup_s"} <= set(res["metrics"])
    assert "step_ms_p95" not in res["metrics"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(OPEN)


def test_a_missing_name_is_refused(tmp_path, capsys):
    root, base = small_tree(tmp_path, limits=OPEN)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ghost", "config": "nowhere",
                               "traffic": "dark-b256", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "workloads" / "ghost.json").write_text(json.dumps(
        {"driver": "fusion_batch", "check_steps": 1, "limits": OPEN}))
    try:
        run_small(root, base, "ghost", capsys=capsys)
    except (SystemExit, FileNotFoundError):
        pass
    else:
        raise AssertionError("a cell with no configuration file ran")
    assert capsys.readouterr().out == ""


def test_no_card_no_result(tmp_path, capsys):
    """The measurement path never falls back to the CPU: without a card
    the run exits with another code than 0 and prints nothing."""
    from perfbench import run
    root, base = small_tree(tmp_path)
    import torch
    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "d53-416-b8", "--seed", "1", "--seconds",
                   "1", "--trace", "0"], base=base, root=root)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_throwaway_per_layer_metric_is_found_by_name(tmp_path):
    """A per-layer metric is a reader file and an entry: the traced run
    of the cells it lists reads it, and no other cell's."""
    from perfbench import run
    root, base = small_tree(tmp_path, limits=OPEN)
    (base / "metrics" / "copy.device_ms.py").write_text(
        "def read(run):\n"
        "    spans = run.trace.spans.get('copy') if run.trace else None\n"
        "    return sum(d for _, d in spans) / len(spans) / 1e3 "
        "if spans else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "copy.device_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "data", "moves": "frames_per_s",
                               "workloads": ["d53-416-b8"]})
    names = [m["name"] for m in run.metrics_of(bench, "d53-416-b8", True)]
    assert "copy.device_ms" in names
    assert "copy.device_ms" not in [m["name"] for m in run.metrics_of(
        bench, "tiny416-auto-dark-b256", True)]
    reader = run.load_module("metrics", "copy.device_ms", base)
    tr = type("T", (), {"spans": {"copy": [(10.0, 2000.0), (12.0, 4000.0)]}})
    assert reader.read(run.Run(trace=tr)) == 3.0
    assert reader.read(run.Run(trace=None)) is None
