"""What the benchmark may import and read: nothing under ``perfbench/``
imports JAX or the JAX package (top-level module names compared whole:
the port's name begins with the JAX package's), the reference and the
traffic import nothing of the program, and no code reads the JAX
package's benchmark (``benchmarks/``, ``bench.py``, ``BENCH_*.json``)."""
import ast
from pathlib import Path

import pytest

BASE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "millieye_tpu"}
JAX_BENCH = ("benchmarks/", "bench.py", "BENCH_", "bench_baseline")


def modules():
    return sorted(p for p in BASE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def code_strings(path):
    """String constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_the_walk_finds_the_modules():
    names = {p.relative_to(BASE).as_posix() for p in modules()}
    assert {"run.py", "check.py", "reference/fusion.py",
            "traffic/scenes.py", "drivers/fusion_batch.py"} <= names


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(BASE)))
def test_no_jax(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize("path", [p for p in modules() if p.relative_to(
    BASE).parts[0] in ("reference", "traffic")],
    ids=lambda p: str(p.relative_to(BASE)))
def test_reference_and_traffic_stand_alone(path):
    assert "millieye_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", [p for p in modules() if p.relative_to(
    BASE).parts[0] != "tests"], ids=lambda p: str(p.relative_to(BASE)))
def test_nothing_reads_the_jax_benchmark(path):
    bad = [s for s in code_strings(path) if any(j in s for j in JAX_BENCH)]
    assert not bad, f"{path} names {bad}"


def test_the_guard_compares_whole_names(tmp_path):
    """The port's name begins with the JAX package's: a prefix test
    would flag it, the whole-name test does not."""
    f = tmp_path / "m.py"
    f.write_text("import millieye_torch.ops\nfrom millieye_tpu import x\n"
                 "import jax.numpy\n")
    assert top_level_imports(f) & FORBIDDEN == {"millieye_tpu", "jax"}


def test_a_late_import_of_jax_prints_no_result(tmp_path, monkeypatch,
                                               capsys):
    """The look for JAX in the process comes last, after the check and the
    metric readers: a reader that imports a forbidden module (here a
    stand-in name) leaves the run with no result and a code other than
    0."""
    import json
    import sys
    from conftest import small_tree
    from perfbench import run
    root, base = small_tree(tmp_path / "tree")
    (tmp_path / "standin_forbidden.py").write_text("X = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(run, "FORBIDDEN", run.FORBIDDEN
                        + ("standin_forbidden",))
    (base / "metrics" / "late_probe.py").write_text(
        "def read(run):\n"
        "    import standin_forbidden\n"
        "    return float(standin_forbidden.X)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "late_probe", "unit": "x",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["d53-416-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "standin_forbidden" not in sys.modules
    try:
        rc = run.main(["--workload", "d53-416-b8", "--seed", "5",
                       "--seconds", "0.5", "--trace", "0"], base=base,
                      root=root, device="cpu")
    finally:
        sys.modules.pop("standin_forbidden", None)
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out == ""
    assert "standin_forbidden" in captured.err
