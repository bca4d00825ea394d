"""The cell ``yolov4-608-b8`` on the CPU at a small size (``conftest.
small_tree``): it runs by name through its driver (``drivers/
yolov4_batch.py``) and its reference (``reference/yolov4.py``) and comes
out correct under its own limits; each planted fault and the control
come out false; and its two per-layer readers read the program's Mish
counters and the Mish launches of the epilogue op, and nothing where the
program has none."""
import json

import pytest
import torch

from conftest import run_small, small_tree
from perfbench import calibrate, check, faults, run

CELL = "yolov4-608-b8"
# the three heads decode 1,008 rows a frame at 128 px, enough for NMS to
# suppress some, so the no-suppression fault shows at this size too
SIZE = 128


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return small_tree(tmp_path_factory.mktemp("v4"), size=SIZE)


def _limits(base):
    return json.loads((base / "workloads" / f"{CELL}.json").read_text())[
        "limits"]


def test_the_cell_runs_correct(tree, capsys):
    rc, res = run_small(*tree, CELL, capsys=capsys)
    assert rc == 0
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(_limits(tree[1]))
    assert {"frames_per_s", "step_ms_p95", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_fails(tree, fault, capsys):
    drv = run.load_module("drivers", "yolov4_batch", tree[1])
    with drv.plant(fault):
        rc, res = run_small(*tree, CELL, capsys=capsys)
    assert rc == 0
    assert not res["correct"], res["checks"]


def test_the_control_fails(tree):
    """The reference with TF32-rounded operands in the program's place
    fails a limit; the program passes them, on the same steps."""
    root, base = tree
    torch.set_num_threads(4)
    r = calibrate.readings(CELL, 4_000_000_555, 2, True, base=base,
                           root=root, device="cpu")
    assert check.judge(r["program"], _limits(base))[0], r
    assert not check.judge(r["control"], _limits(base))[0], r


def _reader(name, base):
    return run.load_module("metrics", name, base)


def test_the_mish_share_reads_the_counters(tree, monkeypatch):
    share = _reader("backbone.mish_share", tree[1])
    counts = {"darknet.convs": 110, "darknet.epilogue": 110,
              "darknet.mish": 72, "darknet.epilogue_mish": 54}
    monkeypatch.setattr(share, "counters", lambda r: counts)
    assert share.read(run.Run(trace=object())) == 75.0
    counts.pop("darknet.mish")
    assert share.read(run.Run(trace=object())) is None


def test_the_mish_roofline_reads_only_mish_launches(tree):
    roof = _reader("epilogue.mish_roofline", tree[1])
    x = [8, 64, 152, 152]
    n = 8 * 64 * 152 * 152
    bn = [x, [64], [64], [64], [64], []]
    f32 = ["float"] * 5 + ["Scalar"]
    ops = [("conv_epilogue", bn, f32, [None] * 5 + [2], 1000.0),
           ("conv_epilogue", bn, f32, [None] * 5 + [1], 50.0),
           ("conv_epilogue", [x, [64], [], [], [], []],
            ["float", "float", "", "", "", "Scalar"], [None] * 5 + [2],
            1000.0),
           ("nms", [[8, 1024, 4]], None, None, 10.0)]
    tr = type("T", (), {"ops": ops})
    assert roof.launch_bytes(bn, f32) == 8 * n + 4 * 64 * 4
    want = 100 * (2 * 8 * n + 5 * 64 * 4) / 3.35e12 / 2e-3
    assert roof.read(run.Run(trace=tr)) == pytest.approx(want)
    # a 16-bit x widened to float32 by its vectors writes 4 bytes
    assert roof.launch_bytes(bn, ["c10::BFloat16"] + f32[1:]) == \
        6 * n + 4 * 64 * 4
    # torch 2.11 records no dtypes: the configuration's precision stands
    # in, 4 bytes under the float32 peak, else 2
    bare = [(o[0], o[1], None, o[3], o[4]) for o in ops]
    f32 = run.Run(trace=type("T", (), {"ops": bare}), peak_flop_s=67e12)
    assert roof.read(f32) == pytest.approx(want)
    bf16 = run.Run(trace=type("T", (), {"ops": bare}), peak_flop_s=989e12)
    assert roof.read(bf16) == pytest.approx(want / 2)
    # the op's old bool flag: True is leaky, never Mish
    old = [(o[0], o[1], o[2], [None] * 5 + [True], o[4]) for o in ops[:2]]
    assert roof.read(run.Run(trace=type("T", (), {"ops": old}))) is None
    assert roof.read(run.Run(trace=None)) is None
