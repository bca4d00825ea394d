"""``correct`` comes out false when the timed path is broken underneath:
a run on the CPU at a small size (the harness's look for a card
skipped, the rest of the run as on the card), with each fault a cell can
have (``perfbench/faults.py``) planted where the program produces its
answer: half of the batch left out, an answer altered, and an NMS that
suppresses nothing. The unbroken run at the same size comes out true
under the same limits. The cells are those BENCHMARK.json lists and the
dormant ones (``conftest.DORMANT``)."""
import pytest
import torch

from conftest import DORMANT, run_small, small_tree
from perfbench import faults, run

CELLS = ["d53-416-b8"] + [w["name"] for w in DORMANT]
# Darknet-53 and the dark cell run at their own 416 px: at 128 px the
# detector's NMS suppresses almost nothing in either (Darknet-53's
# class-aware NMS among 1,008 anchors, a dark frame's few candidates),
# so no suppression would leave the answer as it is
SIZES = {"d53-416-b8": 416, "tiny416-auto-dark-b256": 416}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    made = {}

    def tree(cell):
        size = SIZES.get(cell, 128)
        if size not in made:
            made[size] = small_tree(tmp_path_factory.mktemp(f"s{size}"),
                                    size=size)
        return made[size]
    return tree


def driver_module(base, cell):
    import json
    wl = json.loads((base / "workloads" / f"{cell}.json").read_text())
    return run.load_module("drivers", wl["driver"], base)


@pytest.mark.parametrize("cell", CELLS)
def test_sound(trees, cell, capsys):
    rc, res = run_small(*trees(cell), cell, capsys=capsys)
    assert rc == 0
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault(trees, cell, fault, capsys):
    tree = trees(cell)
    with driver_module(tree[1], cell).plant(fault):
        rc, res = run_small(*tree, cell, capsys=capsys)
    assert rc == 0
    assert not res["correct"], res["checks"]


def test_planting_is_undone(trees):
    from millieye_torch.models import fusion
    from millieye_torch.ops import nms
    before = (nms.batched_nms, fusion.batched_nms,
              fusion.FusionNetwork.apply)
    for cell in CELLS:
        for fault in faults.FAULTS:
            with driver_module(trees(cell)[1], cell).plant(fault):
                pass
    assert (nms.batched_nms, fusion.batched_nms,
            fusion.FusionNetwork.apply) == before


def test_the_control_fails(trees):
    """The control (the reference one precision step below the
    configuration's, in the program's place) fails a number of each cell
    under its limits, at this size too."""
    import json
    from perfbench import calibrate, check
    for cell in CELLS:
        root, base = trees(cell)
        torch.set_num_threads(4)
        r = calibrate.readings(cell, 4_000_000_555, 2, True, base=base,
                               root=root, device="cpu")
        limits = json.loads((base / "workloads" / f"{cell}.json")
                            .read_text())["limits"]
        assert check.judge(r["program"], limits)[0], (cell, r)
        assert not check.judge(r["control"], limits)[0], (cell, r)
