"""The yardstick on the CPU: the end-to-end metrics from step times, the
FLOPs a frame against pjreddie's published totals, the bound arithmetic
against the kernel table of ``PERF.md`` section 6, the trace reduction,
and the comparison numbers."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import check, flops, roofline, run, trace

BASE = Path(__file__).resolve().parents[1]


def metric(name, r):
    return run.load_module("metrics", name).read(r)


def stepped(ms):
    """A Run of steps of ``ms`` milliseconds, 256 frames each, back to
    back."""
    return run.Run(frames=256 * len(ms), window_s=sum(ms) / 1e3,
                   step_ms=list(ms), setup_s=12.5, trace=None)


def test_steady_steps():
    r = stepped([10.0] * 200)
    assert metric("frames_per_s", r) == pytest.approx(25600.0)
    assert metric("step_ms_p95", r) == pytest.approx(10.0)
    assert metric("setup_s", r) == 12.5


def test_a_long_stall_moves_both():
    """A stall of the host of 0.6 s that holds back 20 consecutive steps
    of 200 (30 ms more each) lowers the rate and raises the tail."""
    base = stepped([10.0] * 200)
    ms = [10.0] * 200
    ms[50:70] = [40.0] * 20
    stalled = stepped(ms)
    assert metric("frames_per_s", stalled) < 0.8 * metric("frames_per_s",
                                                          base)
    assert metric("step_ms_p95", stalled) == pytest.approx(40.0)


def test_one_stalled_step_moves_the_rate_not_the_tail():
    """A tail of 200 steps' has 10 beyond it: one stalled step of 500 ms
    lowers the rate (the window holds it) and leaves the 95th
    percentile, which the step times of the other 199 set."""
    ms = [10.0] * 200
    ms[99] = 500.0
    r = stepped(ms)
    assert metric("frames_per_s", r) < 0.85 * 25600
    assert metric("step_ms_p95", r) == pytest.approx(10.0)


def cfg_blocks(name):
    return json.loads((BASE / "configs" / f"{name}.json").read_text())


def tiny_blocks(classes):
    """The tiny configuration's blocks with ``classes`` classes."""
    blocks = json.loads(json.dumps(cfg_blocks("millieye-tiny416")["blocks"]))
    for b in blocks:
        if b["type"] == "yolo":
            b["classes"] = str(classes)
        if b["type"] == "convolutional" and b["activation"] == "linear":
            b["filters"] = str(3 * (classes + 5))
    return blocks


def test_yolov3_flops_match_pjreddie():
    """pjreddie's table gives YOLOv3-416 65.86 Bn FLOPs: the convolutions
    of the 107 blocks, 2 a multiply-add, count 65.864 Bn (the table
    rounds to two places)."""
    c = cfg_blocks("yolov3-d53-416")
    got = flops.darknet_flops(c["blocks"], 416)
    assert got == 65_864_075_264
    assert abs(got / 1e9 - 65.86) < 0.005


def test_tiny_flops_match_pjreddie_and_the_12_class_heads():
    """tiny-YOLOv3 at 80 classes: 5.56 Bn in pjreddie's table, 5.565 Bn
    counted (rounding). The 12-class heads (51 outputs a scale instead
    of 255) take 0.106 Bn off: 5.459 Bn a frame through the Darknet; the
    fusion heads add 0.360 Bn at mode 0 (score map 0.170, radar encoder
    0.128, 232 RoI slots of refinement 0.062)."""
    assert flops.darknet_flops(tiny_blocks(80), 416) == 5_564_961_792
    c = cfg_blocks("millieye-tiny416")
    twelve = flops.darknet_flops(c["blocks"], 416)
    assert twelve == 5_459_051_520
    assert (flops.darknet_flops(tiny_blocks(80), 416) - twelve) / 1e9 == \
        pytest.approx(0.10591, abs=1e-5)
    heads = flops.head_flops(c["heads"], 416)
    assert heads == pytest.approx(0.3597e9, rel=1e-3)
    assert flops.frame_flops(c, 0) == twelve + heads
    assert flops.frame_flops(c, 1) == twelve


# (op, input shapes, dtypes, concrete inputs, batch) -> the bound column
# of PERF.md section 6 in ms, "b1 / b32"
TABLE = [
    ("stem_pair", lambda b: [[b, 416, 416, 3], [16, 3, 3, 3], [16],
                             [32, 16, 3, 3], [32], [], [], []],
     ["float", "float", "float", "float", "float", "", "", ""],
     [None] * 6 + [5, None], (0.000830, 0.026452)),
    ("stem_stage", lambda b: [[b, 104, 104, 32], [64, 32, 3, 3], [64], [],
                              []],
     ["float", "float", "float", "", ""], [None] * 4 + [5],
     (0.000539, 0.016553)),
    ("ps_roi_align", lambda b: [[b, 26, 26, 896], [b, 96, 7, 26],
                                [b, 96, 7, 26], []],
     ["c10::BFloat16"] * 3 + [""], [None] * 3 + [10], (0.000275, 0.008793)),
    ("roi_align", lambda b: [[b, 26, 26, 10], [b, 96, 7, 26],
                             [b, 96, 7, 26], []],
     ["c10::BFloat16"] * 3 + [""], [None] * 4, (0.000081, 0.002594)),
]


@pytest.mark.parametrize("op,shapes,dtypes,concrete,want", TABLE,
                         ids=[t[0] for t in TABLE])
def test_bounds_match_the_kernel_table(op, shapes, dtypes, concrete, want):
    for b, ms in zip((1, 32), want):
        got = roofline.launch_bound_s(op, shapes(b), dtypes, concrete) * 1e3
        assert got == pytest.approx(ms, rel=2e-3, abs=1e-6)


def test_nms_bound_matches_the_serving_rows():
    """K1 at K = 512 "serving" (valid a prefix of 26 rows, 27 rows up to
    the last valid one read): 2 B a row + 16 B a live row, the table's
    4.35e-07 / 1.39e-05 ms; from shapes alone every row counts live."""
    for b, ms in ((1, 4.35e-07), (32, 1.39e-05)):
        t, what = roofline.bound_s(2 * b * 512 + 16 * 27 * b, 0,
                                   roofline.F32_FLOP_S)
        assert (t * 1e3, what) == (pytest.approx(ms, rel=1e-2), "bytes")
    assert roofline.launch_bound_s("nms", [[1, 512, 4], [1, 512], []]) \
        == pytest.approx(18 * 512 / roofline.HBM_BYTES_S)


def test_an_op_without_a_rule_counts_its_inputs():
    got = roofline.launch_bound_s("some_new_kernel", [[4, 8], [8], []],
                                  ["float", "c10::Half", ""])
    assert got == pytest.approx((32 * 4 + 8 * 2) / roofline.HBM_BYTES_S)


def ev(name, start, end, device=False, kernels_us=0.0, children=(),
       shapes=None):
    from torch.autograd import DeviceType
    e = SimpleNamespace(
        name=name, time_range=SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        device_time_total=kernels_us, cpu_children=list(children),
        cpu_parent=None, input_shapes=shapes, input_dtypes=None,
        concrete_inputs=None)
    for c in children:
        c.cpu_parent = e
    return e


def test_trace_reduction():
    """Two steps of 100 us: spans, busy time, the port's ops, the idle
    gaps by what the host ran."""
    op = ev("millieye::nms", 40, 50, kernels_us=8.0,
            shapes=[[1, 512, 4], [1, 512], []])
    inner = ev("millieye::nms", 41, 49, kernels_us=8.0)
    op.cpu_children.append(inner)
    inner.cpu_parent = op
    idx = ev("aten::index", 5, 30)
    events = [
        ev("perfbench.ingest", 0, 30, kernels_us=10.0, children=[idx]),
        idx,
        ev("perfbench.forward", 30, 90, kernels_us=40.0, children=[op]),
        op, inner,
        ev("perfbench.copy", 90, 100),
        ev("perfbench.ingest", 100, 130, kernels_us=10.0),
        ev("perfbench.forward", 130, 190, kernels_us=40.0),
        ev("perfbench.copy", 190, 200),
        ev("k1", 20, 30, device=True), ev("k2", 40, 80, device=True),
        ev("k1", 120, 130, device=True), ev("k2", 140, 180, device=True),
    ]
    tr = trace.reduce(events, 2)
    assert (tr.window_us, tr.busy_us) == (200, 100)
    assert tr.spans["forward"] == [(60, 40.0), (60, 40.0)]
    assert [o[0] for o in tr.ops] == ["nms"]          # the outermost only
    assert tr.device_ops == [["k2", 80e-6], ["k1", 20e-6]]
    gaps = dict(tr.idle_gaps)
    assert gaps["ingest/aten::index"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(100e-6)
    r = run.Run(trace=tr, frames=2, window_s=1.0, flops_per_frame=1e12,
                peak_flop_s=1e14)
    assert metric("device.idle_share", r) == pytest.approx(50.0)
    assert metric("forward.device_ms", r) == pytest.approx(0.04)
    assert metric("host.dispatch_ms", r) == pytest.approx(0.06)
    assert metric("kernels.device_ms", r) == pytest.approx(0.004)
    assert metric("step.mfu", r) == pytest.approx(2.0)
    share = metric("kernels_roofline", r)
    assert share == pytest.approx(100 * 18 * 512 / roofline.HBM_BYTES_S
                                  / 8e-6)


def test_a_reader_with_nothing_to_read_returns_nothing():
    r = run.Run(trace=None, frames=0, window_s=0.0, step_ms=[])
    for name in ("host.dispatch_ms", "ingest.device_ms", "forward.device_ms",
                 "kernels.device_ms", "kernels_roofline",
                 "device.idle_share", "step.mfu", "frames_per_s",
                 "step_ms_p95"):
        assert metric(name, r) is None, name


def test_row_numbers():
    """A row the reference explains reads its distance in units of 1% of
    the box or 0.01 of a score; a kept row the program leaves out counts
    as missing, and a row the program answers that the reference does not
    keep counts as extra."""
    from perfbench.reference.fusion import Scene
    cand = torch.tensor([[0, 0, 20, 20, .9, .8], [50, 50, 90, 90, .6, .5],
                         [52, 50, 90, 91, .3, .5]])
    scene = Scene(cand, cand[:2])
    got = torch.tensor([[0.3, 0, 20, 20, .9, .8]])
    n = check.row_numbers([(got, 0)], {0: scene})
    assert n == {"row_gap": pytest.approx(1.5), "row_mean": pytest.approx(1.5),
                 "rows_missing": 0.5, "rows_extra": 0.0}
    # beyond MATCH (2 units) a kept row counts as not reproduced, and the
    # row answered as extra
    far = torch.tensor([[0.5, 0, 20, 20, .9, .8]])
    n = check.row_numbers([(far, 0)], {0: scene})
    assert n["rows_missing"] == 1.0 and n["rows_extra"] == 1.0
    # no suppression: the candidate NMS drops is answered beside the kept
    n = check.row_numbers([(cand, 0)], {0: scene})
    assert n["row_gap"] == 0.0 and n["rows_missing"] == 0.0
    assert n["rows_extra"] == pytest.approx(1 / 3)
    # rows answered where the reference keeps none are all extra
    n = check.row_numbers([(cand, 0)], {0: Scene(cand, cand[:0])})
    assert n["rows_extra"] == 1.0 and n["rows_missing"] == 0.0
    shifted = cand[:1] + torch.tensor([30.0, 0, 0, 0, 0, 0])
    assert check.row_numbers([(shifted, 0)], {0: scene})["row_gap"] == \
        pytest.approx(150.0)
    # a score 0.05 off weighs 5 units, as 5% of the box would
    off = torch.tensor([[0, 0, 20, 20, .85, .8]])
    assert check.row_numbers([(off, 0)], {0: scene})["row_gap"] == \
        pytest.approx(5.0)
    # a box far beyond the frame: its own size scales its coordinates
    huge = torch.tensor([[-5e5, -5e5, 5e5, 5e5, .7, .6]])
    near = huge + torch.tensor([10.0, 0, 0, 0, 0, 0])
    assert check.row_numbers([(near, 0)], {0: Scene(huge, huge)}) == {
        "row_gap": pytest.approx(1e-3), "row_mean": pytest.approx(1e-3),
        "rows_missing": 0.0, "rows_extra": 0.0}
    ok, lines = check.judge({"a": 1.0, "b": float("nan")}, {"a": 1.0,
                                                            "b": 1.0})
    assert not ok and lines[0] == ("a", 1.0, 1.0)
    assert check.judge({"a": 1.0, "c": 9.0}, {"a": 1.0}) == (
        True, [("a", 1.0, 1.0)])
    assert not check.judge({"a": 1.0}, {})[0]
    assert not check.judge({}, {"a": 1.0})[0]


def test_rounding_of_the_control():
    from perfbench.reference import precision
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -3.0, 0.0])
    assert precision.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, -3.0, 0.0]
    y = torch.tensor([448.0, 1.0, -224.0])
    assert precision.fp8(y).tolist() == [448.0, 1.0, -224.0]
    z = torch.tensor([1.0, 1.06])
    assert precision.fp8(z * 100).tolist() == pytest.approx([100.0, 104.0],
                                                            rel=0.05)
    c = precision.Precision.control({"backbone": "bfloat16",
                                     "maps": "float32"})
    assert c.parts == {"backbone": "fp8", "maps": "tf32"}
    assert np.isfinite(c(torch.randn(100) * 1e4, "backbone").numpy()).all()
