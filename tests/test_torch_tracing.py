"""The port's spans and counters (``runtime/profiler.py``): nothing kept
with no profiler session on; under a CPU ``torch.profiler`` session each
layer's span (``millieye.ingest``, ``millieye.backbone``,
``millieye.heads``, ``millieye.nms``) encloses its own operations and no
other layer's; the NMS counters equal the keep mask's own sums; and the
benchmark's reduction of a trace reads the same with the spans in it."""
import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from millieye_torch.cli._common import build_fusion
from millieye_torch.data.device_cache import DeviceCache
from millieye_torch.data.loader import PaddedCollate
from millieye_torch.data.synthetic import SyntheticScenes
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.zoo import tiny_yolov3_defs
from millieye_torch.ops import nms
from millieye_torch.runtime import profiler
from millieye_torch.train.recipes import fusion_device_batch

torch.set_num_threads(1)

S = 64
LAYERS = ("millieye.ingest", "millieye.backbone", "millieye.heads",
          "millieye.nms")


@pytest.fixture(autouse=True)
def _no_counts():
    profiler.counters()
    yield
    profiler.counters()


def _session():
    return profile(activities=[ProfilerActivity.CPU], record_shapes=True)


def _ancestors(e):
    out = []
    p = e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _spans(events):
    return [e for e in events if e.name in LAYERS]


def _pred(seed=0, b=3, a=400, classes=4):
    rng = np.random.default_rng(seed)
    pred = np.zeros((b, a, 5 + classes), np.float32)
    pred[..., :2] = rng.uniform(20, 90, (b, a, 2))
    pred[..., 2:4] = rng.uniform(5, 40, (b, a, 2))
    pred[..., 4] = rng.uniform(0, 1, (b, a))
    pred[..., 5:] = rng.uniform(0, 1, (b, a, classes))
    return torch.from_numpy(pred)


def test_the_flag_the_spans_check_flips_in_a_session():
    """The spans and counters act on ``torch.autograd.profiler.
    _is_profiler_enabled``: if torch renamed it, they would switch off
    unseen."""
    assert autograd_profiler._is_profiler_enabled is False
    with _session():
        assert autograd_profiler._is_profiler_enabled is True
        assert profiler.trace_annotation("millieye.x") is not profiler._OFF
    assert autograd_profiler._is_profiler_enabled is False


def test_off_a_span_and_a_count_keep_nothing():
    span = profiler.trace_annotation("millieye.backbone")
    assert span is profiler._OFF
    with span:
        pass

    def launch():
        raise AssertionError("a count called its value with no session on")

    profiler.count("nms.live", launch)
    profiler.count("nms.frames", 8)
    nms.batched_nms(_pred(), 0.5, 0.5, max_det=20, pre_top_k=128)
    assert profiler.counters() == {}


def test_a_span_passes_the_body_error():
    with _session():
        with pytest.raises(KeyError, match="body"):
            with profiler.trace_annotation("millieye.x"):
                raise KeyError("body")


def test_backbone_encloses_its_convolutions_and_nms_sits_outside():
    model = Darknet(tiny_yolov3_defs(num_classes=4, img_size=S), img_size=S)
    params, state = model.init(torch.Generator().manual_seed(0))
    images = torch.rand(2, S, S, 3,
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode(), _session() as prof:
        out = model.apply(params, state, images)
        nms.batched_nms(out["detections"], 0.5, 0.5, max_det=20,
                        pre_top_k=128)
    events = prof.events()
    convs = [e for e in events if e.name == "aten::conv2d"]
    assert len(convs) == 13
    assert all("millieye.backbone" in _ancestors(e) for e in convs)
    spans = _spans(events)
    assert [e.name for e in spans] == ["millieye.backbone", "millieye.nms"]
    assert all(not any(a.startswith("millieye.") for a in _ancestors(e))
               for e in spans)
    # the spans are the program's: no kernel op's prefix, no user range
    assert not any(e.name.startswith("millieye::") for e in spans)
    assert not any(e.is_user_annotation for e in spans)


def test_counters_after_batched_nms_equal_the_keep_mask_sums():
    pred = _pred(seed=7)
    _, _, shifted, v, _ = nms._candidates(pred, 0.5, 256)
    keep = nms._keep_mask(shifted, v, 0.5)
    with torch.inference_mode(), _session():
        nms.batched_nms(pred, 0.5, 0.5, max_det=20, pre_top_k=256)
        nms.batched_nms(pred, 0.5, 0.5, max_det=20, pre_top_k=256)
    got = profiler.counters()
    assert got == {"nms.frames": 6, "nms.live": 2 * int(v.sum()),
                   "nms.kept": 2 * int(keep.sum())}
    assert 0 < got["nms.kept"] < got["nms.live"] < 6 * 256
    assert profiler.counters() == {}


def test_each_layer_spans_its_own_work_once_a_step():
    """One fusion step on the CPU, as the eval CLI runs it: the loader's
    gather and the radar rasterization under ``millieye.ingest``, then
    the backbone, its NMS and the heads, each a span of its own, none
    inside another."""
    ds = SyntheticScenes(4, seed=3, frame_hw=(48, 64))
    cache = DeviceCache.build(ds, PaddedCollate(
        img_size=S, max_targets=8, max_radar=32, max_points=64),
        device="cpu")
    model, params, state = build_fusion(None, "f32", img_size=S,
                                        device="cpu")
    with torch.inference_mode(), _session() as prof:
        with record_function("caller.step"):
            batch = fusion_device_batch(next(iter(cache.loader(2))), S,
                                        "cpu")
            out = model.apply(params, state, batch["images"],
                              batch["radar_maps"], batch["radar_boxes"],
                              batch["rmask"], mode=0)
    assert out["boxes"].shape[0] == 2
    events = prof.events()
    spans = _spans(events)
    assert [e.name for e in spans] == [
        "millieye.ingest", "millieye.ingest", "millieye.backbone",
        "millieye.nms", "millieye.heads"]
    for e in spans:
        assert [a for a in _ancestors(e) if a.startswith("millieye.")] == []
        assert "caller.step" in _ancestors(e)
    # every convolution is the backbone's or the heads' score-map stack's,
    # the candidates' sort is the NMS's
    owner = {}
    for e in events:
        if e.name in ("aten::conv2d", "aten::sort"):
            layer = [a for a in _ancestors(e) if a.startswith("millieye.")]
            owner.setdefault(e.name, set()).update(layer)
    assert owner == {"aten::conv2d": {"millieye.backbone", "millieye.heads"},
                     "aten::sort": {"millieye.nms"}}
    assert profiler.counters()["nms.frames"] == 2


def test_the_benchmark_reduction_reads_the_same_with_the_spans():
    """``perfbench/trace.py:reduce`` on a CPU trace with the program's
    spans under the benchmark's: the benchmark's spans, busy time, device
    operations and kernel ops read as they would without them, and the
    idle gaps name the program's span the host was in."""
    from perfbench.trace import reduce
    model = Darknet(tiny_yolov3_defs(num_classes=4, img_size=S), img_size=S)
    params, state = model.init(torch.Generator().manual_seed(0))
    images = torch.rand(2, S, S, 3,
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode(), _session() as prof:
        with record_function("perfbench.forward"):
            out = model.apply(params, state, images)
            nms.batched_nms(out["detections"], 0.5, 0.5, max_det=20,
                            pre_top_k=128)
    events = prof.events()
    tr = reduce(events, 1)
    assert set(tr.spans) == {"forward"} and len(tr.spans["forward"]) == 1
    assert tr.busy_us == 0 and tr.device_ops == []
    kernels = [e for e in events if e.name.startswith("millieye::")
               and not any(a.startswith("millieye::") for a in _ancestors(e))]
    assert len(tr.ops) == len(kernels) > 0
    gaps = dict(tr.idle_gaps)
    assert any(n.startswith("forward/millieye.") for n in gaps), gaps
