"""The benchmark's reading of the program's own spans and counters
(``perfbench/program.py``): the counters read once a run and shared by
the ``nms.*`` readers, nothing read from a program without counters, and
the reduction of ``millieye.`` spans, synchronising calls and kernel call
sites from a trace."""
from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import program
from perfbench.run import BASE, load_module

Kernel = namedtuple("Kernel", "name device duration")


def _ev(name, children=(), dev=0.0, kernels=(), shapes=()):
    e = SimpleNamespace(name=name, cpu_children=list(children),
                        device_time_total=dev, kernels=list(kernels),
                        input_shapes=list(shapes), cpu_parent=None,
                        device_type=DeviceType.CPU)
    e.time_range = SimpleNamespace(elapsed_us=lambda: 1.0)
    for c in children:
        c.cpu_parent = e
    return e


def _flat(e):
    return [e] + [x for c in e.cpu_children for x in _flat(c)]


def _pred(seed=3, b=2, a=300, classes=4):
    rng = np.random.default_rng(seed)
    pred = np.zeros((b, a, 5 + classes), np.float32)
    pred[..., :2] = rng.uniform(20, 90, (b, a, 2))
    pred[..., 2:4] = rng.uniform(5, 40, (b, a, 2))
    pred[..., 4] = rng.uniform(0, 1, (b, a))
    pred[..., 5:] = rng.uniform(0, 1, (b, a, classes))
    return torch.from_numpy(pred)


def test_the_nms_readers_share_one_read_of_the_counters():
    from millieye_torch.ops import nms
    from millieye_torch.runtime import profiler
    profiler.counters()
    pred = _pred()
    _, _, shifted, v, _ = nms._candidates(pred, 0.5, 256)
    keep = nms._keep_mask(shifted, v, 0.5)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]):
        nms.batched_nms(pred, 0.5, 0.5, max_det=20, pre_top_k=256)
    run = SimpleNamespace(trace=object())
    live = load_module("metrics", "nms.live_rows", BASE).read(run)
    kept = load_module("metrics", "nms.kept_share", BASE).read(run)
    assert live == int(v.sum()) / 2
    assert kept == 100.0 * int(keep.sum()) / int(v.sum())
    assert 0 < kept < 100
    assert profiler.counters() == {}


def test_no_trace_or_no_counters_reads_nothing(monkeypatch):
    from millieye_torch.runtime import profiler
    assert program.counters(SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(profiler, "counters")
    run = SimpleNamespace(trace=object())
    for name in ("nms.live_rows", "nms.kept_share"):
        assert load_module("metrics", name, BASE).read(run) is None


def test_self_time_leaves_out_nested_program_spans():
    inner = _ev("millieye.nms", [_ev("aten::sort", dev=2.0)], dev=2.0)
    outer = _ev("millieye.backbone",
                [_ev("aten::conv2d", [inner], dev=7.0),
                 _ev("aten::add", dev=1.0)], dev=10.0)
    spans, syncs = program.reduce(_flat(outer), steps=1)
    assert spans == {"backbone": [(1.0, 10.0, 8.0)],
                     "nms": [(1.0, 2.0, 2.0)]}
    assert syncs == {}


def test_syncs_are_named_by_span_and_operation_a_step():
    calls = [_ev("cudaStreamSynchronize") for _ in range(2)]
    step = _ev("perfbench.copy", [_ev("aten::copy_", calls[:1])])
    loop = _ev("perfbench.ingest", [_ev("millieye.ingest", [
        _ev("aten::to", calls[1:])])])
    bare = _ev("cudaDeviceSynchronize")
    _, syncs = program.reduce(_flat(step) + _flat(loop) + [bare], steps=2)
    assert syncs == {"copy/aten::copy_": 0.5,
                     "ingest/millieye.ingest/aten::to": 0.5,
                     "between steps": 0.5}


def test_call_sites_name_the_convolution():
    launch = _ev("aten::cudnn_convolution", kernels=[
        Kernel("nchwToNhwcKernel", 0, 3.0), Kernel("xmma_fprop", 0, 9.0)])
    conv = _ev("aten::conv2d", [_ev("aten::convolution", [launch])],
               shapes=[[8, 256, 52, 52], [128, 256, 1, 1], []])
    stray = _ev("aten::copy_", kernels=[Kernel("nhwcToNchwKernel", 0, 4.0)])
    sites = program.call_sites(_flat(conv) + [stray],
                               ["nchwToNhwc", "nhwcToNchw"], steps=2)
    assert sites == {
        "nchwToNhwc": [["[[8, 256, 52, 52], [128, 256, 1, 1]]", 0.5,
                        0.0015]],
        "nhwcToNchw": [[None, 0.5, 0.002]]}


def test_a_cpu_trace_of_the_program_fills_the_spans():
    from millieye_torch.models.darknet import Darknet
    from millieye_torch.models.zoo import tiny_yolov3_defs
    from millieye_torch.ops import nms
    model = Darknet(tiny_yolov3_defs(num_classes=4, img_size=64),
                    img_size=64)
    params, state = model.init(torch.Generator().manual_seed(0))
    images = torch.rand(1, 64, 64, 3)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with record_function("perfbench.forward"):
            out = model.apply(params, state, images)
            nms.batched_nms(out["detections"], 0.5, 0.5, max_det=20,
                            pre_top_k=128)
    spans, _ = program.reduce(prof.events(), steps=1)
    assert set(spans) == {"backbone", "nms"}
    assert all(len(rows) == 1 and rows[0][0] > 0
               for rows in spans.values())
