"""YOLOv4 (``models/zoo.py:yolov4_defs``) through the port's Darknet runner
against the benchmark's plain reference (``perfbench/reference/
yolov4.py``) on the CPU, at 96 px, batch 2, on the reference's seeded
weights with batch norm calibrated on 8 images (the JAX package runs no
Mish, SPP or ``scale_x_y``). Also K14's Mish mode, the pools, the decode's
``scale_x_y``, the ``.cfg`` path, the benchmark's configuration file, the
activation check, the counters and the SPP span.

Tolerances:
* one block on the port's own inputs: weightless blocks (pools, routes,
  shortcuts, upsamples) exact; convolutions within 1e-6 of the block's
  largest output: the same convolution, then batch norm's affine step in
  another order (the port ``(x - mean) * rsqrt(var + eps) * gamma +
  beta``, the reference ``(x - mean) * (gamma / sqrt(var + eps)) +
  beta``), a few float32 ulps (measured 1.9e-7);
* the whole network: those ulps compound through 160 blocks of a
  random-weight network, whose calibrated batch norm scales a
  perturbation up a few percent a block: every block's output within
  2e-3 of its largest (measured 5.2e-4), boxes within 5e-3 relative
  (1.5e-3), scores within 2e-3 (3.4e-4).
"""
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from millieye_torch.cli._common import build_darknet
from millieye_torch.io.config import parse_model_config
from millieye_torch.models.darknet import Darknet, _maxpool, decode_yolo
from millieye_torch.models.zoo import (YOLOV4_ANCHORS, tiny_yolov3_defs,
                                       yolov4_defs)
from millieye_torch.ops import epilogue as epi
from perfbench.reference import darknet as ref_darknet
from perfbench.reference import yolov4 as ref

torch.set_num_threads(1)

S = 96
ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 12_345          # a seed past 32 signed bits, as the driver's


@pytest.fixture(scope="module")
def yolov4():
    """(layers, params, state, images, model, port params, port state)."""
    defs = yolov4_defs(80, S)
    layers = ref.plan(defs)
    params, state = ref.seeded_weights(layers, SEED, "cpu")
    images = torch.rand((8, S, S, 3),
                        generator=torch.Generator().manual_seed(3))
    ref.calibrate_bn(layers, params, state, images.permute(0, 3, 1, 2))
    model = Darknet(defs, img_size=S)
    return (layers, params, state, images[:2], model,
            [params.get(str(i), {}) for i in range(len(layers))],
            [state.get(str(i), {}) for i in range(len(layers))])


def _rel(got, want):
    return float((got - want).abs().amax() / want.abs().amax().clamp_min(
        1e-30))


def test_yolov4_defs_are_the_162_published_blocks():
    defs = yolov4_defs()
    body = defs[1:]
    assert len(body) == 162
    assert defs[0] == {"type": "net", "channels": "3", "height": "608",
                       "width": "608"}
    convs = [b for b in body if b["type"] == "convolutional"]
    assert len(convs) == 110
    assert [b["activation"] for b in body[:105]
            if b["type"] == "convolutional"] == ["mish"] * 72
    assert {b["activation"] for b in body[105:]
            if b["type"] == "convolutional"} == {"leaky", "linear"}
    assert [i for i, b in enumerate(body) if b["type"] == "yolo"] == [
        139, 150, 161]
    assert [body[i]["scale_x_y"] for i in (139, 150, 161)] == [
        "1.2", "1.1", "1.05"]
    assert [(body[i]["size"], body[i]["stride"]) for i in (108, 110, 112)] \
        == [("5", "1"), ("9", "1"), ("13", "1")]
    assert body[113]["layers"] == "-1,-3,-5,-6"
    assert [body[i]["layers"] for i in (9, 22, 53, 84, 103, 119, 129, 142,
                                        153)] == [
        "-1,-7", "-1,-10", "-1,-28", "-1,-28", "-1,-16", "85", "54",
        "-1,-16", "-1,-37"]
    assert body[139]["anchors"] == ",".join(
        f"{a},{b}" for a, b in YOLOV4_ANCHORS)
    model = Darknet(defs, img_size=608)
    assert [model._plan[i]["filters"] for i in (138, 149, 160)] == [255] * 3
    assert model._spp == {108: 113}
    assert model.act_int8_skip == (138, 149, 160)


def test_the_benchmark_configuration_holds_the_published_blocks():
    cfg = json.loads((ROOT / "perfbench" / "configs" / "yolov4-608.json")
                     .read_text())
    assert cfg["blocks"] == yolov4_defs(80, 608)
    assert cfg["reduced"] == [] and cfg["img_size"] == 608
    assert cfg["source"] == ("https://github.com/AlexeyAB/darknet/blob/"
                             "master/cfg/yolov4.cfg")


def test_port_holds_to_the_reference_block_by_block(yolov4):
    """Each block on the port's own outputs of the blocks before it (see
    the module's tolerances), and every shape."""
    layers, params, state, images, model, pp, ps = yolov4
    outs = model.apply(pp, ps, images, collect_outputs=True)["outputs"]
    x = images.permute(0, 3, 1, 2)
    checked = {}
    for i, info in enumerate(layers):
        if info["type"] == "yolo":
            continue
        want, _ = ref.block(i, info, outs[:i], x, params, state)
        assert outs[i].shape == want.shape, i
        if info["type"] == "convolutional":
            assert _rel(outs[i], want) <= 1e-6, i
        else:
            assert torch.equal(outs[i], want), i
        k = info.get("act", info["type"])
        checked[k] = checked.get(k, 0) + 1
    assert checked == {"mish": 72, "leaky": 35, "linear": 3, "route": 21,
                       "shortcut": 23, "maxpool": 3, "upsample": 2}


def test_port_holds_to_the_reference_end_to_end(yolov4):
    """Every block's output and the detections of the whole forward (see
    the module's tolerances)."""
    layers, params, state, images, model, pp, ps = yolov4
    out = model.apply(pp, ps, images, collect_outputs=True)
    det, outs = ref.forward(layers, params, state, images.permute(0, 3, 1, 2),
                            outputs=True)
    for i, info in enumerate(layers):
        if info["type"] != "yolo":
            assert _rel(out["outputs"][i], outs[i]) <= 2e-3, i
    got = out["detections"]
    assert got.shape == det.shape == (2, 3 * (12 * 12 + 6 * 6 + 3 * 3), 85)
    box = ((got[..., :4] - det[..., :4]).abs()
           / det[..., :4].abs().clamp_min(1.0)).amax()
    assert box <= 5e-3
    assert (got[..., 4:] - det[..., 4:]).abs().amax() <= 2e-3


def test_the_detections_reach_nms(yolov4):
    """The path of ``cli.evaluate --what yolo``: ``Darknet.apply`` then
    ``batched_nms`` at the configuration's thresholds keeps rows from
    every frame."""
    from millieye_torch.ops.nms import batched_nms
    _, _, _, images, model, pp, ps = yolov4
    det, valid = batched_nms(model.apply(pp, ps, images)["detections"],
                             0.25, 0.45, max_det=200, pre_top_k=1024)
    assert det.shape == (2, 200, 87) and bool(valid.any(1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("bn", [False, True])
def test_conv_epilogue_plain_mish_equals_the_eager_tail(dtype, channels_last,
                                                         bn):
    """K14's plain version in Mish mode (what a CPU tensor takes): the
    bits and dtype of the eager lines, batch norm's four operations or the
    bias, then ``F.softplus``, ``torch.tanh`` and the product; and Mish
    itself: x above softplus's threshold 20 passes whole, and the value is
    ``F.mish``'s within the dtype's rounding."""
    g = torch.Generator().manual_seed(8)
    x = (6 * torch.randn(2, 12, 5, 7, generator=g)).to(dtype)
    x[0, 0, 0, :3] = torch.tensor([25.0, 20.5, -30.0]).to(dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    c = x.shape[1]
    b = (0.1 * torch.randn(c, generator=g)).to(dtype)
    if bn:
        m = torch.randn(c, generator=g).to(dtype)
        inv = torch.rsqrt((0.5 + torch.rand(c, generator=g)).to(dtype) + 1e-5)
        gam = (1 + 0.1 * torch.randn(c, generator=g)).to(dtype)
        vecs = (b, m, inv, gam)
        t = (x - m[:, None, None]) * inv[:, None, None]
        t = t * gam[:, None, None] + b[:, None, None]
    else:
        vecs = (b,)
        t = x + b[:, None, None]
    want = t * torch.tanh(F.softplus(t))
    got = epi.conv_epilogue(x, *vecs, act="mish")
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
    assert torch.equal(epi.epilogue_eager(x, *vecs, act="mish"), want)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)
    big = t > 20
    assert big.any() and torch.equal(got[big], t[big])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), F.mish(t.float()), rtol=tol,
                          atol=tol)


def test_activation_codes_and_an_unknown_activation():
    """The op's codes, one for each name and no other spelling, and an
    activation other than linear, leaky or mish raises, in the runner, the
    op and the reference: no block runs as linear unseen."""
    assert [epi.act_code(a) for a in ("linear", "leaky", "mish")] == [0, 1, 2]
    for bad in ("relu", "swish", 1, 3, True, False, None):
        with pytest.raises(ValueError, match="unknown activation"):
            epi.act_code(bad)
    defs = yolov4_defs(80, 64)
    defs[5] = dict(defs[5], activation="swish")
    with pytest.raises(ValueError, match="block 4: unknown activation"):
        Darknet(defs, img_size=64)
    with pytest.raises(ValueError, match="unknown activation"):
        ref.plan(defs)
    x = torch.randn(1, 4, 2, 2)
    with pytest.raises(ValueError, match="unknown activation"):
        epi.conv_epilogue(x, torch.zeros(4), act="relu")
    for code in (-1, 3):
        with pytest.raises(ValueError, match="unknown activation code"):
            epi._op(x, torch.zeros(4), None, None, None, code)


@pytest.mark.parametrize("size,stride", [(5, 1), (9, 1), (13, 1), (2, 1),
                                         (2, 2)])
def test_pools_equal_the_reference(size, stride):
    """The runner's max pools against the reference's, bit for bit, and
    their sizes: an odd stride-1 pool keeps the size on -inf padding (an
    all-negative map stays negative at the border), the size-2 stride-1
    pool keeps it on a zero row and column, the stride-2 pool halves it."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 3, 19, 19, generator=g).to(
        memory_format=torch.channels_last)
    got = _maxpool(x, size, stride)
    assert torch.equal(got, ref.maxpool(x, size, stride))
    assert got.shape[-1] == (19 if stride == 1 else 9)
    neg = -1 - x.abs()
    if stride == 1 and size % 2:
        assert bool((_maxpool(neg, size, stride) < 0).all())
    elif stride == 1:
        assert bool((_maxpool(neg, size, stride)[..., -1, :] == 0).all())


def _old_decode(raw, anchors, num_classes, img_dim):
    """``decode_yolo`` as it was before ``scale_x_y``, kept here."""
    n, g = raw.shape[0], raw.shape[2]
    a = len(anchors)
    f = 5 + num_classes
    raw = raw.permute(0, 2, 3, 1).reshape(n, g, g, a, f).permute(
        0, 3, 1, 2, 4)
    raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
    stride = img_dim / g
    anc = torch.tensor(anchors, dtype=torch.float32)
    xy = torch.sigmoid(raw[..., 0:2])
    twh = raw[..., 2:4]
    conf = torch.sigmoid(raw[..., 4:5])
    cls = torch.sigmoid(raw[..., 5:])
    ar = torch.arange(g, dtype=torch.float32)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    grid = torch.stack([gx, gy], -1)[None, None]
    bxy = (xy + grid) * stride
    bwh = torch.exp(twh.clamp(-20.0, 20.0)) * anc[None, :, None, None, :]
    return torch.cat([bxy, bwh, conf, cls], -1).reshape(n, a * g * g, f)


def test_decode_scale_x_y():
    """At s = 1.2 the reference's decode, the centre reaching past its
    cell (sigmoid * 1.2 - 0.1); at s = 1 the old decode's bits. Against
    the references within 2 float32 ulps: the port takes the sigmoid of x
    and y together, the references of each alone, and the CPU's
    vectorized and scalar sigmoids differ in the last bit."""
    g = torch.Generator().manual_seed(10)
    anchors = YOLOV4_ANCHORS[:3]
    raw = 4 * torch.randn(2, 3 * 85, 7, 7, generator=g)
    got = decode_yolo(raw, anchors, 80, 224, scale_x_y=1.2)
    want = ref.decode(raw, anchors, 80, 224, 1.2)
    assert torch.allclose(got, want, rtol=2.4e-7, atol=0)
    off = got[0, :49, 0] / 32 - torch.arange(7.0).repeat(7)
    assert float(off.min()) < 0 and float(off.max()) > 1
    assert not torch.allclose(got[..., :2],
                              decode_yolo(raw, anchors, 80, 224)[..., :2])
    one = decode_yolo(raw, anchors, 80, 224, scale_x_y=1.0)
    assert torch.equal(one, _old_decode(raw, anchors, 80, 224))
    assert torch.equal(one, decode_yolo(raw, anchors, 80, 224))
    assert torch.allclose(one, ref_darknet.decode(raw, anchors, 80, 224),
                          rtol=2.4e-7, atol=0)


def test_the_cfg_path_builds_yolov4(tmp_path):
    """``yolov4_defs`` written as a darknet ``.cfg``, read back by
    ``parse_model_config`` and built by ``build_darknet(model_cfg=...)``:
    the same blocks, and the same detections as the zoo's model at 64
    px."""
    defs = yolov4_defs(80, 64)
    lines = []
    for b in defs:
        lines.append(f"[{b['type']}]")
        lines.extend(f"{k}={v}" for k, v in b.items() if k != "type")
        lines.append("")
    path = tmp_path / "yolov4.cfg"
    path.write_text("\n".join(lines))
    assert parse_model_config(str(path)) == defs
    model = build_darknet(model_cfg=str(path), img_size=64)
    zoo = Darknet(defs, img_size=64)
    assert model._plan == zoo._plan
    params, state = zoo.init(torch.Generator().manual_seed(11))
    images = torch.rand((1, 64, 64, 3),
                        generator=torch.Generator().manual_seed(12))
    assert torch.equal(model.apply(params, state, images)["detections"],
                       zoo.apply(params, state, images)["detections"])


def test_int8_skip_names_the_linear_convs_only():
    """Under int8 serving the linear head convolutions stay in float:
    tiny-YOLO's two, YOLOv4's three; its Mish convolutions are not left
    out."""
    assert Darknet(tiny_yolov3_defs(12, 64), img_size=64).act_int8_skip == (
        15, 22)
    assert Darknet(yolov4_defs(80, 64), img_size=64).act_int8_skip == (
        138, 149, 160)


def test_mish_counters_and_the_spp_span():
    """In a profiler session a YOLOv4 ``apply`` counts its 72 Mish blocks
    (``darknet.mish``; none launched K14 on the CPU, and no convolution
    K15), and ``millieye.spp``
    holds the SPP's three pools and their route, inside
    ``millieye.backbone``; a model without Mish keeps no Mish counter."""
    from torch.profiler import ProfilerActivity, profile

    from millieye_torch.runtime import profiler
    profiler.counters()
    model = Darknet(yolov4_defs(80, 64), img_size=64)
    params, state = model.init(torch.Generator().manual_seed(13))
    images = torch.rand((1, 64, 64, 3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.apply(params, state, images)
    assert profiler.counters() == {"darknet.convs": 110,
                                   "darknet.conv_kernel": 0,
                                   "darknet.epilogue": 0,
                                   "darknet.tail_in_conv": 0,
                                   "darknet.add_in_conv": 0,
                                   "darknet.mish": 72,
                                   "darknet.epilogue_mish": 0}
    spp = [e for e in prof.events() if e.name == "millieye.spp"]
    assert len(spp) == 1
    assert spp[0].cpu_parent.name == "millieye.backbone"
    kids = [c.name for c in spp[0].cpu_children]
    assert kids.count("aten::max_pool2d") == 3 and "aten::cat" in kids
    assert not any(c.name == "aten::conv2d" for c in spp[0].cpu_children)
    tiny = Darknet(tiny_yolov3_defs(12, 64), img_size=64)
    tp, ts = tiny.init(torch.Generator().manual_seed(14))
    with profile(activities=[ProfilerActivity.CPU]):
        tiny.apply(tp, ts, images)
    assert set(profiler.counters()) == {"darknet.convs",
                                        "darknet.conv_kernel",
                                        "darknet.epilogue",
                                        "darknet.tail_in_conv",
                                        "darknet.add_in_conv"}


def test_train_mode_mish_matches_the_reference_batch_statistics(yolov4):
    """``apply(train=True)``: batch norm on the batch's statistics, then
    Mish (``_train_bn``, ``epilogue.activate``), against the reference's
    calibration pass, which normalizes each block by its batch's
    statistics too: the detections within the end-to-end tolerances;
    and a gradient reaches the first block through the 72 Mish tails."""
    layers, params, state, images, model, pp, ps = yolov4
    grads = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
             for p in pp]
    out = model.apply(grads, ps, images, train=True)
    det, _ = ref.forward(layers, params, {k: dict(v) for k, v in
                                          state.items()},
                         images.permute(0, 3, 1, 2), stats={})
    got = out["detections"]
    box = ((got[..., :4] - det[..., :4]).abs()
           / det[..., :4].abs().clamp_min(1.0)).amax()
    assert box <= 5e-3
    assert (got[..., 4:] - det[..., 4:]).abs().amax() <= 2e-3
    sum(p.sum() for p in out["preds"]).backward()
    assert torch.isfinite(grads[0]["w"].grad).all()
    assert grads[0]["w"].grad.abs().sum() > 0
