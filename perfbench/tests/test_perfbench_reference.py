"""The plain reference against the port's plain path on the CPU at a small
size: the same blocks, the same weights, the same frames. The port runs
float32 here (its ``f32`` preset, the kernels' plain versions), so the
two agree to float32 rounding."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.reference import darknet, fusion, nms
from perfbench.reference.weights import read_npz
from perfbench.traffic import Pool

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent
SIZE = 128


def config(name, size=SIZE):
    c = json.loads((BASE / "configs" / f"{name}.json").read_text())
    c["img_size"] = size
    c["blocks"][0]["height"] = c["blocks"][0]["width"] = str(size)
    return c


@pytest.fixture(scope="module", autouse=True)
def threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_configs_are_the_ports_declarations():
    from millieye_torch.models.zoo import tiny_yolov3_defs, yolov3_defs
    assert config("millieye-tiny416", 416)["blocks"] == tiny_yolov3_defs(
        12, 416)
    assert config("yolov3-d53-416", 416)["blocks"] == yolov3_defs(80, 416)


def scenes(n=3, light="L", radar=True, seed=4_000_000_123):
    mix = {"illumination": light, "radar": radar, "pool": n, "repeat": 1,
           "batch": n}
    return Pool(mix, seed)


def program_batch(pool, size, radar=True):
    from millieye_torch.data.loader import PaddedCollate
    from millieye_torch.train.recipes import fusion_device_batch
    kw = dict(max_targets=64)
    if radar:
        kw.update(max_radar=32, max_points=256)
    b = PaddedCollate(size, **kw)([pool.get(i) for i in range(len(pool))])
    return fusion_device_batch(b, size, "cpu")


def answers(boxes, valid):
    return [(b[v][:, :6].float(), i) for i, (b, v) in enumerate(zip(boxes,
                                                                    valid))]


@pytest.mark.parametrize("mode", [0, 1])
def test_fusion_against_the_port(mode):
    from millieye_torch.cli._common import build_fusion
    c = config("millieye-tiny416")
    pool = scenes(6, light="L" if mode == 0 else "H")
    batch = program_batch(pool, SIZE)
    model, params, state = build_fusion(str(ROOT / c["weights"]), "f32",
                                        img_size=SIZE, device="cpu")
    with torch.no_grad():
        out = model.apply(params, state, batch["images"], batch["radar_maps"],
                          batch["radar_boxes"], batch["rmask"], mode=mode)
    P, S = read_npz(ROOT / c["weights"])
    layers = darknet.plan(c["blocks"])
    want = {k: c[k] for k in ("conf_thresh", "nms_thresh", "max_det",
                              "pre_nms_top_k", "class_idx")}
    views = {}
    for i, it in enumerate(pool.items):
        img = torch.from_numpy(np.ascontiguousarray(
            fusion.resize_nearest(it["image"], SIZE)))
        maps = fusion.radar_maps(it["radar_points"], it["frame_size"], SIZE)
        assert float((maps - batch["radar_maps"][i]).abs().max()) < 1e-5
        with torch.no_grad():
            views[i] = fusion.fusion_scene(
                P, S, layers, img, maps,
                torch.from_numpy(it["radar_boxes"][:32]), want, mode)
    got = answers(out["boxes"], out["valid"])
    n = check.row_numbers(got, views)
    assert n["rows_missing"] == 0, n
    assert [len(r) for r, _ in got] == [len(v.kept) for v in views.values()]
    assert n["row_gap"] < 0.05, n
    assert sum(len(v.kept) for v in views.values()) > 3


def test_darknet53_against_the_port():
    """Seeded weights with batch norm calibrated on the frames, the port's
    ``Darknet.apply`` and ``batched_nms`` against the reference's forward,
    decode and NMS; the NMS keep sets are equal."""
    from millieye_torch.models.darknet import Darknet
    from millieye_torch.ops.nms import batched_nms
    size = 64
    c = config("yolov3-d53-416", size)
    pool = scenes(2, light="H", radar=False)
    imgs = torch.stack([torch.from_numpy(np.ascontiguousarray(
        fusion.resize_nearest(it["image"], size))) for it in pool.items])
    layers = darknet.plan(c["blocks"])
    params, state = darknet.seeded_weights(layers, 4_000_000_321, "cpu")
    darknet.calibrate_bn(layers, params, state, imgs.permute(0, 3, 1, 2))
    model = Darknet(c["blocks"], img_size=size)
    with torch.no_grad():
        got = model.apply([params.get(str(i), {}) for i in range(len(layers))],
                          [state.get(str(i), {}) for i in range(len(layers))],
                          imgs)["detections"]
        want, _ = darknet.forward(layers, params, state,
                                  imgs.permute(0, 3, 1, 2))
    # float32 both, summed in other orders through 75 convolutions: the
    # widths and heights (exp of the raw output, times anchors of up to
    # 373 px) carry the largest relative gap, 4e-4 here
    torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-4)
    # calibrated: the objectness spreads, and about half the anchors pass
    obj = want[..., 4]
    assert 0.2 < float((obj >= 0.5).float().mean()) < 0.8
    assert float(obj.std()) > 0.05
    det, valid = batched_nms(want, 0.5, 0.5, max_det=200, pre_top_k=512)
    for i in range(len(want)):
        rows, cls = fusion.detector_rows(want[i])
        keep = nms.keep_indices(rows[:, :4], rows[:, 4], cls, 0.5, 0.5, 200,
                                512)
        torch.testing.assert_close(det[i][valid[i]][:, :6], rows[keep])


def test_npz_reader_matches_the_ports_loader():
    from millieye_torch.cli._common import build_fusion
    c = config("millieye-tiny416")
    _, params, state = build_fusion(str(ROOT / c["weights"]), "f32",
                                    img_size=SIZE, device="cpu")
    P, S = read_npz(ROOT / c["weights"])
    torch.testing.assert_close(P["darknet"]["12"]["w"],
                               params["darknet"][12]["w"])
    torch.testing.assert_close(P["refine"]["radar_net"]["conv7"]["w"],
                               params["refine"]["radar_net"]["conv7"]["w"])
    torch.testing.assert_close(S["img_cnn"]["0"]["var"],
                               state["img_cnn"][0]["var"])
