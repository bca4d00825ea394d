"""Port parity for the serving paths beyond FusionEngine.infer at one
preset: module2's RefineNetwork.apply, the entry() flagship forward,
batched_step_fn, and every serving preset the port knows, at 96 px on the
CPU (135 anchors -> the whole-matrix NMS kernel K5's plain version; the
RoI kernels' plain versions; the JAX package through XLA:CPU and its
Pallas kernels in interpret mode).

RefineNetwork has no tracked checkpoint: all of its weights come from the
JAX package's ``init(PRNGKey(0))`` through the port's converter.

Tolerances: validity equal, rows matched by box. float32 paths: summation
order only (1e-4 on scores, 1e-3 px). ``roi_precision="default"`` on the
camera-only network: the port rounds the crop's operands and t*bx to
bf16 as the chip does, the interpreter on the CPU multiplies in float32,
so the crops differ by the bf16 class (2^-6 of the map's largest value)
and the scores by 2e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.cli._common import (SERVING_PRESETS, build_fusion,
                                        build_refine, serving_overrides)
from millieye_torch.cli.demo import calibrate
from millieye_torch.entry import entry
from millieye_torch.ops.nms import nms_xyxy
from millieye_torch.runtime import engine as engine_mod
from millieye_torch.runtime.engine import FusionEngine
from millieye_tpu.cli._common import SERVING_PRESETS as JAX_PRESETS
from millieye_tpu.cli._common import serving_overrides as jax_overrides
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxNetwork
from millieye_tpu.models.fusion import RefineNetwork as JaxRefine
from millieye_tpu.runtime import engine as jengine

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)

S = 96
FRAME = (64, 48)
CKPT = "artifacts/stage3_final.npz"
F32_TOL = dict(score=1e-4, box=1e-3)


def _compare(got_b, got_v, want_b, want_v, tol):
    """[B, K, F] rows + [B, K] validity; valid rows sort first and are
    matched by box (nearly tied scores may trade places in the sort)."""
    np.testing.assert_array_equal(got_v, want_v)
    for g, w, v in zip(got_b, want_b, got_v):
        g, w = g[v], w[v]
        assert len(g) > 0
        match = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1).argmin(1)
        assert sorted(match) == list(range(len(w))), match
        np.testing.assert_allclose(g[:, :4], w[match, :4], rtol=0,
                                   atol=tol["box"])
        np.testing.assert_allclose(g[:, 4:], w[match, 4:], rtol=0,
                                   atol=tol["score"])


def _jax_darknet():
    return JaxDarknet(jax_defs(num_classes=12, img_size=S), img_size=S)


@functools.lru_cache(maxsize=None)
def _jax_refine_weights():
    model = JaxRefine(_jax_darknet(), JaxConfig(class_num=12))
    return model.init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("cfg,tol", [
    (dict(roi_impl="einsum"), F32_TOL),
    (dict(roi_impl="kernel", roi_precision="highest"), F32_TOL),
    (dict(roi_impl="kernel", roi_precision="default"),
     dict(score=2e-2, box=1.0))])
def test_refine_apply(cfg, tol):
    """RefineNetwork.apply (module2) on converted init(PRNGKey(0))
    weights; "kernel" is the JAX package's roi_impl="pallas" (kernel K6,
    here its plain version against the interpreted Pallas kernel)."""
    rng = np.random.default_rng(11)
    images = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    jp, js = _jax_refine_weights()
    jcfg = dict(cfg, roi_impl={"kernel": "pallas"}.get(cfg["roi_impl"],
                                                       cfg["roi_impl"]))
    jm = JaxRefine(_jax_darknet(), JaxConfig(class_num=12, max_det=40,
                                             **jcfg))
    want = jax.jit(jm.apply)(jp, js, jnp.asarray(images))
    weights = jax.tree.map(np.asarray, (jp, js))
    model, params, state = build_refine(weights, "f32", img_size=S,
                                        device="cpu", max_det=40, **cfg)
    assert set(params) == {"darknet", "fcn", "refine", "ensemble"}
    with torch.no_grad():
        got = model.apply(params, state, torch.from_numpy(images))
    assert got["boxes"].shape == (2, 40, 7) == want["boxes"].shape
    assert int(got["valid"].sum()) >= 4
    _compare(got["boxes"].numpy(), got["valid"].numpy(),
             np.asarray(want["boxes"]), np.asarray(want["valid"]), tol)


def test_build_refine_from_fusion_checkpoint():
    """Without a module2 checkpoint: Darknet and the score-map stack from
    the fusion checkpoint, the two heads from a seeded generator (every
    build gives the same untrained heads, in the trained layout)."""
    a = build_refine(CKPT, "f32", img_size=S, device="cpu")
    b = build_refine(CKPT, "f32", img_size=S, device="cpu")
    assert a[1]["refine"]["net2"]["w"].shape == (256, 13)
    assert a[1]["ensemble"]["fc2"]["w"].shape == (32 * 13, 2)
    assert "radar_net" not in a[1]["refine"]
    assert float(a[1]["refine"]["net0"]["w"].std()) > 0
    assert torch.equal(a[1]["refine"]["net0"]["w"],
                       b[1]["refine"]["net0"]["w"])
    fusion = build_fusion(CKPT, "f32", img_size=S, device="cpu")
    assert torch.equal(a[1]["fcn"][0]["w"], fusion[1]["img_cnn"][0]["w"])
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, S, S, 3)).astype(np.float32))
    with torch.no_grad():
        out = a[0].apply(a[1], a[2], img)
    assert out["boxes"].shape == (1, 200, 7)
    assert torch.isfinite(out["boxes"]).all()


def test_entry_matches_jax():
    """entry() on the CPU at 96 px against the JAX package's network at
    entry()'s configuration (float32, folded BN, whole-matrix NMS over
    the top 512, max_det 200, 32 radar rows) on the same checkpoint and
    entry()'s own example inputs."""
    fn, args = entry(device="cpu", img_size=S)
    boxes, valid = fn(*args)
    assert boxes.shape == (1, 232, 7) and valid.shape == (1, 232)
    assert torch.isfinite(boxes).all() and bool(valid.any())

    jm = JaxNetwork(_jax_darknet(), JaxConfig(
        max_det=200, max_radar=32, pre_nms_top_k=512, nms_use_blocked=False))
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    r = load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    jp, js = jax.tree.map(jnp.asarray, (r["params"], r["state"]))
    jp, js = jengine.fold_for_serving(jm, jp, js)
    want = jax.jit(lambda *a: jm.apply(*a, mode=0))(
        jp, js, *(jnp.asarray(a.numpy()) for a in args[2:]))
    _compare(boxes.numpy(), valid.numpy(), np.asarray(want["boxes"]),
             np.asarray(want["valid"]), F32_TOL)


def _window(rng, n):
    frames = (rng.uniform(size=(n, FRAME[1], FRAME[0], 3)) * 255).astype(
        np.uint8)
    pts = np.stack([rng.uniform(0, FRAME[0], (n, 24)),
                    rng.uniform(0, FRAME[1], (n, 24)),
                    rng.uniform(1, 12, (n, 24)),
                    rng.uniform(-2, 2, (n, 24))], -1)
    props = [np.array([[5, 5, 30, 40], [20, 10, 60, 45], [40, 2, 63, 30]],
                      np.float64) + i for i in range(n)]
    return frames, pts, props


@pytest.mark.parametrize("preset,mode", [("f32", 0), ("f32", 1),
                                         ("pallas_max4", 0)])
def test_batched_step_equals_per_frame(preset, mode, monkeypatch):
    """One window through batched_step_fn gives each frame's step_fn
    answer: same validity, rows within float32 summation order (a
    convolution at batch 3 may sum in another order than at batch 1).
    Its post-merge NMS is one call for the window, bit-identical to the
    same NMS frame by frame on the same inputs."""
    rng = np.random.default_rng(21)
    frames, pts, props = _window(rng, 3)
    model, params, state = build_fusion(CKPT, preset, img_size=S,
                                        device="cpu")
    eng = FusionEngine(model, params, state, frame_size=FRAME, max_points=32,
                       device="cpu")
    packed = [eng.pack_radar(p, q) for p, q in zip(pts, props)]
    cols = [np.stack(c) for c in zip(*packed)]
    tens = [torch.from_numpy(np.ascontiguousarray(a))
            for a in [frames] + cols]
    calls, seen, post = [], [], eng._post
    monkeypatch.setattr(engine_mod, "nms_xyxy", lambda boxes, *a: (
        calls.append(tuple(boxes.shape)), nms_xyxy(boxes, *a))[1])
    monkeypatch.setattr(eng, "_post", lambda b, v: (
        seen.append((b, v)), post(b, v))[1])
    rows, valid = eng.batched_step_fn(mode)(*tens)
    assert rows.shape[0] == 3 and rows.shape[2] == 6
    assert len(calls) == 1 and calls[0][:1] == (3,)
    frames = [post(b, v) for b, v in zip(*seen[0])]
    assert torch.equal(rows, torch.stack([r for r, _ in frames]))
    assert torch.equal(valid, torch.stack([v for _, v in frames]))
    monkeypatch.undo()
    step = eng.step_fn(mode)
    for i in range(3):
        r1, v1 = step(*(t[i] for t in tens))
        assert torch.equal(valid[i], v1)
        assert int(v1.sum()) > 0
        np.testing.assert_allclose(rows[i].numpy(), r1.numpy(), rtol=0,
                                   atol=1e-3 if preset == "f32" else 0.5)
    with pytest.raises(ValueError, match="static mode"):
        eng.batched_step_fn(3)


@pytest.mark.parametrize("preset", sorted(SERVING_PRESETS))
def test_preset_row_matches_jax(preset):
    """Each of the port's preset rows says what the JAX package's row of
    the same name says, option by option (the port calls the RoI engine
    "kernel"; ``models/darknet.py:PAIR_KERNELS`` maps the pair variant
    names to the port's kernels)."""
    assert preset in JAX_PRESETS
    js2d, jhi, jstore, jk, jover = jax_overrides(preset)
    hi, store, stem_kw, over = serving_overrides(preset)
    assert (hi, store) == (jhi, jstore)
    assert stem_kw["s2d_stages"] == js2d
    assert stem_kw["stem_stages"] == jk["pallas_stem"]
    assert stem_kw["stem_pair"] == jk["pallas_pair"]
    assert stem_kw["stem_precision"] == jk["pallas_precision"]
    assert stem_kw["stem_pair_variant"] == jk["pallas_variant"]
    assert stem_kw["stem_pairs"] == jk["pallas_pairs"]
    jover = dict(jover)
    if jover.get("roi_impl") == "pallas":
        jover["roi_impl"] = "kernel"
    assert over == jover


def test_preset_rows_missing_are_s2d_and_int8():
    """The s2d stem and the int8 ladder, the last rows the port lacked,
    are in: the port's serving rows are the JAX package's 33."""
    assert set(SERVING_PRESETS) == set(JAX_PRESETS)
    assert len(SERVING_PRESETS) == 33


@pytest.mark.parametrize("preset", sorted(
    set(SERVING_PRESETS) - {"f32", "pallas_max_s01"}))
def test_preset_builds_and_serves(preset):
    """Every preset beyond f32 and pallas_max_s01 (test_torch_fusion.py
    holds those to the JAX package) builds from the checkpoint and
    answers a frame at 96 px (int8_acts calibrated on that frame); at one
    of them warmup runs the same path."""
    rng = np.random.default_rng(9)
    frames, pts, props = _window(rng, 1)
    model, params, state = build_fusion(CKPT, preset, img_size=S,
                                        device="cpu")
    absmax = (calibrate(model, params, state, frames[:1])
              if model.cfg.acts_int8 else None)
    eng = FusionEngine(model, params, state, frame_size=FRAME, max_points=32,
                       act_absmax=absmax, device="cpu")
    boxes, valid = eng.infer(frames[0], pts[0], props[0])
    assert boxes.shape == (model.cfg.max_det + model.cfg.max_radar, 6)
    assert np.isfinite(boxes).all() and valid.any()
    if preset == "pallas_max4":
        wb, wv = eng.warmup()
        assert wb.shape == boxes.shape and wv.shape == valid.shape
