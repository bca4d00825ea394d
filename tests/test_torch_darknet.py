"""Port parity: millieye_torch/models/darknet.py against
millieye_tpu/models/darknet.py at 96 px on the trained stage-3 weights
(artifacts/stage3_final.npz, through the port's weight converter).

Tolerances:
* f32 preset: the same float32 convolutions, in another summation order
  (oneDNN vs XLA:CPU) -> ~1e-5 relative on feature maps and decodes.
* pallas_max_s01 ladder (bf16 backbone, float32/float16 stem with the
  fused pair K4): eager PyTorch rounds to bf16 after every op; XLA may
  keep excess precision inside a fused bf16 chain, and the convolution
  libraries may sum in other orders -> a bf16-class bound: a few 2^-8
  steps on the bf16 feature map, 0.01 on sigmoid scores, 1 px on boxes.
  Measured on this CPU: the feature map bit-equal, detections within
  1e-7 (scores) and 3e-5 px (boxes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.cli._common import build_fusion
from millieye_torch.models import darknet as tdark
from millieye_torch.models.darknet import Darknet, _maxpool
from millieye_torch.models.zoo import tiny_yolov3_defs
from millieye_torch.ops import stem as tstem
from millieye_tpu.cli._common import serving_overrides as jax_overrides
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.models import darknet as jdark
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxNetwork

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)

S = 96
CKPT = "artifacts/stage3_final.npz"


def _jax_model(preset):
    """The JAX package's network at a serving preset on the checkpoint
    (as its cli build_fusion + load, without the random init)."""
    _, hi, store, pk, over = jax_overrides(preset)
    darknet = jdark.Darknet(
        jax_defs(num_classes=12, img_size=S), img_size=S, hi_prec_stages=hi,
        hi_prec_store=jnp.dtype(store) if store else None,
        pallas_stem_stages=pk["pallas_stem"],
        pallas_stem_pair=pk["pallas_pair"],
        pallas_stem_precision=pk["pallas_precision"],
        pallas_stem_pair_variant=pk["pallas_variant"],
        pallas_stem_pairs=pk["pallas_pairs"])
    model = JaxNetwork(darknet, JaxConfig(**over))
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    r = load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    return model, r["params"], r["state"]


def _jax_darknet(preset):
    model, params, state = _jax_model(preset)
    return model.darknet, params["darknet"], state["darknet"]


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(11)
    return rng.uniform(0, 1, (1, S, S, 3)).astype(np.float32)


def test_maxpool_stride1_zero_pad():
    """The stride-1 pool pads right/bottom with zeros, not -inf: an
    all-negative map maxes to 0 on its last row and column."""
    x = -np.random.default_rng(0).uniform(1, 2, (2, 5, 5, 3)).astype(
        np.float32)
    got = _maxpool(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 1)
    want = np.asarray(jdark._maxpool(jnp.asarray(x), 2, 1))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert (want[:, -1] == 0).all() and (want[:, :, -1] == 0).all()


@pytest.mark.parametrize("fold", [False, True])
def test_darknet_f32(image, fold):
    jd, jp, js = _jax_darknet("f32")
    model, params, state = build_fusion(CKPT, "f32", img_size=S,
                                        device="cpu")
    tp, ts = params["darknet"], state["darknet"]
    if fold:
        jp, js = jd.fold_batchnorm(jp, js)
        tp, ts = model.darknet.fold_batchnorm(tp, ts)
    want = jax.jit(jd.apply)(jp, js, jnp.asarray(image))
    got = model.darknet.apply(tp, ts, torch.from_numpy(image))
    np.testing.assert_allclose(got["feature_map"].numpy(),
                               np.asarray(want["feature_map"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["detections"].numpy(),
                               np.asarray(want["detections"]),
                               rtol=1e-4, atol=2e-3)


def test_fold_batchnorm_s01_ladder():
    """bf16 fold keeps the hi-prec stages (0, 2, 4) in float32."""
    jd, jp, js = _jax_darknet("pallas_max_s01")
    model, params, state = build_fusion(CKPT, "pallas_max_s01", img_size=S,
                                        device="cpu")
    jfp, _ = jd.fold_batchnorm(jp, js, dtype=jnp.bfloat16)
    tfp, _ = model.darknet.fold_batchnorm(params["darknet"],
                                          state["darknet"],
                                          dtype=torch.bfloat16)
    for i, (jb, tb) in enumerate(zip(jfp, tfp)):
        if "w" not in jb:
            continue
        want_dt = torch.float32 if i in (0, 2, 4) else torch.bfloat16
        assert tb["w"].dtype == want_dt and tb["b"].dtype == want_dt
        w = np.asarray(jb["w"].astype(jnp.float32)).transpose(3, 2, 0, 1)
        # rsqrt may differ by a float32 ulp, which can move a bf16 rounding
        np.testing.assert_allclose(tb["w"].float().numpy(), w, rtol=2 ** -7,
                                   atol=1e-6)
        np.testing.assert_allclose(tb["b"].float().numpy(),
                                   np.asarray(jb["b"].astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)


def test_darknet_s01_ladder(image, monkeypatch):
    _check_stem_ladder(image, monkeypatch, "pallas_max_s01", 0, 1)


@pytest.mark.parametrize("preset,stages,pairs", [
    ("pallas_max4", 1, 1), ("pallas_stem", 2, 0), ("pallas_stem2", 0, 1),
    ("pallas_packed", 0, 1), ("pallas_s2d", 0, 1), ("pallas_deep", 2, 1),
    ("pallas_pair2", 0, 2)])
def test_darknet_stem_ladder(image, monkeypatch, preset, stages, pairs):
    _check_stem_ladder(image, monkeypatch, preset, stages, pairs)


def _check_stem_ladder(image, monkeypatch, preset, stages, pairs):
    """The bf16 ladder with the fused stem, against the JAX Darknet whose
    Pallas kernels run in interpret mode: the pair K4 (s01), K8 (stem2),
    K11 (packed) or K12 (s2d) at bf16 products, stage 4 through K9
    (pallas_max4), stages 0 and 2 each through K9 at float32 products
    (pallas_stem), stages 4 and 6 through K9 (pallas_deep) or as K12's
    deep pair (pallas_pair2). ``stages`` and ``pairs`` count the calls of
    the stage and pair kernel wrappers per forward."""
    calls = {"stage": 0, "pair": 0}

    def counted(fn, key):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr("millieye_torch.models.darknet.fused_stem_stage",
                        counted(tstem.fused_stem_stage, "stage"))
    for variant, (fn, kw) in list(tdark.PAIR_KERNELS.items()):
        monkeypatch.setitem(tdark.PAIR_KERNELS, variant,
                            (counted(fn, "pair"), kw))
    jd, jp, js = _jax_darknet(preset)
    model, params, state = build_fusion(CKPT, preset, img_size=S,
                                        device="cpu")
    jp, js = jd.fold_batchnorm(jp, js, dtype=jnp.bfloat16)
    tp, ts = model.darknet.fold_batchnorm(params["darknet"], state["darknet"],
                                          dtype=torch.bfloat16)
    want = jax.jit(jd.apply, static_argnames="compute_dtype")(
        jp, js, jnp.asarray(image), compute_dtype=jnp.bfloat16)
    got = model.darknet.apply(tp, ts, torch.from_numpy(image),
                              compute_dtype=torch.bfloat16)
    fm_w = np.asarray(want["feature_map"].astype(jnp.float32))
    fm_g = got["feature_map"].float().numpy()
    assert got["feature_map"].dtype == torch.bfloat16
    assert np.abs(fm_g - fm_w).max() <= 2 ** -6 * np.abs(fm_w).max()
    det_w = np.asarray(want["detections"])
    det_g = got["detections"].numpy()
    assert np.abs(det_g[..., 4:] - det_w[..., 4:]).max() <= 0.01
    assert np.abs(det_g[..., :4] - det_w[..., :4]).max() <= 1.0
    assert calls == {"stage": stages, "pair": pairs}


def test_stem_options_validation():
    """A pair needs two consecutive fused stages and a pair variant the
    JAX package knows ("_bf16s" only where it allows bf16 scratches, and
    then at "default"), ``stem_pairs`` "first" or "all"; a stage must be
    a leaky conv3x3 + pool; unfolded weights keep the plain
    convolution."""
    defs = tiny_yolov3_defs(num_classes=12, img_size=64)
    with pytest.raises(ValueError, match="consecutive"):
        Darknet(defs, img_size=64, stem_stages=(0, 4), stem_pair=True,
                stem_precision="default")
    for bad in ("s2d9", "select_bf16s", "phase_s01_bf16s",
                "phase_vmem_s01_bf16s", "phase_bf16"):
        with pytest.raises(ValueError, match="unknown stem_pair_variant"):
            Darknet(defs, img_size=64, stem_stages=(0, 2), stem_pair=True,
                    stem_precision="default", stem_pair_variant=bad)
        # the JAX package refuses the same names
        with pytest.raises(ValueError, match="unknown pallas_stem_pair"):
            jdark.Darknet(jax_defs(num_classes=12, img_size=64), img_size=64,
                          pallas_stem_pair_variant=bad)
    with pytest.raises(ValueError, match="bf16 scratches"):
        Darknet(defs, img_size=64, stem_stages=(0, 2), stem_pair=True,
                stem_pair_variant="s2d_bf16s")
    with pytest.raises(ValueError, match="unknown stem_pairs"):
        Darknet(defs, img_size=64, stem_stages=(0, 2), stem_pair=True,
                stem_pairs="deep")
    with pytest.raises(ValueError, match="unknown pallas_stem_pairs"):
        jdark.Darknet(jax_defs(num_classes=12, img_size=64), img_size=64,
                      pallas_stem_pairs="deep")
    for ok in ("phase_bf16s", "packed_bf16s", "s2d_bf16s", "s2d8_bf16s",
               "phase_vmem_bf16s"):
        Darknet(defs, img_size=64, stem_stages=(0, 2), stem_pair=True,
                stem_precision="default", stem_pair_variant=ok)
    # the pair takes "highest" too (test_darknet_pair_highest)
    Darknet(defs, img_size=64, stem_stages=(0, 2), stem_pair=True)
    with pytest.raises(ValueError, match="not a leaky conv3x3s1"):
        Darknet(defs, img_size=64, stem_stages=(1,))
    with pytest.raises(ValueError, match="unknown stem_precision"):
        Darknet(defs, img_size=64, stem_stages=(0,), stem_precision="high")
    Darknet(defs, img_size=64, stem_stages=(0, 2), stem_pair=True,
            stem_precision="default")
    # BN not folded: the stage stays a plain convolution
    model, params, state = build_fusion(CKPT, "pallas_stem", img_size=S,
                                        device="cpu")
    before = tstem.fused_stem_stage.launches
    plain, _, _ = build_fusion(CKPT, "bf16_heads", img_size=S, device="cpu")
    x = torch.rand((1, S, S, 3), generator=torch.Generator().manual_seed(0))
    got = model.darknet.apply(params["darknet"], state["darknet"], x)
    want = plain.darknet.apply(params["darknet"], state["darknet"], x)
    assert torch.equal(got["detections"], want["detections"])
    assert tstem.fused_stem_stage.launches == before


def test_darknet_pair_highest(image):
    """The pair (kernel K4) at precision "highest" through Darknet.apply,
    port and JAX (interpret mode) on the float32 network: stages 0+2 as
    the pair in float32 products and stores, so float32 summation order
    only, as test_darknet_f32 (1e-4)."""
    _, jp, js = _jax_darknet("f32")
    jd = jdark.Darknet(jax_defs(num_classes=12, img_size=S), img_size=S,
                       pallas_stem_stages=(0, 2), pallas_stem_pair=True,
                       pallas_stem_precision="highest",
                       pallas_stem_pair_variant="phase")
    jp, js = jd.fold_batchnorm(jp, js)
    _, params, state = build_fusion(CKPT, "f32", img_size=S, device="cpu")
    td = Darknet(tiny_yolov3_defs(num_classes=12, img_size=S), img_size=S,
                 stem_stages=(0, 2), stem_pair=True,
                 stem_precision="highest", stem_pair_variant="phase")
    tp, ts = td.fold_batchnorm(params["darknet"], state["darknet"])
    before = tstem.fused_stem_pair.launches
    want = jax.jit(jd.apply)(jp, js, jnp.asarray(image))
    got = td.apply(tp, ts, torch.from_numpy(image))
    np.testing.assert_allclose(got["feature_map"].numpy(),
                               np.asarray(want["feature_map"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["detections"].numpy(),
                               np.asarray(want["detections"]),
                               rtol=1e-4, atol=2e-3)
    assert tstem.fused_stem_pair.launches == before      # CPU: plain
