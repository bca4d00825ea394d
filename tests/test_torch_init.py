"""Port parity: the random inits (``Darknet.init``, ``FusionNetwork.init``,
``RefineNetwork.init``, ``heads.conv_bn_stack_init`` /
``radar_encoder_init``) and the Darknet built from a ``.cfg`` file or the
zoo's full YOLOv3, against millieye_tpu.

The inits draw from a ``torch.Generator``, JAX's from its own PRNG, so no
value can match. They are held to:
* the tree: the key paths, shapes and dtypes of ``convert`` of the JAX
  init (its ``jax.eval_shape``), exactly;
* the statistics: conv weights N(0, 0.02), BN gamma 1 + N(0, 0.02),
  linear weights N(0, 2 / fan_in); beta, biases and running means 0,
  running variances 1, exactly. The sample mean and standard deviation of
  n draws are held within 5 of their own standard errors (sigma /
  sqrt(n) and sigma / sqrt(2 n));
* determinism: one seed gives the same tree, bit for bit; under two
  seeds every weight tensor differs, in all but a chance few entries
  (float32 draws collide now and then).

Forward parity of the graph (the port's init through the inverse of
``convert`` into the JAX package's apply): float32 in another summation
order, so tests/test_darknet.py's tolerances: rtol/atol 1e-4 on the
feature map, 1e-2 on the decoded detections.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from millieye_torch.cli._common import build_fusion, build_refine
from millieye_torch.io.checkpoint import leaf_items
from millieye_torch.models import heads as th
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.fusion import (FusionConfig, FusionNetwork,
                                          RefineNetwork)
from millieye_torch.models.zoo import tiny_yolov3_defs, yolov3_defs
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import heads as jh
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxFusion
from millieye_tpu.models.fusion import RefineNetwork as JaxRefine
from millieye_tpu.models.zoo import yolov3_defs as jax_yolov3_defs

torch.set_num_threads(1)

S = 64
KEY = jax.random.PRNGKey(0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _spec(tree, jax_side=False):
    """[(key path, shape, dtype)]; a JAX leaf's 4-D shape turned HWIO ->
    OIHW, as ``convert`` turns it."""
    out = []
    for k, leaf in leaf_items(tree):
        shape = tuple(leaf.shape)
        if jax_side:
            if len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            dtype = str(leaf.dtype)
        else:
            dtype = str(leaf.dtype).replace("torch.", "")
        out.append((k, shape, dtype))
    return out


def _fusion_pair(cls, jcls, defs, **cfg):
    return (cls(Darknet(defs, img_size=S), FusionConfig(**cfg)),
            jcls(JaxDarknet(defs, img_size=S), JaxConfig(**cfg)))


@pytest.mark.parametrize("which", ["tiny", "yolov3", "fusion", "refine"])
def test_init_tree_matches_jax(which):
    if which in ("tiny", "yolov3"):
        defs = (tiny_yolov3_defs(12, S) if which == "tiny"
                else yolov3_defs(80, S))
        got = Darknet(defs, img_size=S).init(_gen())
        want = jax.eval_shape(JaxDarknet(defs, img_size=S).init, KEY)
    else:
        tm, jm = _fusion_pair(
            *((FusionNetwork, JaxFusion) if which == "fusion"
              else (RefineNetwork, JaxRefine)),
            tiny_yolov3_defs(12, S), class_num=1 if which == "fusion"
            else 12)
        got, want = tm.init(_gen()), jax.eval_shape(jm.init, KEY)
    assert _spec(got) == _spec(want, jax_side=True)
    assert all(leaf.device.type == "cpu" for _, leaf in leaf_items(got))


def test_head_inits_match_jax():
    got = th.conv_bn_stack_init(_gen(), (256, 490, 64))
    want = jax.eval_shape(lambda k: jh.conv_bn_stack_init(k, (256, 490, 64)),
                          KEY)
    assert _spec(got) == _spec(want, jax_side=True)
    got = th.radar_encoder_init(_gen())
    want = jax.eval_shape(jh.radar_encoder_init, KEY)
    assert _spec(got) == _spec(want, jax_side=True)


def _within(x, mean, sigma, exact_sigma=False):
    """Sample mean and standard deviation within 5 standard errors."""
    x = x.double().flatten()
    n = x.numel()
    assert abs(float(x.mean()) - mean) <= 5 * sigma / n ** 0.5
    if not exact_sigma:
        assert abs(float(x.std()) - sigma) <= 5 * sigma / (2 * n) ** 0.5


def test_init_statistics():
    """Darknet-53's and the fusion heads' draws, each group pooled."""
    p, s = Darknet(yolov3_defs(80, S), img_size=S).init(_gen())
    convs = [x for x in p if "w" in x]
    _within(torch.cat([x["w"].flatten() for x in convs]), 0.0, 0.02)
    _within(torch.cat([x["gamma"] for x in convs if "gamma" in x]), 1.0,
            0.02)
    for key in ("beta", "b"):
        assert all(torch.equal(x[key], torch.zeros_like(x[key]))
                   for x in convs if key in x)
    assert all(torch.equal(x["mean"], torch.zeros_like(x["mean"]))
               and torch.equal(x["var"], torch.ones_like(x["var"]))
               for x in s if x)
    assert any("b" in x for x in convs) and all(x == {} for x, y in zip(
        p, Darknet(yolov3_defs(80, S), img_size=S)._plan)
        if y["type"] != "convolutional")
    fm = FusionNetwork(Darknet(tiny_yolov3_defs(12, S), img_size=S))
    fp, fs = fm.init(_gen(3))
    _within(fp["img_cnn"][0]["w"], 0.0, 0.02)
    _within(torch.cat([x["w"].flatten() for x in fp["radar_enc"]]), 0.0,
            0.02)
    _within(fp["img_cnn"][0]["bn"]["gamma"], 1.0, 0.02)
    for net, fan_in in (("net0", 490), ("net1", 256), ("net2", 256)):
        _within(fp["refine"][net]["w"], 0.0, (2.0 / fan_in) ** 0.5)
    _within(fp["ensemble"]["fc2"]["w"], 0.0, (2.0 / 64) ** 0.5)
    assert torch.equal(fs["radar_enc"][2]["var"], torch.ones(128))


def test_same_seed_same_tree_two_seeds_differ():
    m = FusionNetwork(Darknet(tiny_yolov3_defs(12, S), img_size=S))
    a, b, c = m.init(_gen(0)), m.init(_gen(0)), m.init(_gen(1))
    la, lb, lc = (leaf_items(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    for (k, x), (_, z) in zip(la, lc):
        if k.endswith("/w") or k.endswith("gamma"):
            assert int((x == z).sum()) <= 1e-4 * x.numel() + 1, k


def test_build_fusion_without_weights_is_the_seed_0_init():
    model, p, s = build_fusion(None, "pallas_max_s01", img_size=S,
                               device="cpu")
    want = model.init(_gen(0))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        leaf_items((p, s)), leaf_items(want)))
    model, p, s = build_refine(None, "f32", img_size=S, device="cpu")
    dp, ds = model.darknet.init(_gen(0))
    # init draws the Darknet first, then the score-map stack, then the
    # heads as init_heads draws them
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        leaf_items(p["darknet"]), leaf_items(dp)))
    g = _gen(0)
    model.darknet.init(g)
    th.conv_bn_stack_init(g, (256, 490))
    hp, _ = model.init_heads(g)
    assert torch.equal(hp["ensemble"]["fc2"]["w"], p["ensemble"]["fc2"]["w"])


def test_init_moves_to_device():
    """``device`` moves the CPU draws; a meta device stands in for the
    card (the card test holds the values)."""
    m = FusionNetwork(Darknet(tiny_yolov3_defs(12, S), img_size=S))
    p, s = m.init(_gen(), device="meta")
    assert all(x.device.type == "meta" for _, x in leaf_items((p, s)))


def _to_jax(tree):
    """A port tree -> the JAX package's layout (4-D OIHW -> HWIO)."""
    return jax.tree.map(
        lambda t: jnp.asarray(t.permute(2, 3, 1, 0).numpy() if t.dim() == 4
                              else t.numpy()), tree)


def _forward_parity(path_or_defs, rng, feature_tap):
    tm = Darknet(path_or_defs, img_size=S, feature_tap=feature_tap)
    jm = JaxDarknet(path_or_defs, img_size=S, feature_tap=feature_tap)
    assert tm._plan == jm._plan
    p, s = tm.init(_gen())
    # non-trivial running statistics
    s = [{k: v + 0.1 * (j % 5 + 1) for k, v in x.items()}
         for j, x in enumerate(s)]
    x = rng.uniform(size=(2, S, S, 3)).astype(np.float32)
    with torch.no_grad():
        got = tm.apply(p, s, torch.from_numpy(x))
    want = jm.apply(_to_jax(p), _to_jax(s), jnp.asarray(x))
    np.testing.assert_allclose(got["feature_map"].numpy(),
                               np.asarray(want["feature_map"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["detections"].numpy(),
                               np.asarray(want["detections"]),
                               rtol=1e-2, atol=1e-2)
    return got


def test_darknet_from_cfg_file_matches_jax(tmp_path, rng):
    """A Darknet from a .cfg path (tiny-YOLOv3, written by chip_smoke.py's
    writer) on the port's init, against the JAX package's."""
    cfg = str(tmp_path / "tiny.cfg")
    cs.write_cfg(tiny_yolov3_defs(12, S), cfg)
    got = _forward_parity(cfg, rng, 8)
    assert got["detections"].shape == (2, 3 * (2 * 2 + 4 * 4), 17)


def test_yolov3_matches_jax(rng):
    """The zoo's full YOLOv3 at 64 px: the same 107-block plan as the JAX
    zoo's, and the forward within tests/test_darknet.py's tolerances; a
    stem preset on Darknet-53 raises in both packages."""
    defs = yolov3_defs(80, S)
    assert defs == jax_yolov3_defs(80, S)
    got = _forward_parity(defs, rng, 36)
    assert got["detections"].shape == (2, 3 * (2 * 2 + 4 * 4 + 8 * 8), 85)
    with pytest.raises(ValueError, match="block 0 is not a"):
        Darknet(defs, stem_stages=(0, 2))
    with pytest.raises(ValueError, match="block 0 is not a"):
        JaxDarknet(defs, pallas_stem_stages=(0, 2))
