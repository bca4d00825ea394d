"""Port parity for the space-to-depth and im2col stem transforms and the
int8 graphs of millieye_torch/models/darknet.py against millieye_tpu, at
128 px on the CPU (the engines at the new presets:
tests/test_torch_s2d_engine.py).

Weights: the JAX package's ``Darknet.init(PRNGKey(0))``, BN folded (and
s2d / im2col folded, and quantized) by the JAX package and handed to the
port through its converter.

Tolerances:
* the weight transforms are rearrangements: exact;
* float32 networks (s2d, im2col, int8 weights dequantized in float32):
  summation order only -> 1e-4;
* int8 activations: each side quantizes its own float32 activations with
  the same scales, which agree only to float32 order, so a few inputs of
  a few convolutions land one int8 step apart -> the feature map within
  1% of its mean magnitude, boxes within 1 px, scores within 0.02;
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.io.checkpoint import convert
from millieye_torch.models import darknet as tdark
from millieye_torch.models.zoo import tiny_yolov3_defs
from millieye_tpu.models import darknet as jdark
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.ops import quantize as jq

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)

S = 128


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(**kw):
    return (jdark.Darknet(jax_defs(num_classes=12, img_size=S), img_size=S,
                          **kw),
            tdark.Darknet(tiny_yolov3_defs(num_classes=12, img_size=S),
                          img_size=S, **kw))


@pytest.fixture(scope="module")
def folded():
    """The JAX Darknet's init(PRNGKey(0)), BN folded by the JAX package."""
    jd, _ = _pair()
    fp, fs = jd.fold_batchnorm(*jd.init(jax.random.PRNGKey(0)))
    return _np(fp), _np(fs)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).uniform(size=(2, S, S, 3)).astype(
        np.float32)


def test_transforms_match_jax():
    """space_to_depth, s2d_conv_weight and im2col_stem_weight against the
    JAX package's after NHWC -> NCHW and HWIO -> OIHW: exact."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 12, 10, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tdark.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
        .permute(0, 2, 3, 1).numpy(),
        np.asarray(jdark.space_to_depth(jnp.asarray(x))))
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1)
    np.testing.assert_array_equal(
        tdark.s2d_conv_weight(tw).numpy(),
        np.asarray(jdark.s2d_conv_weight(jnp.asarray(w))).transpose(3, 2, 0,
                                                                    1))
    np.testing.assert_array_equal(
        tdark.im2col_stem_weight(tw).numpy(),
        np.asarray(jdark.im2col_stem_weight(jnp.asarray(w))))


def _hold(got, want, fm_tol, det_tol):
    np.testing.assert_allclose(got["feature_map"].float().numpy(),
                               np.asarray(want["feature_map"]).astype(
                                   np.float32), rtol=fm_tol, atol=fm_tol)
    np.testing.assert_allclose(got["detections"].numpy(),
                               np.asarray(want["detections"]), rtol=det_tol,
                               atol=det_tol)


@pytest.mark.parametrize("kw,slot", [({"s2d_stages": (0, 2)}, "w2"),
                                     ({"im2col_stages": (0,)}, "wi")])
def test_darknet_stem_transform_matches_jax(folded, images, kw, slot):
    """Darknet(s2d_stages=(0, 2)) / Darknet(im2col_stages=(0,)) on the JAX
    package's fold_s2d / fold_im2col tree, converted, at float32."""
    fp, fs = folded
    jd, td = _pair(**kw)
    jfold = jd.fold_s2d(fp) if slot == "w2" else jd.fold_im2col(fp)
    want = jax.jit(jd.apply)(jfold, fs, jnp.asarray(images))
    tp, ts = convert(_np(jfold), fs)
    # the port's own fold gives the converted tree
    tfold = (td.fold_s2d if slot == "w2" else td.fold_im2col)(
        convert(fp, [])[0])
    assert torch.equal(tfold[0][slot], tp[0][slot])
    got = td.apply(tp, ts, torch.from_numpy(images))
    _hold(got, want, 1e-4, 1e-4)


def test_stem_transform_validation(folded, images):
    """The errors of tests/test_s2d.py and tests/test_im2col_stem.py: a
    stage that is the feature tap, not followed by a 2x2/2 pool, or a
    pool; one stage under two transforms; folding before BN is folded.
    Unfolded weights keep the plain graph."""
    defs = tiny_yolov3_defs(num_classes=12, img_size=S)
    for kw, msg in [({"s2d_stages": (8,)}, "route/tap-referenced"),
                    ({"s2d_stages": (12,)}, "not a conv3x3s1"),
                    ({"s2d_stages": (1,)}, "not a conv3x3s1"),
                    ({"im2col_stages": (1,)}, "not a conv3x3s1"),
                    ({"s2d_stages": (0,), "im2col_stages": (0,)},
                     "more than one stem transform"),
                    ({"s2d_stages": (2,), "stem_stages": (2,)},
                     "more than one stem transform"),
                    ({"im2col_stages": (0,), "stem_stages": (0,)},
                     "more than one stem transform")]:
        with pytest.raises(ValueError, match=msg):
            tdark.Darknet(defs, img_size=S, **kw)
    jd, td = _pair(s2d_stages=(0, 2), im2col_stages=(4,))
    raw = convert(_np(jd.init(jax.random.PRNGKey(0))[0]), [])[0]
    with pytest.raises(ValueError, match="fold_batchnorm must run"):
        td.fold_s2d(raw)
    with pytest.raises(ValueError, match="fold_batchnorm must run"):
        td.fold_im2col(raw)
    _, plain = _pair()
    tp, ts = convert(*folded)
    x = torch.from_numpy(images)
    assert torch.equal(td.apply(tp, ts, x)["detections"],
                       plain.apply(tp, ts, x)["detections"])


@pytest.mark.parametrize("acts", [False, True])
def test_darknet_int8_matches_jax(folded, images, acts):
    """The int8 and int8_acts graphs (s2d stages 0 and 2, q2/q slots,
    xs from the JAX package's calibration, the head convs skipped) on the
    JAX package's quantized tree, converted."""
    fp, fs = folded
    jd, td = _pair(s2d_stages=(0, 2))
    assert td.act_int8_skip == jd.act_int8_skip == (15, 22)
    fp2 = jd.fold_s2d(fp)
    kw = {}
    if acts:
        kw = dict(act_absmax=jq.calibrate_act_scales(
            jd, fp2, fs, [jnp.asarray(images)]), act_skip=jd.act_int8_skip)
    jqp = jq.quantize_darknet(fp2, **kw)
    want = jax.jit(jd.apply)(jqp, fs, jnp.asarray(images))
    tp, ts = convert(_np(jqp), fs)
    assert ("xs" in tp[4]) == acts and "xs" not in tp[15]
    got = td.apply(tp, ts, torch.from_numpy(images))
    if not acts:
        _hold(got, want, 1e-4, 1e-4)
        return
    fm_w = np.asarray(want["feature_map"])
    fm_g = got["feature_map"].numpy()
    assert np.abs(fm_g - fm_w).max() <= 0.01 * np.abs(fm_w).mean()
    det_w, det_g = np.asarray(want["detections"]), got["detections"].numpy()
    assert np.abs(det_g[..., 4:] - det_w[..., 4:]).max() <= 0.02
    assert np.abs(det_g[..., :4] - det_w[..., :4]).max() <= 1.0
