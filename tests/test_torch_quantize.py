"""Port parity: millieye_torch/ops/quantize.py against
millieye_tpu/ops/quantize.py, and the int8 activation convolution of
Darknet.apply. Weights: the JAX package's ``Darknet.init(PRNGKey(0))``,
BN folded on the JAX side and handed to both packages through the port's
converter, so both quantize the same float32 values.

Tolerances: ``quantize_int8`` / ``quantize_darknet`` are bit-equal (the
same float32 division and round-half-even). K13's rounding step on
all-zero bits is bit-equal to the Pallas interpreter (whose PRNG returns
zeros on the CPU); its own Philox bits are held to the statistics of
``benchmarks/quantize_tpu_check.py`` and to unbiasedness. The int8
convolution's int32 sum is exact (held to numpy int64); the dequantized
stem is held to a numpy spelling of the same float32 steps, bit for bit.
Calibration: the stem's input absmax is the image's (bit-equal); deeper
blocks' inputs differ by float32 summation order (1e-5 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from millieye_torch.io.checkpoint import convert
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.zoo import tiny_yolov3_defs
from millieye_torch.ops import quantize as tq
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.ops import quantize as jq

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)

S = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def folded():
    """The JAX Darknet's init(PRNGKey(0)) at 64 px, BN folded by the JAX
    package: (jax darknet, folded params, folded state) as numpy trees."""
    jd = JaxDarknet(jax_defs(num_classes=12, img_size=S), img_size=S)
    fp, fs = jd.fold_batchnorm(*jd.init(jax.random.PRNGKey(0)))
    return jd, _np(fp), _np(fs)


@pytest.fixture(scope="module")
def stem():
    """conv3x3 (3 -> 16) + maxpool: the truncated graph of
    tests/test_int8_act.py, in both packages."""
    defs = tiny_yolov3_defs(num_classes=12, img_size=S)
    cut = [defs[0]] + defs[1:3]
    jd = JaxDarknet([jax_defs(num_classes=12, img_size=S)[0]]
                    + jax_defs(num_classes=12, img_size=S)[1:3], img_size=S)
    fp, fs = jd.fold_batchnorm(*jd.init(jax.random.PRNGKey(0)))
    return jd, Darknet(cut, img_size=S), _np(fp), _np(fs)


def test_quantize_darknet_bit_equal(folded):
    """quantize_int8 over every conv, through quantize_darknet: q, scale
    (after HWIO -> OIHW) and the round trip of dequantize_darknet."""
    _, fp, _ = folded
    want = _np(jq.quantize_darknet(fp))
    got = tq.quantize_darknet(convert(fp, [])[0])
    assert len(got) == len(want)
    n_conv = 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if "q" not in w:
            continue
        n_conv += 1
        assert g["q"].dtype == torch.int8
        np.testing.assert_array_equal(g["q"].numpy(),
                                      w["q"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(g["scale"].numpy(),
                                      w["scale"].transpose(3, 2, 0, 1))
    assert n_conv == 13
    back = tq.dequantize_darknet(got)
    want_back = _np(jq.dequantize_darknet(jq.quantize_darknet(fp)))
    for g, w in zip(back, want_back):
        if "w" in w:
            np.testing.assert_array_equal(g["w"].numpy(),
                                          w["w"].transpose(3, 2, 0, 1))
    # and the converter carries the JAX package's quantized tree as it is
    conv = convert(want, [])[0]
    for g, c in zip(got, conv):
        for k in g:
            assert torch.equal(g[k], c[k])


def test_quantize_int8_matches_on_s2d_slots(folded):
    """The space-to-depth slot: the JAX w2 quantized per output channel
    gives the port's q2 on the port's own w2."""
    _, fp, _ = folded
    jd = JaxDarknet(jax_defs(num_classes=12, img_size=S), img_size=S,
                    s2d_stages=(0, 2))
    td = Darknet(tiny_yolov3_defs(num_classes=12, img_size=S), img_size=S,
                 s2d_stages=(0, 2))
    want = _np(jq.quantize_darknet(jd.fold_s2d(fp)))
    got = tq.quantize_darknet(td.fold_s2d(convert(fp, [])[0]))
    for i in (0, 2):
        assert set(got[i]) == {"q2", "scale", "b"}
        np.testing.assert_array_equal(got[i]["q2"].numpy(),
                                      want[i]["q2"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[i]["scale"].numpy(),
                                      want[i]["scale"].transpose(3, 2, 0, 1))


# ------------------------------------------------------------------ K13
def test_philox_known_answers():
    """The plain generator against Random123's Philox4x32-10 vectors."""
    def t(v):
        return torch.tensor([v], dtype=torch.int64)
    for ctr, key, want in [
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((0xffffffff,) * 4, (0xffffffff,) * 2,
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]:
        got = tq.philox4x32(*map(t, ctr), *map(t, key))
        assert tuple(int(g) for g in got) == want


def _carrier():
    w = np.full((8, 128), 0.3, np.float32)
    w[0, 0] = 1.0                        # absmax carrier -> scale 1/127
    return w


@pytest.mark.parametrize("shape,row_tile", [((8, 128), 512),
                                            ((1030, 128), 256)])
def test_stochastic_rounding_on_zero_bits(shape, row_tile):
    """The rounding step fed all-zero bits against the Pallas kernel in
    interpret mode (whose PRNG gives zeros on the CPU): bit-equal values
    and scale, the tail tile (1030 = 4 x 256 + 6 rows) included."""
    w = _carrier() if shape == (8, 128) else \
        np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_q, want_s = jq.quantize_int8_stochastic(jnp.asarray(w), seed=0,
                                                     row_tile=row_tile)
    tw = torch.from_numpy(w)
    scale = tq._stochastic_scale(tw)
    got = tq.stochastic_round(tw / scale,
                              torch.zeros(shape, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_q))
    assert scale.dtype == torch.float32
    assert scale.numpy() == np.asarray(want_s)
    q, s = tq.quantize_int8_stochastic(tw, seed=0, row_tile=row_tile)
    assert q.shape == shape and q.dtype == torch.int8 and torch.equal(s,
                                                                      scale)


def test_stochastic_rounding_statistics():
    """benchmarks/quantize_tpu_check.py's checks on the port's own bits:
    0.3 at scale 1/127 is 38.1 steps, so q is 38 or 39, P(39) ~ 0.1, the
    dequantized mean 0.3; seeds 0 and 1 give different streams."""
    w = torch.from_numpy(_carrier())
    q0, s0 = tq.quantize_int8_stochastic(w, seed=0)
    q1, _ = tq.quantize_int8_stochastic(w, seed=1)
    body = q0[1:].double() * float(s0)
    assert set(torch.unique(q0[1:]).tolist()) == {38, 39}
    assert abs(float(body.mean()) - 0.3) < 0.003
    p39 = float((q0[1:] == 39).double().mean())
    assert 0.07 < p39 < 0.13          # 896 draws: 0.1 +- 3 sigma
    assert q0[0, 0] == 127 and (q0 != q1).any()


def test_stochastic_rounding_unbiased():
    """E[q * scale] = w: over 8 seeds on a normal tensor the mean error
    is within 4 sigma of 0 (each draw errs by at most one step, with
    variance <= 1/4 step^2), and every value is floor or floor + 1."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (300, 64)).astype(np.float32))
    errs = []
    for seed in range(8):
        q, s = tq.quantize_int8_stochastic(w, seed=seed, row_tile=128)
        fl = torch.floor(w / s)
        assert ((q == fl) | (q == fl + 1)).all()
        errs.append((q.double() - (w / s).double()))
    err = torch.stack(errs)
    sigma = 0.5 / np.sqrt(err.numel())
    assert abs(float(err.mean())) < 4 * sigma
    # per element, the mean over seeds tracks the fractional part
    assert float(err.mean(0).abs().mean()) < 0.25


# an absmax whose IEEE quotient by 127 and product with the float32
# reciprocal of 127 differ by an ulp (so does 1e-8, the all-zero floor)
_ULP_CASE = np.float32(0.94474393)


@pytest.mark.parametrize("kind", ["zeros", "negative zeros", "inf",
                                  "-inf", "ulp case"])
def test_stochastic_scale_matches_jax_on_special_inputs(kind):
    """The plain scale (the kernel's on the card) equals the JAX wrapper's
    bit for bit: XLA compiles its ``/ 127.0`` into a product with the
    float32 reciprocal, which the port repeats (``_INV_127``)."""
    w = np.random.default_rng(2).uniform(-0.5, 0.5, (6, 10)).astype(
        np.float32)
    if kind == "zeros":
        w[:] = 0.0
    elif kind == "negative zeros":
        w[:] = -0.0
    elif kind == "inf":
        w[2, 3] = np.inf
    elif kind == "-inf":
        w[5, 0] = -np.inf
    else:
        w[1, 1] = -_ULP_CASE
        assert (_ULP_CASE / np.float32(127.0)
                != _ULP_CASE * (np.float32(1.0) / np.float32(127.0)))
    with pltpu.force_tpu_interpret_mode():
        _, want = jq.quantize_int8_stochastic(jnp.asarray(w), seed=0,
                                              row_tile=4)
    got = tq._stochastic_scale(torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert got.numpy().view(np.uint32) == np.asarray(want).view(np.uint32)
    _, s = tq.quantize_int8_stochastic(torch.from_numpy(w), seed=0,
                                       row_tile=4)
    assert torch.equal(s, got)


def test_stochastic_plain_past_65535_tiles():
    """70000 row tiles of one row, more than a CUDA grid's y dimension
    holds: each tile's values are its own Philox stream's rounding."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (70000, 3)).astype(np.float32))
    q, s = tq.quantize_int8_stochastic(w, seed=5, row_tile=1)
    assert q.shape == (70000, 3) and q.dtype == torch.int8
    fl = torch.floor(w / s)
    assert ((q == fl) | (q == fl + 1)).all()
    for t in (0, 1, 65535, 65536, 69999):
        bits = tq.stochastic_bits(5 + t, 1, 3)
        assert torch.equal(q[t:t + 1], tq.stochastic_round(w[t:t + 1] / s,
                                                           bits))
    # the key runs on past 2^16: tiles 0 and 65536 draw different bits
    assert not torch.equal(tq.stochastic_bits(5, 1, 3),
                           tq.stochastic_bits(5 + 65536, 1, 3))


def test_stochastic_rejects_bad_arguments():
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_int8_stochastic(torch.zeros(4), seed=0)
    with pytest.raises(ValueError, match="row_tile"):
        tq.quantize_int8_stochastic(torch.zeros(4, 4), seed=0, row_tile=0)
    with pytest.raises(ValueError, match="int32"):
        tq.quantize_int8_stochastic(torch.zeros(4, 4), seed=2 ** 31)


# ------------------------------------------------- the int8 convolution
def test_int8_act_conv_exact_on_stem(stem):
    """The truncated stem with the JAX package's calibrated xs and q given
    to both: the port's int32 sum equals numpy's int64 convolution, and
    its output equals the numpy spelling of the dequantize, bias, leaky
    and pool (the emulation of tests/test_int8_act.py); JAX agrees."""
    jd, td, fp, fs = stem
    x = np.random.default_rng(0).uniform(size=(2, S, S, 3)).astype(
        np.float32)
    absmax = jq.calibrate_act_scales(jd, fp, fs, [jnp.asarray(x)])
    jqp = jq.quantize_darknet(fp, act_absmax=absmax)
    want = np.asarray(jd.apply(jqp, fs, jnp.asarray(x))["detections"])
    qp, ts = convert(_np(jqp), fs)
    assert qp[0]["q"].dtype == torch.int8 and qp[0]["xs"].dim() == 0
    got = td.apply(qp, ts, torch.from_numpy(x))["detections"].numpy()

    xs = np.float32(qp[0]["xs"])
    zq = np.clip(np.round(x / xs), -127, 127).astype(np.int64)
    q = qp[0]["q"].numpy().astype(np.int64)          # [16, 3, 3, 3]
    zp = np.pad(zq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(np.einsum("nhwc,oc->nhwo", zp[:, u:u + S, v:v + S], q[:, :, u, v])
              for u in range(3) for v in range(3))
    y32 = tq.int8_conv2d(torch.from_numpy(zq.astype(np.int8)).permute(
        0, 3, 1, 2), qp[0]["q"], 1, 1)
    np.testing.assert_array_equal(y32.permute(0, 2, 3, 1).numpy(), acc)
    sc = (xs * qp[0]["scale"].numpy().reshape(-1)).astype(np.float32)
    y = acc.astype(np.float32) * sc + qp[0]["b"].numpy()
    y = np.where(y > 0, y, y * np.float32(0.1))
    expect = y.reshape(2, S // 2, 2, S // 2, 2, 16).max((2, 4))
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int8_conv_exact_past_float32(folded):
    """A block with cin >= 128 (block 8's 3x3, 128 -> 256 shape) where the
    int32 sums pass 2^24: exact against numpy int64, where a float32
    convolution of the same integers is not; and block 12's real quantized
    weights (cin 512) on random int8 inputs."""
    rng = np.random.default_rng(4)
    # near-full-scale operands whose signs agree for output channel 0:
    # its interior sums reach ~9 * 128 * 123^2 > 2^24
    sign = rng.choice([-1, 1], (256, 128, 1, 1))
    q = (rng.integers(120, 128, (256, 128, 3, 3)) * sign).astype(np.int8)
    zq = (sign[:1] * rng.integers(120, 128, (2, 128, 6, 6))).astype(np.int8)

    def ref(zq, q):
        zp = np.pad(zq.astype(np.int64), ((0, 0), (0, 0), (1, 1), (1, 1)))
        h, w = zq.shape[2:]
        return sum(np.einsum("nchw,oc->nohw", zp[:, :, u:u + h, v:v + w],
                             q[:, :, u, v].astype(np.int64))
                   for u in range(3) for v in range(3))

    want = ref(zq, q)
    assert np.abs(want).max() > 2 ** 24
    got = tq.int8_conv2d(torch.from_numpy(zq), torch.from_numpy(q), 1, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = F.conv2d(torch.from_numpy(zq).float(), torch.from_numpy(q).float(),
                   padding=1)
    assert not np.array_equal(f32.numpy().astype(np.int64), want)

    _, fp, _ = folded
    q12 = tq.quantize_darknet(convert(fp, [])[0])[12]["q"]
    assert q12.shape == (1024, 512, 3, 3)
    zq = rng.integers(-127, 128, (1, 512, 4, 4)).astype(np.int8)
    np.testing.assert_array_equal(
        tq.int8_conv2d(torch.from_numpy(zq), q12, 1, 1).numpy(),
        ref(zq, q12.numpy()))


def test_calibration_matches_and_covers_batches(stem):
    """calibrate_act_scales on the truncated stem equals the JAX
    package's (the stem's input absmax is the image's); over two batches
    it is the elementwise maximum of each (tests/test_int8_act.py)."""
    jd, td, fp, fs = stem
    rng = np.random.default_rng(1)
    b1 = rng.uniform(size=(1, S, S, 3)).astype(np.float32)
    b2 = (2.0 * rng.uniform(size=(1, S, S, 3))).astype(np.float32)
    tp, ts = convert(fp, fs)
    m1 = tq.calibrate_act_scales(td, tp, ts, [torch.from_numpy(b1)])
    m2 = tq.calibrate_act_scales(td, tp, ts, [torch.from_numpy(b2)])
    m12 = tq.calibrate_act_scales(td, tp, ts, [torch.from_numpy(b1),
                                               torch.from_numpy(b2)])
    want = jq.calibrate_act_scales(jd, fp, fs, [jnp.asarray(b1),
                                                jnp.asarray(b2)])
    assert m12.dtype == np.float32 and m12.shape == (2,)
    np.testing.assert_array_equal(m12, np.asarray(want))
    np.testing.assert_array_equal(m12, np.maximum(m1, m2))
    assert m12[0] == np.float32(np.abs(b2).max()) and m12[1] == 0
