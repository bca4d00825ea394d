"""Port parity: RoI crops. Kernels K2/K3's plain versions
(millieye_torch/ops/roi_kernel.py) against the Pallas functions they
replace in interpret mode, and the float32 einsum path against
millieye_tpu/ops/roi_align.py.

K2/K3 tolerance: both sides round the same operands (features, by, bx)
to bf16, accumulate in float32 and round each t*bx product to bf16 before
the float32 w-sum, so they differ only in summation order. An order
difference in t can move a product across a bf16 rounding boundary (one
bf16 ulp of one of the 26 summed products), so the bound is 2^-10 of the
crop's magnitude. Measured: bit-equal at these shapes; skipping the
product rounding alone would be off by ~2.6e-3 of the magnitude."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.ops import roi_align as tra
from millieye_torch.ops import roi_kernel as trk
from millieye_tpu.ops.roi_align import (_batched_prep as j_batched_prep,
                                        ps_roi_align_batched as j_ps_batched,
                                        roi_align_batched as j_roi_batched)
from millieye_tpu.ops import roi_pallas as jrp


def _boxes(rng, b, n, hi=400):
    xy = rng.uniform(-20, hi * 0.8, (b, n, 2))
    wh = rng.uniform(2, hi * 0.6, (b, n, 2))
    out = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    out[0, 0] = [10, 10, 10.5, 10.2]          # below the minimum RoI size
    return out


def _close_to_order(got, want):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= 2.0 ** -10 * scale, (err, scale)


def test_batched_prep_matches(rng):
    boxes = _boxes(rng, 2, 30)
    for off, mn in ((-0.5, 0.1), (0.0, 1.0)):
        got = tra._batched_prep(torch.from_numpy(boxes), 26, 26, (7, 7),
                                1 / 16, off, mn, -1, 4)
        # eager on purpose: under jit XLA:CPU fuses and contracts the
        # sample-position arithmetic into FMAs, which moves it by ulps
        want = j_batched_prep(jnp.asarray(boxes), 26, 26, (7, 7), 1 / 16,
                              off, mn, -1, 4)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_ps_channel_perm_pad_matches():
    np.testing.assert_array_equal(trk.ps_channel_perm_pad(10, 7, 7),
                                  jrp.ps_channel_perm_pad(10, 7, 7))


@pytest.mark.parametrize("hw", [13, 26])
def test_plain_ps_roi_padded_matches_pallas_g1(rng, hw):
    b, n, c_out = 2, 12, 10
    feats = rng.standard_normal((b, hw, hw, c_out * 49)).astype(np.float32)
    fpad = np.zeros((b, hw, hw, 7 * 128), np.float32)
    fpad[..., trk.ps_channel_perm_pad(c_out, 7, 7)] = feats
    boxes = _boxes(rng, b, n, hi=16 * hw)
    want = np.asarray(jrp.ps_roi_align_pallas_padded_g1(
        jnp.asarray(fpad), jnp.asarray(boxes), c_out=c_out,
        precision="default", interpret=True, reduce="dot"))
    got = trk.ps_roi_align_padded(torch.from_numpy(fpad),
                                  torch.from_numpy(boxes), c_out=c_out)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_to_order(got.numpy(), want)


@pytest.mark.parametrize("hw", [13, 26])
def test_plain_roi_align_matches_pallas_packed(rng, hw):
    b, n, c = 2, 12, 10
    feats = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    boxes = _boxes(rng, b, n, hi=16 * hw)
    want = np.asarray(jrp.roi_align_pallas(
        jnp.asarray(feats), jnp.asarray(boxes), precision="default",
        interpret=True, pack_p=True))
    got = trk.roi_align(torch.from_numpy(feats), torch.from_numpy(boxes))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_to_order(got.numpy(), want)


def test_einsum_path_f32_matches(rng):
    """The f32 preset's crops: same float32 contractions on both sides,
    differing in summation order only (tight float32 tolerance)."""
    b, n = 2, 12
    feats = rng.standard_normal((b, 13, 13, 10)).astype(np.float32)
    ps = rng.standard_normal((b, 13, 13, 490)).astype(np.float32)
    boxes = _boxes(rng, b, n, hi=208)
    tb_ = torch.from_numpy(boxes)
    np.testing.assert_allclose(
        tra.roi_align_batched(torch.from_numpy(feats), tb_).numpy(),
        np.asarray(j_roi_batched(jnp.asarray(feats), jnp.asarray(boxes))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tra.ps_roi_align_batched(torch.from_numpy(ps), tb_).numpy(),
        np.asarray(j_ps_batched(jnp.asarray(ps), jnp.asarray(boxes))),
        rtol=1e-5, atol=1e-5)
