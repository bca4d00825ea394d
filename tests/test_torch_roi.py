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
product rounding alone would be off by ~2.6e-3 of the magnitude.

K6/K7 and K3's float32 mode (the precision ladder), against
ps_roi_align_pallas / ps_roi_align_pallas_padded / roi_align_pallas in
interpret mode and the float32 einsum. Interpret mode on the CPU
multiplies float32 operands exactly where the chip rounds them to bf16,
so per rung:
* "highest": float32 summation order only, 1e-5 of the magnitude;
* "split": the port rounds the lo parts to bf16 as the chip does, the
  interpreter keeps them: 2^-14 of the magnitude (each lo part is 2^-8
  down and rounds at 2^-9 of itself);
* "default": the features are bf16 values, but by, bx and the t*bx
  products are not: bf16 class, 2^-6 of the magnitude (measured 2^-7.9;
  split 2^-17, highest 2^-19).
  On boxes whose interpolation weights are dyadic (so by and bx are bf16
  values too) the rung is held bit-equal to kernel K2's plain version,
  which is itself held to the Pallas kernel that rounds explicitly."""
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

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)


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


def test_plain_ps_roi_vpu_matches_pallas_g1(rng):
    """K2 with reduce="vpu" against ps_roi_align_pallas_padded_g1(...,
    reduce="vpu") in interpret mode, on a bf16-representable map. Both
    sides sum the same bf16-rounded t*bx products over w, in orders of
    their own, so float32 summation order only: 1e-5 of the crop's
    magnitude. The port's "vpu" and "dot" are one function, bit for
    bit."""
    b, n, hw, c_out = 2, 12, 26, 10
    feats = _bf16_values(
        rng.standard_normal((b, hw, hw, c_out * 49)).astype(np.float32))
    fpad = np.zeros((b, hw, hw, 7 * 128), np.float32)
    fpad[..., trk.ps_channel_perm_pad(c_out, 7, 7)] = feats
    boxes = _boxes(rng, b, n, hi=16 * hw)
    want = np.asarray(jrp.ps_roi_align_pallas_padded_g1(
        jnp.asarray(fpad), jnp.asarray(boxes), c_out=c_out,
        precision="default", interpret=True, reduce="vpu"))
    tf, tb_ = torch.from_numpy(fpad), torch.from_numpy(boxes)
    got = trk.ps_roi_align_padded(tf, tb_, c_out=c_out, reduce="vpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(
        got.numpy(), trk.ps_roi_align_padded(tf, tb_, c_out=c_out).numpy())
    with pytest.raises(ValueError, match="unknown reduce"):
        trk.ps_roi_align_padded(tf, tb_, c_out=c_out, reduce="sum")


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


_LADDER_TOL = {"highest": 1e-5, "split": 2.0 ** -14, "default": 2.0 ** -6}


def _assert_ladder(got, want, precision):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= _LADDER_TOL[precision] * scale, (precision, err, scale)


def _bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def test_ps_channel_perm_matches():
    np.testing.assert_array_equal(trk.ps_channel_perm(10, 7, 7),
                                  jrp.ps_channel_perm(10, 7, 7))


@pytest.mark.parametrize("precision", ["default", "split", "highest"])
@pytest.mark.parametrize("order", ["upq", "puq"])
def test_plain_ps_roi_matches_pallas(rng, precision, order):
    """K6: the unpadded map in both channel orders."""
    b, n, hw, c_out = 2, 12, 13, 10
    feats = _bf16_values(
        rng.standard_normal((b, hw, hw, c_out * 49)).astype(np.float32))
    boxes = _boxes(rng, b, n, hi=16 * hw)
    want = np.asarray(jrp.ps_roi_align_pallas(
        jnp.asarray(feats), jnp.asarray(boxes), precision=precision,
        interpret=True, channel_order=order))
    got = trk.ps_roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                           precision=precision, channel_order=order)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_ladder(got.numpy(), want, precision)
    if order == "upq" and precision == "highest":
        _assert_ladder(got.numpy(), np.asarray(j_ps_batched(
            jnp.asarray(feats), jnp.asarray(boxes))), precision)
    if order == "puq":       # the permuted map holds the same numbers
        src = trk.ps_channel_perm(c_out, 7, 7)
        back = np.empty_like(feats)
        back[..., src] = feats
        np.testing.assert_array_equal(got.numpy(), trk.ps_roi_align(
            torch.from_numpy(back), torch.from_numpy(boxes),
            precision=precision, channel_order="upq").numpy())


@pytest.mark.parametrize("precision", ["split", "highest"])
def test_plain_ps_roi_padded_f32_matches_pallas(rng, precision):
    """K7: the padded map with float32 operands."""
    b, n, hw, c_out = 2, 12, 26, 10
    feats = rng.standard_normal((b, hw, hw, c_out * 49)).astype(np.float32)
    fpad = np.zeros((b, hw, hw, 7 * 128), np.float32)
    fpad[..., trk.ps_channel_perm_pad(c_out, 7, 7)] = feats
    boxes = _boxes(rng, b, n, hi=16 * hw)
    want = np.asarray(jrp.ps_roi_align_pallas_padded(
        jnp.asarray(fpad), jnp.asarray(boxes), c_out=c_out,
        precision=precision, interpret=True))
    got = trk.ps_roi_align_padded(torch.from_numpy(fpad),
                                  torch.from_numpy(boxes), c_out=c_out,
                                  precision=precision)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_ladder(got.numpy(), want, precision)
    _assert_ladder(got.numpy(), np.asarray(j_ps_batched(
        jnp.asarray(feats), jnp.asarray(boxes))), precision)


@pytest.mark.parametrize("precision", ["default", "split", "highest"])
@pytest.mark.parametrize("pack_p", [True, False])
def test_plain_roi_align_ladder_matches_pallas(rng, precision, pack_p):
    """K3 with float32 operands (pack_p) and RoIAlign through K6."""
    b, n, hw, c = 2, 12, 13, 10
    feats = _bf16_values(rng.standard_normal((b, hw, hw, c)).astype(
        np.float32))
    boxes = _boxes(rng, b, n, hi=16 * hw)
    want = np.asarray(jrp.roi_align_pallas(
        jnp.asarray(feats), jnp.asarray(boxes), precision=precision,
        interpret=True, pack_p=pack_p))
    got = trk.roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                        precision=precision, pack_p=pack_p)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if precision == "default" and pack_p:
        # the packed Pallas kernel ships bf16 operands and rounds t*bx
        # explicitly, so both sides round alike; the per-bin-row one
        # leaves the product to the chip's dot, which the interpreter
        # does not round (the ladder's bound)
        _close_to_order(got.numpy(), want)
    else:
        _assert_ladder(got.numpy(), want, precision)
    if not pack_p:      # the two kernels compute one function, bit for bit
        np.testing.assert_array_equal(got.numpy(), trk.roi_align(
            torch.from_numpy(feats), torch.from_numpy(boxes),
            precision=precision, pack_p=True).numpy())


def test_default_rung_equals_k2_on_dyadic_boxes(rng):
    """With by and bx holding bf16 values (boxes of 7 or 14 cells on the
    cell grid: one or two taps per bin, weights 1 or 1/2), K6's and K7's
    "default" rung rounds what kernel K2 rounds, and must equal it."""
    b, n, hw, c_out = 2, 10, 26, 10
    feats = _bf16_values(
        rng.standard_normal((b, hw, hw, c_out * 49)).astype(np.float32))
    cells = rng.integers(1, 3, (b, n, 2)) * 7
    start = rng.integers(0, 26 - 14, (b, n, 2))
    boxes = (np.concatenate([start, start + cells], -1) * 16).astype(
        np.float32)
    by, bx = tra._batched_prep(torch.from_numpy(boxes), hw, hw, (7, 7),
                               1 / 16, -0.5, 0.1, -1, 4)
    assert torch.equal(by.to(torch.bfloat16).float(), by)
    assert torch.equal(bx.to(torch.bfloat16).float(), bx)
    fpad = np.zeros((b, hw, hw, 7 * 128), np.float32)
    fpad[..., trk.ps_channel_perm_pad(c_out, 7, 7)] = feats
    tb_ = torch.from_numpy(boxes)
    want = trk.ps_roi_align_padded(torch.from_numpy(fpad), tb_, c_out=c_out)
    assert float(want.abs().max()) > 0.1
    np.testing.assert_array_equal(
        trk.ps_roi_align(torch.from_numpy(feats), tb_).numpy(), want.numpy())
    np.testing.assert_array_equal(trk.ps_roi_align_padded_f32_kernel(
        torch.from_numpy(fpad), by, bx, c_out, "default").numpy(),
        want.numpy())


def _ps_roi_full_sum(features, by, bx, c_out):
    """K2's function summed over every map row and column (the first
    kernel's order): the spelling the support-restricted plain version
    must equal bit for bit."""
    b, h, w, c_pad = features.shape
    n, ph, pw = by.shape[1], by.shape[2], bx.shape[2]
    ol = c_out * pw
    f = features.float().reshape(b, h, w, ph, c_pad // ph)[..., :ol]
    byf = by.float()
    t = f.new_zeros((b, n, ph, w, ol))
    for y in range(h):
        t = t + byf[:, :, :, y, None, None] * f[:, None, y].transpose(2, 3)
    q_of_j = torch.arange(ol) % pw
    bxj = bx.float().transpose(2, 3)[..., q_of_j]
    out = f.new_zeros((b, n, ph, ol))
    for x in range(w):
        out = out + (t[:, :, :, x] * bxj[:, :, None, x]).to(
            torch.bfloat16).float()
    return out.reshape(b, n, ph, c_out, pw).transpose(3, 4)


_SUPPORT_CASES = ["random", "whole_frame", "sub_cell", "partly_outside",
                  "wholly_outside", "negative_map"]


def _support_boxes(case, rng, b, n):
    """[B, N, 4] xyxy RoIs of one kind on a 416 px frame (26 x 26 map at
    stride 16): random, every RoI the whole frame, below one cell, across
    an edge, wholly outside; "negative_map" draws random RoIs."""
    xy = rng.uniform(-20, 380, (b, n, 2))
    wh = {"random": rng.uniform(4, 300, (b, n, 2)),
          "whole_frame": np.full((b, n, 2), 416.0),
          "sub_cell": rng.uniform(0.5, 12, (b, n, 2)),
          "partly_outside": rng.uniform(120, 300, (b, n, 2)),
          "wholly_outside": rng.uniform(10, 60, (b, n, 2)),
          "negative_map": rng.uniform(4, 300, (b, n, 2))}[case]
    if case == "whole_frame":
        xy = rng.uniform(-2, 2, (b, n, 2))
    elif case == "partly_outside":     # across the top/left or the
        xy = np.where(rng.random((b, n, 2)) < 0.5,   # bottom/right edge
                      rng.uniform(-100, -40, (b, n, 2)),
                      rng.uniform(330, 400, (b, n, 2)))
    elif case == "wholly_outside":
        xy = rng.choice([-1.0, 1.0], (b, n, 2)) * 500 + 208
    return torch.tensor(np.concatenate([xy, xy + wh], -1),
                        dtype=torch.float32)


@pytest.mark.parametrize("case", _SUPPORT_CASES)
def test_k2_support_spans_equal_full_sum(case):
    """K2's plain version sums only the nonzero span of by's rows and of
    bx's columns, as the kernel does; the terms it leaves out are exact
    zeros, so it equals the full sum bit for bit on every kind of RoI."""
    rng = np.random.default_rng(len(case))
    b, n, hw, c_out = 2, 12, 26, 10
    boxes = _support_boxes(case, rng, b, n)
    by, bx = tra._batched_prep(boxes, hw, hw, (7, 7), 1 / 16, -0.5, 0.1, -1,
                               4)
    by, bx = by.to(torch.bfloat16), bx.to(torch.bfloat16)
    feats = rng.standard_normal((b, hw, hw, 7 * 128))
    if case == "negative_map":
        feats = -np.abs(feats)
    feats = torch.tensor(feats, dtype=torch.bfloat16)
    got = trk.ps_roi_align_padded_plain(feats, by, bx, c_out)
    want = _ps_roi_full_sum(feats, by, bx, c_out)
    assert torch.equal(got, want)
    rows = (by.float() != 0).sum(-1)
    if case == "wholly_outside":
        assert float(want.abs().max()) == 0.0
    else:
        assert float(want.abs().max()) > 0.0
    if case != "wholly_outside":       # the spans really leave rows out
        assert int(rows.max()) < hw


@pytest.mark.parametrize("case", _SUPPORT_CASES)
def test_k3_support_spans_equal_full_sum(monkeypatch, case):
    """K3's bf16 plain version sums only the nonzero span of by's rows and
    of bx's columns, as the kernel does; the terms it leaves out are exact
    zeros, so it equals the full sum, the same code with every span the
    whole axis, bit for bit on every kind of RoI. (K3's float32 modes
    share their plain version with layout "c" below.)"""
    rng = np.random.default_rng(len(case))
    b, n, hw, c = 2, 12, 26, 10
    boxes = _support_boxes(case, rng, b, n)
    by, bx = tra._batched_prep(boxes, hw, hw, (7, 7), 1 / 16, 0.0, 1.0, -1,
                               4)
    by, bx = by.to(torch.bfloat16), bx.to(torch.bfloat16)
    feats = rng.standard_normal((b, hw, hw, c))
    if case == "negative_map":
        feats = -np.abs(feats)
    feats = torch.tensor(feats, dtype=torch.bfloat16)
    got = trk.roi_align_plain(feats, by, bx)
    with monkeypatch.context() as m:
        m.setattr(trk, "_span_mask", torch.ones_like)
        want = trk.roi_align_plain(feats, by, bx)
    assert got.shape == (b, n, 7, 7, c)
    assert torch.equal(got, want)
    if case == "wholly_outside":
        assert float(want.abs().max()) == 0.0
    else:
        assert float(want.abs().max()) > 0.0
        # the spans really leave rows (and, but for whole-frame RoIs,
        # columns) out
        assert int(trk._span_mask(by != 0).sum(-1).max()) < hw
        cols = trk._span_mask((bx != 0).any(2)).sum(-1)
        assert int(cols.min()) < hw or case == "whole_frame"


@pytest.mark.parametrize("case", _SUPPORT_CASES)
@pytest.mark.parametrize("layout", ["upq", "puq", "padded", "c"])
@pytest.mark.parametrize("precision", ["default", "split", "highest"])
def test_f32_support_spans_equal_full_sum(monkeypatch, precision, layout,
                                          case):
    """K6 ("upq", "puq", "c") and K7 ("padded"): the float32-operand plain
    versions sum only the nonzero span of by's rows and of bx's columns,
    as the kernels do. At every rung of the ladder the terms left out are
    exact zeros (a zero by or bx has zero hi and lo parts), so the span
    sum equals the full sum, the same code with every span the whole
    axis, bit for bit on every kind of RoI. Layout "c" is RoIAlign, whose
    plain version K3's float32 kernel shares."""
    rng = np.random.default_rng(len(case))
    b, n, hw, c_out = 2, 12, 26, 10
    boxes = _support_boxes(case, rng, b, n)
    ps = layout != "c"
    by, bx = tra._batched_prep(boxes, hw, hw, (7, 7), 1 / 16,
                               -0.5 if ps else 0.0, 0.1 if ps else 1.0, -1, 4)
    c = {"padded": 7 * 128, "c": c_out}.get(layout, c_out * 49)
    feats = rng.standard_normal((b, hw, hw, c))
    if case == "negative_map":
        feats = -np.abs(feats)
    feats = torch.tensor(feats, dtype=torch.float32)

    def crop():
        if layout == "c":
            return trk.roi_align_f32_plain(feats, by, bx, precision)
        return trk.ps_roi_align_f32_plain(feats, by, bx, c_out, precision,
                                          layout)

    got = crop()
    with monkeypatch.context() as m:
        m.setattr(trk, "_span_mask", torch.ones_like)
        want = crop()
    assert got.shape == (b, n, 7, 7, c_out)
    assert torch.equal(got, want)
    if case == "wholly_outside":
        assert float(want.abs().max()) == 0.0
    else:
        assert float(want.abs().max()) > 0.0
        # the spans really leave rows (and, but for whole-frame RoIs,
        # columns) out
        assert int(trk._span_mask(by != 0).sum(-1).max()) < hw
        cols = trk._span_mask((bx != 0).any(2)).sum(-1)
        assert int(cols.min()) < hw or case == "whole_frame"
