"""Port parity: the stem kernels' plain versions (millieye_torch/ops/stem.py)
against the Pallas kernels they replace.

K9 (the single stage) against fused_stem_planar in interpret mode, at both
precisions. The interpreter multiplies float32 operands exactly where the
chip's "default" dot rounds them to bf16, so at "default" both sides get
bf16 values for x and w: every product is then exact on both sides, and
at either precision the two differ in the order of the float32 sums only
(1e-5 of the magnitude; through a float16 or bf16 store, one step of that
type on the few values the order moves across a rounding boundary).

K4 (the pair) against fused_stem2_phase as the
pallas_max_s01 preset runs it (bf16_only="s0s1", precision="default",
float16 out), in interpret mode on the CPU.

Both round the same operands to bf16 (input, w0, the float32
intermediate, w1) and accumulate products in float32, so they differ only
in the order of the float32 sums. That can move a stage-0 value across a
bf16 rounding boundary, which stage 1 carries as one bf16 ulp of that
operand. Bound: two float16 ulps at the outputs' top range (values up
to ~8, ulp 2^-8 there), and at least 99% of outputs exactly equal
(measured: max 2^-9, 99.8-99.95% exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.ops import stem
from millieye_torch.ops.stem import (fused_stem_pair, fused_stem_pair_deep,
                                     fused_stem_pair_packed,
                                     fused_stem_pair_plain,
                                     fused_stem_pair_s2d,
                                     fused_stem_pair_select,
                                     fused_stem_stage, fused_stem_stage_plain)
from millieye_tpu.models import darknet as jdark
from millieye_tpu.ops.stem_pallas import (fused_stem2_packed,
                                          fused_stem2_phase,
                                          fused_stem2_planar, fused_stem2_s2d,
                                          fused_stem_planar)

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(1, 64, 64, 3, 16, 32),
                                   (1, 32, 48, 3, 8, 16)])
def test_plain_stem_matches_pallas_phase_s01(shape):
    n, h, w, cin, cmid, cout = shape
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (n, h, w, cin)).astype(np.float32)
    w0 = (0.3 * rng.standard_normal((3, 3, cin, cmid))).astype(np.float32)
    b0 = (0.1 * rng.standard_normal(cmid)).astype(np.float32)
    w1 = (0.3 * rng.standard_normal((3, 3, cmid, cout))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    want = np.asarray(fused_stem2_phase(
        jnp.asarray(x), jnp.asarray(w0), jnp.asarray(b0), jnp.asarray(w1),
        jnp.asarray(b1), interpret=True, precision="default",
        bf16_only="s0s1", out_dtype=jnp.float16))

    def oihw(a):
        return torch.from_numpy(a).permute(3, 2, 0, 1)

    args = (torch.from_numpy(x), oihw(w0), torch.from_numpy(b0), oihw(w1),
            torch.from_numpy(b1))
    got = fused_stem_pair_plain(*args)
    assert got.dtype == torch.float16 and got.shape == want.shape
    got = got.float().numpy()
    err = np.abs(got - want.astype(np.float32))
    assert err.max() <= 2 * 2.0 ** -8, err.max()
    assert (err == 0).mean() > 0.99
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(fused_stem_pair(*args).float().numpy(), got)


_JDT = {torch.float32: jnp.float32, torch.float16: jnp.float16,
        torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((2, 32, 48, 3, 16), torch.float16),
    ((1, 52, 40, 8, 24), torch.float32),      # 52 rows: a row-padded band
    ((1, 16, 16, 20, 8), torch.bfloat16)])    # more than one channel chunk
def test_plain_stem_stage_matches_pallas_planar(precision, shape, out_dtype):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(h + cin)
    x = rng.uniform(-1, 1, (n, h, w, cin)).astype(np.float32)
    wt = (0.3 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    if precision == "default":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        wt = torch.from_numpy(wt).to(torch.bfloat16).float().numpy()
    want = np.asarray(fused_stem_planar(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), interpret=True,
        out_dtype=_JDT[out_dtype], precision=precision).astype(jnp.float32))
    args = (torch.from_numpy(x), torch.from_numpy(wt).permute(3, 2, 0, 1),
            torch.from_numpy(b))
    got = fused_stem_stage_plain(*args, precision, out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    err = np.abs(got.float().numpy() - want)
    step = {torch.float32: 1e-5, torch.float16: 2.0 ** -10,
            torch.bfloat16: 2.0 ** -7}[out_dtype]
    assert err.max() <= step * np.abs(want).max(), err.max()
    if out_dtype != torch.float32:
        assert (err == 0).mean() > 0.99
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(fused_stem_stage(*args, precision, out_dtype), got)


# ------------------------------------------------------------------ pairs
def _pair_inputs(seed, n, h, w, cin, cmid, cout, bf16_values):
    """x, w0, b0, w1, b1 as numpy HWIO arrays (the JAX layout); with
    ``bf16_values`` x, w0 and w1 hold bf16-representable values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(0, 1, (n, h, w, cin)),
            0.3 * rng.standard_normal((3, 3, cin, cmid)),
            0.1 * rng.standard_normal(cmid),
            0.3 * rng.standard_normal((3, 3, cmid, cout)),
            0.1 * rng.standard_normal(cout)]
    arrs = [a.astype(np.float32) for a in arrs]
    if bf16_values:
        for i in (0, 1, 3):
            arrs[i] = np.asarray(arrs[i].astype(jnp.bfloat16), np.float32)
    return arrs


def _torch_pair_args(arrs):
    x, w0, b0, w1, b1 = (torch.from_numpy(a) for a in arrs)
    return x, w0.permute(3, 2, 0, 1), b0, w1.permute(3, 2, 0, 1), b1


def _hold_pair(got, want, precision):
    """float32 out at "highest": summation order only, 1e-5 of the largest
    output. float16 out at "default" (both sides rounding the same
    operands to bf16): as the K4 test above, two float16 ulps at the top
    of the range and at least 99% exact."""
    want = np.asarray(want).astype(np.float32)
    err = np.abs(got.float().numpy() - want)
    if precision == "highest":
        assert err.max() <= 1e-5 * np.abs(want).max(), err.max()
    else:
        assert err.max() <= 2 * 2.0 ** -8, err.max()
        assert (err == 0).mean() > 0.99, (err == 0).mean()


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_plain_pair_select_matches_pallas_planar(precision):
    """K8 against fused_stem2_planar in interpret mode. At "highest" the
    pool select is exact on both sides: float32 summation order only. At
    "default" the interpreter leaves the bf16 rounding of the dot's
    operands to the chip, so it keeps stage 1's operand and the lo part of
    the select in float32 where the port rounds both to bf16, as the
    chip's DEFAULT dot does: a bf16-class bound, 2^-6 of the largest
    output (measured 2^-9.2; test_pool_select_spells_hi_lo holds the
    rounding itself)."""
    arrs = _pair_inputs(3, 1, 32, 32, 3, 8, 16, precision == "default")
    out_dtype = torch.float32 if precision == "highest" else torch.float16
    want = np.asarray(fused_stem2_planar(
        *map(jnp.asarray, arrs), interpret=True, precision=precision,
        out_dtype=_JDT[out_dtype])).astype(np.float32)
    args = _torch_pair_args(arrs)
    got = fused_stem_pair_select(*args, precision, out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    err = np.abs(got.float().numpy() - want)
    bound = 1e-5 if precision == "highest" else 2.0 ** -6
    assert err.max() <= bound * np.abs(want).max(), err.max()
    # at "highest" the select is exact: K8 is K4's function; at "default"
    # the hi/lo select moves a few outputs by a float16 ulp at most
    k4 = fused_stem_pair(*args, precision, out_dtype)
    if precision == "highest":
        assert torch.equal(got, k4)
    else:
        assert (got != k4).float().mean() < 0.01


def test_pool_select_spells_hi_lo():
    """The port's K8 pool select against a numpy spelling of the TPU's
    two DEFAULT passes, hi = bf16(v) and bf16(v - hi), on random values
    and on values within 2^-16 of a float16 rounding midpoint, where
    f16(hi + lo) and f16(v) may differ by one float16 ulp."""
    rng = np.random.default_rng(4)
    base = rng.uniform(0.5, 8, 4096).astype(np.float16).astype(np.float32)
    ulp = np.spacing(base.astype(np.float16)).astype(np.float32)
    near = base + ulp / 2 + rng.uniform(-1, 1, 4096).astype(np.float32) \
        * base * 2.0 ** -16
    v = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 4,
                        near.astype(np.float32)])
    hi = np.asarray(v.astype(jnp.bfloat16), np.float32)
    want = hi + np.asarray((v - hi).astype(jnp.bfloat16), np.float32)
    got = stem._pool_select(torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)
    moved = (got.to(torch.float16) != torch.from_numpy(v).to(torch.float16))
    assert 0 < int(moved.sum()) < 4096


@pytest.mark.parametrize("kernel,kw,precision", [
    ("packed", {}, "default"), ("packed", {}, "highest"),
    ("s2d", {"groups0": 4}, "default"), ("s2d", {"groups0": 4}, "highest"),
    ("s2d", {"groups0": 8}, "default")])
def test_plain_pair_packed_s2d_match_pallas(kernel, kw, precision):
    """K11 against fused_stem2_packed and K12 against fused_stem2_s2d in
    interpret mode, at H = 32 (H % 64 == 32: the half superband). At
    "default" the JAX side runs the bf16-scratch spelling, which rounds
    stage 1's operand to bf16 as the chip's dot does (the f32-scratch
    name leaves it to the chip); the port's wrapper takes the same name
    and launches the same kernel. groups0=8 is the JAX package's
    bf16-scratch tiling, so it runs at "default". Tolerance as
    _hold_pair."""
    jfn, tfn = {"packed": (fused_stem2_packed, fused_stem_pair_packed),
                "s2d": (fused_stem2_s2d, fused_stem_pair_s2d)}[kernel]
    default = precision == "default"
    arrs = _pair_inputs(5, 1, 32, 24, 3, 8, 16, default)
    out_dtype = torch.float16 if default else torch.float32
    scratch = dict(scratch_dtype=jnp.bfloat16) if default else {}
    want = jfn(*map(jnp.asarray, arrs), interpret=True, precision=precision,
               out_dtype=_JDT[out_dtype], **scratch, **kw)
    args = _torch_pair_args(arrs)
    got = tfn(*args, precision, out_dtype,
              scratch_dtype=torch.bfloat16 if default else None, **kw)
    assert got.dtype == out_dtype and got.shape == want.shape
    _hold_pair(got, want, precision)
    # K4's function, whatever the TPU's MXU tiling
    assert torch.equal(got, fused_stem_pair(*args, precision, out_dtype))


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_plain_deep_pair_matches_pallas_s2d_g2(precision):
    """The deep pair kernel's plain version against fused_stem2_s2d with
    groups0=2 (the deep pair's tiling) in interpret mode, at 24 px (off
    the 32-row grid: the JAX wrapper pads rows and re-zeroes them) and
    8 -> 16 -> 32 channels: interpreting the Pallas kernel at the deep
    pair's 32 -> 64 -> 128 takes ~90 s to trace and compile on the CPU
    (test_plain_deep_pair_at_deep_channels holds those widths). bf16
    store as in the network. "highest": 1e-5 of the largest output
    (summation order); "default" (bf16 scratches on the JAX side, bf16
    values in): one bf16 ulp at the top of the range, at least 99% of the
    outputs exact."""
    default = precision == "default"
    arrs = _pair_inputs(6, 1, 24, 24, 4, 8, 16, default)
    scratch = dict(scratch_dtype=jnp.bfloat16) if default else {}
    want = np.asarray(fused_stem2_s2d(
        *map(jnp.asarray, arrs), interpret=True, precision=precision,
        out_dtype=jnp.bfloat16, groups0=2, **scratch)).astype(np.float32)
    got = fused_stem_pair_deep(*_torch_pair_args(arrs), precision,
                               torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 2.0 ** -7 * np.abs(want).max(), err.max()
    assert (err == 0).mean() > 0.99


def _xla_stage(x, w, b):
    y = jdark._conv2d(x, w, 1, 1, jnp.float32) + b
    return jdark._maxpool(jnp.where(y > 0, y, 0.1 * y), 2, 2)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_plain_deep_pair_at_deep_channels(precision):
    """fused_stem_pair_s2d at the deep pair's widths (32 -> 64 -> 128,
    24 px, groups0=2) takes the deep pair kernel, whose plain version is
    held to the JAX package's two float32 XLA stages (darknet._conv2d +
    leaky + _maxpool, the reference the JAX package holds fused_stem2_s2d
    to), float32 out. "highest": 1e-5 of the largest output. "default"
    (bf16 values in): the port rounds the intermediate to bf16 as stage
    1's operand and the XLA stages do not, 2^-7 of the largest output."""
    default = precision == "default"
    arrs = _pair_inputs(7, 1, 24, 24, 32, 64, 128, default)
    x, w0, b0, w1, b1 = map(jnp.asarray, arrs)
    want = np.asarray(_xla_stage(_xla_stage(x, w0, b0), w1, b1))
    before = fused_stem_pair_deep.launches
    got = fused_stem_pair_s2d(*_torch_pair_args(arrs), precision,
                              torch.float32, groups0=2)
    assert fused_stem_pair_deep.launches == before     # CPU: plain version
    assert not stem._tile_fits(32, 64, 128, precision)
    np.testing.assert_array_equal(got.numpy(), fused_stem_pair_deep(
        *_torch_pair_args(arrs), precision, torch.float32).numpy())
    err = np.abs(got.numpy() - want)
    bound = 2.0 ** -7 if default else 1e-5
    assert err.max() <= bound * np.abs(want).max(), err.max()


def test_pair_options_validation():
    """The JAX kernels' asserts, on CPU tensors too: bf16 scratches only
    at "default", groups0 in {2, 4, 8}, H % 32 == 0 for K8 and K11 and
    H % 4 == 0 for K12, a known precision and store type."""
    args = _torch_pair_args(_pair_inputs(0, 1, 32, 32, 3, 8, 16, False))
    bf = torch.bfloat16
    for fn in (fused_stem_pair, fused_stem_pair_packed, fused_stem_pair_s2d):
        with pytest.raises(ValueError, match="bf16 scratches"):
            fn(*args, "highest", scratch_dtype=bf)
        fn(*args, "default", scratch_dtype=bf)
    with pytest.raises(ValueError, match="groups0"):
        fused_stem_pair_s2d(*args, groups0=3)
    with pytest.raises(ValueError, match="precision"):
        fused_stem_pair_select(*args, "high")
    with pytest.raises(TypeError, match="store"):
        fused_stem_pair_deep(*args, out_dtype=torch.int8)
    short = (args[0][:, :20],) + args[1:]          # H = 20
    fused_stem_pair_s2d(*short)
    for fn in (fused_stem_pair_select, fused_stem_pair_packed):
        with pytest.raises(ValueError, match="H % 32"):
            fn(*short)


@pytest.mark.parametrize("widths,precision,route", [
    ((3, 16, 32), "default", "pair"),
    ((3, 16, 32), "highest", "pair"),
    ((16, 32, 64), "default", "deep"),
    ((16, 32, 64), "highest", "pair"),
    ((32, 64, 128), "default", "deep"),
    ((32, 64, 128), "highest", "deep")])
def test_pair_route(widths, precision, route):
    """One routing decision for the pair wrappers on the CPU and the card:
    the stem pair kernel where its tile fits shared memory (at "default"
    two float32 halos: 16 -> 32 -> 64 does not fit, though it does at
    "highest"), else the deep pair."""
    assert stem.pair_route(*widths, precision) == route


@pytest.mark.parametrize("name", ["fused_stem_pair", "fused_stem_pair_select",
                                  "fused_stem_pair_packed",
                                  "fused_stem_pair_s2d"])
def test_pair_wrappers_route_wide_widths_to_deep(name):
    """K4, K8, K11 and K12 at 16 -> 32 -> 64 ("default") run the deep
    pair's plain version on the CPU, as the card runs the deep pair (K8
    with its pool select), and stay within 2^-7 of the JAX package's two
    float32 XLA stages (the port rounds the intermediate to bf16 as stage
    1's operand); at 3 -> 16 -> 32 they run the stem pair's."""
    fn = getattr(stem, name)
    select = name == "fused_stem_pair_select"
    arrs = _pair_inputs(9, 1, 32, 32, 16, 32, 64, True)
    args = _torch_pair_args(arrs)
    before = stem.fused_stem_pair_deep.launches
    got = fn(*args, "default", torch.float32)
    assert stem.fused_stem_pair_deep.launches == before   # CPU: plain
    assert torch.equal(got, stem.fused_stem_pair_deep_plain(
        *args, "default", torch.float32, select))
    x, w0, b0, w1, b1 = map(jnp.asarray, arrs)
    want = np.asarray(_xla_stage(_xla_stage(x, w0, b0), w1, b1))
    err = np.abs(got.numpy() - want)
    assert err.max() <= 2.0 ** -7 * np.abs(want).max(), err.max()
    small = _torch_pair_args(_pair_inputs(9, 1, 32, 32, 3, 16, 32, True))
    assert torch.equal(fn(*small, "default", torch.float32),
                       fused_stem_pair_plain(*small, "default",
                                             torch.float32, select))


def test_deep_pair_select_only_at_default():
    """The deep pair's K8 select moves values at "default" (hi + bf16(v -
    hi) after each stage) and is exact, so absent, at "highest"."""
    args = _torch_pair_args(_pair_inputs(3, 1, 16, 16, 8, 16, 24, False))
    deep = stem.fused_stem_pair_deep_plain
    for precision in ("default", "highest"):
        plain = deep(*args, precision, torch.float32)
        sel = deep(*args, precision, torch.float32, select=True)
        if precision == "highest":
            assert torch.equal(sel, plain)
        else:
            assert not torch.equal(sel, plain)
            assert torch.allclose(sel, plain, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("widths,smem,route", [
    ((3, 16, 32), 58416, "pair"),
    ((5, 24, 40), 99120, "pair"),
    ((16, 32, 64), 226432, "pair"),
    ((16, 32, 72), 235680, "deep"),
    ((32, 64, 128), 637184, "deep")])
def test_highest_tile_footprint(widths, smem, route):
    """At "highest" ``_tile_fits`` mirrors csrc/stem.cu:pair_smem_bytes
    with one halo buffer (biases, both float32 weight sets, the 18x18
    intermediate, a 38x38 halo; the bytes here worked out from that
    formula): the pair where they fit the 232,448 bytes a block may have,
    else the deep pair."""
    assert stem._pair_highest_bytes(*widths) == smem
    assert stem._tile_fits(*widths, "highest") == (smem <= 232448)
    assert stem.pair_route(*widths, "highest") == route


@pytest.mark.parametrize("widths,h", [((3, 16, 32), 32),
                                      ((32, 64, 128), 24)])
def test_pair_f64_reference(widths, h):
    """``fused_stem_pair_f64``, the float64 yardstick the card holds the
    pairs' "highest" rounding to, agrees with the JAX package's two
    float32 XLA stages within 1e-5 of the largest output, and so do both
    plain versions at "highest" (the stem pair's and the deep pair's)."""
    arrs = _pair_inputs(11, 2, h, h, *widths, False)
    x, w0, b0, w1, b1 = map(jnp.asarray, arrs)
    want = np.asarray(_xla_stage(_xla_stage(x, w0, b0), w1, b1))
    args = _torch_pair_args(arrs)
    ref = stem.fused_stem_pair_f64(*args)
    assert ref.dtype == torch.float64 and ref.shape == want.shape
    scale = np.abs(want).max()
    for got in (ref, fused_stem_pair_plain(*args, "highest", torch.float32),
                stem.fused_stem_pair_deep_plain(*args, "highest",
                                                torch.float32)):
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * scale, err
