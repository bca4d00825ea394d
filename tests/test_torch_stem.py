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

from millieye_torch.ops.stem import (fused_stem_pair, fused_stem_pair_plain,
                                     fused_stem_stage, fused_stem_stage_plain)
from millieye_tpu.ops.stem_pallas import fused_stem2_phase, fused_stem_planar

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
