"""Port parity: kernel K10's plain version
(millieye_torch/ops/stem.py:fused_stem) against the JAX package's
``stem_pallas.py:fused_stem`` in interpret mode, at the shapes of
tests/test_stem_pallas.py, for each patch-build variant.

Tolerance: the plain version sums the float32 products one at a time in
the variant's tap order; the interpreter's HIGHEST-precision dots sum
them in XLA:CPU's order -> within 1e-5 of the output's largest value. A
float16 or bf16 store rounds that float32 value once, so the stored
values agree within one unit in the last place of the store type.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.ops import stem as tstem
from millieye_tpu.ops.stem_pallas import fused_stem as jax_fused_stem

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, h, w, cin)).astype(np.float32),
            (0.3 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32),
            (0.1 * rng.standard_normal(cout)).astype(np.float32))


@pytest.mark.parametrize("variant", ["vconcat", "vroll", "im2col"])
@pytest.mark.parametrize("shape,th", [((2, 32, 32, 3, 16), 8),
                                      ((1, 64, 48, 5, 8), 16)])
def test_plain_fused_stem_matches_pallas(variant, shape, th):
    x, w, b = _inputs(*shape)
    want = np.asarray(jax_fused_stem(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), th=th, interpret=True,
                                     variant=variant))
    got = tstem.fused_stem(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), th=th, variant=variant)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the row band changes nothing
    assert torch.equal(got, tstem.fused_stem(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        th=th // 2, variant=variant))


@pytest.mark.parametrize("out_dtype,jdt", [(torch.float16, jnp.float16),
                                           (torch.bfloat16, jnp.bfloat16)])
def test_plain_fused_stem_out_dtype(out_dtype, jdt):
    """float32 arithmetic, one rounding to the store type (the Pallas
    kernel stores float16 through float32 and a cast)."""
    x, w, b = _inputs(1, 16, 16, 3, 4, seed=1)
    want = np.asarray(jax_fused_stem(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), th=8, interpret=True,
                                     out_dtype=jdt).astype(jnp.float32))
    got = tstem.fused_stem(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), th=8, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (1, 8, 8, 4)
    ulp = 2.0 ** -(10 if out_dtype == torch.float16 else 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ulp, atol=0)
    # the default store type is the input's
    assert tstem.fused_stem(torch.from_numpy(x).to(out_dtype),
                            torch.from_numpy(w), torch.from_numpy(b),
                            th=8).dtype == out_dtype


def test_fused_stem_rejects_what_jax_rejects():
    """The JAX wrapper's asserts and its unknown-variant error."""
    x, w, b = _inputs(1, 16, 16, 3, 4)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    for kw, jax_err in [({"variant": "vshift"}, ValueError),
                        ({"th": 3}, AssertionError)]:
        with pytest.raises(ValueError):
            tstem.fused_stem(tx, tw, tb, **{"th": 8, **kw})
        with pytest.raises(jax_err):
            jax_fused_stem(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           interpret=True, **{"th": 8, **kw})
    with pytest.raises(ValueError, match="weights"):
        tstem.fused_stem(tx, tw[:, :, :2], tb, th=8)       # Cin mismatch
    with pytest.raises(ValueError, match="even"):
        tstem.fused_stem(tx[:, :15], tw, tb, th=1)          # odd H
    with pytest.raises(TypeError, match="cannot store"):
        tstem.fused_stem(tx, tw, tb, th=8, out_dtype=torch.int8)


@pytest.mark.parametrize("variant", ["vconcat", "vroll", "im2col"])
@pytest.mark.parametrize("cin", [96, 130])
def test_plain_fused_stem_matches_pallas_wide(variant, cin):
    """Wide inputs, which the JAX function takes: the plain version, which
    both of the card's routes repeat bit for bit, against it at 8 x 8 px,
    12 outputs, th 2."""
    x, w, b = _inputs(1, 8, 8, cin, 12, seed=cin)
    want = np.asarray(jax_fused_stem(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), th=2, interpret=True,
                                     variant=variant))
    got = tstem.fused_stem(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), th=2, variant=variant)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cin,cout,route", [
    (3, 16, "resident"), (16, 32, "resident"), (93, 4, "resident"),
    (120, 12, "resident"), (128, 12, "streamed"), (128, 33, "streamed"),
    (128, 256, "streamed"), (256, 12, "streamed"), (1024, 4, "streamed")])
def test_nhwc_route_by_shape(cin, cout, route):
    """K10's kernel on the card, by channel counts: the stem's stages and
    widths whose weights and 8 x 8 tile halo fit shared memory keep them
    resident; the rest stream the weights (block 8: 128 -> 256)."""
    assert tstem.nhwc_route(cin, cout) == route
