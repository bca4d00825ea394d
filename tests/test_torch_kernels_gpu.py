"""The CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip. This file imports
no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Every kernel is bit-equal to its plain version: each plain version
repeats its kernel's operations in the kernel's order (products of bf16
operands are exact in float32, so the kernels' FMAs round like the plain
versions' adds; where operands are float32, at "highest", the kernels
round each product before its add, as eager PyTorch does). One
exception: the stem pair at precision "default" (K4, K8, K11, K12 at the
stem shape) runs on the tensor cores, which sum each k-group in an order
and with a rounding no PyTorch spelling repeats; it is held within
``PAIR_DEFAULT_TOL`` (2^-6) of its plain version's largest output, with a
floor on the share of outputs that are bit-equal (``_PAIR_EXACT_FLOOR``).
"""
import numpy as np
import pytest
import torch

from millieye_torch.device import set_numerics
from millieye_torch.ops import nms as tnms
from millieye_torch.ops.nms_kernel import (nms_keep_mask_blocked,
                                           nms_keep_mask_blocked_plain,
                                           nms_keep_mask_full,
                                           nms_keep_mask_full_plain)
from millieye_torch.ops.roi_align import _batched_prep
from millieye_torch.ops.roi_kernel import (ps_channel_perm_pad,
                                           ps_roi_align_f32_kernel,
                                           ps_roi_align_f32_plain,
                                           ps_roi_align_padded_f32_kernel,
                                           ps_roi_align_padded_kernel,
                                           ps_roi_align_padded_plain,
                                           ps_roi_align_padded_vpu_kernel,
                                           roi_align_f32_plain,
                                           roi_align_kernel, roi_align_plain)
from millieye_torch.ops import quantize as tq
from millieye_torch.ops.stem import (PAIR_DEFAULT_TOL, fused_stem,
                                     fused_stem_plain,
                                     fused_stem_pair, fused_stem_pair_deep,
                                     fused_stem_pair_deep_plain,
                                     fused_stem_pair_packed,
                                     fused_stem_pair_plain,
                                     fused_stem_pair_s2d,
                                     fused_stem_pair_select,
                                     fused_stem_stage, fused_stem_stage_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_numerics()
    return torch.device("cuda")


@pytest.mark.parametrize("b,k", [(1, 128), (4, 256), (2, 1024)])
def test_nms_kernel_bit_equal(cuda, b, k):
    rng = np.random.default_rng(k)
    c = rng.uniform(0, 100, (b, k, 2))
    wh = rng.uniform(5, 60, (b, k, 2))
    boxes = torch.tensor(np.concatenate([c - wh / 2, c + wh / 2], -1),
                         dtype=torch.float32, device=cuda)
    boxes[:, 5] = boxes[:, 4]                    # an exact duplicate
    valid = torch.tensor(rng.random((b, k)) < 0.9, device=cuda)
    for t in (0.5, 0.3):
        before = nms_keep_mask_blocked.launches
        got = nms_keep_mask_blocked(boxes, valid, t)
        assert nms_keep_mask_blocked.launches == before + 1
        assert torch.equal(got, nms_keep_mask_blocked_plain(boxes, valid, t))


@pytest.mark.parametrize("b,k", [(1, 512), (3, 135), (2, 1024), (2, 33)])
def test_nms_full_kernel_bit_equal(cuda, b, k):
    """K5 at any K, against its plain version and the sequential golden."""
    rng = np.random.default_rng(k)
    c = rng.uniform(0, 100, (b, k, 2))
    wh = rng.uniform(5, 60, (b, k, 2))
    boxes = torch.tensor(np.concatenate([c - wh / 2, c + wh / 2], -1),
                         dtype=torch.float32, device=cuda)
    boxes[:, 5] = boxes[:, 4]                    # an exact duplicate
    valid = torch.tensor(rng.random((b, k)) < 0.9, device=cuda)
    for t in (0.5, 0.3):
        before = nms_keep_mask_full.launches
        got = nms_keep_mask_full(boxes, valid, t)
        assert nms_keep_mask_full.launches == before + 1
        assert torch.equal(got, nms_keep_mask_full_plain(boxes, valid, t))
        assert torch.equal(got[0], tnms.nms_keep_mask_ref(boxes[0], valid[0],
                                                          t))


def test_batched_nms_takes_a_kernel_at_any_k(cuda):
    """On the card no K <= 1024 reaches the Python fixpoint loop: K % 128
    == 0 launches K1 (K5 when use_blocked is False), any other K K5."""
    rng = np.random.default_rng(3)
    pred = torch.tensor(rng.uniform(0, 1, (2, 300, 17)), dtype=torch.float32,
                        device=cuda)
    pred[..., :4] = pred[..., :4] * 60 + 20
    for k, blocked, want in ((128, None, (1, 0)), (128, False, (0, 1)),
                             (135, None, (0, 1))):
        n1, n5 = nms_keep_mask_blocked.launches, nms_keep_mask_full.launches
        tnms.batched_nms(pred, 0.2, 0.5, max_det=64, pre_top_k=k,
                         use_blocked=blocked)
        assert (nms_keep_mask_blocked.launches - n1,
                nms_keep_mask_full.launches - n5) == want


def _roi_inputs(cuda, rng, b, n, hw, c_feat, ps, dtype=torch.bfloat16):
    feats = torch.tensor(rng.standard_normal((b, hw, hw, c_feat)),
                         dtype=dtype, device=cuda)
    xy = rng.uniform(-20, 13 * hw, (b, n, 2))
    boxes = torch.tensor(np.concatenate(
        [xy, xy + rng.uniform(2, 10 * hw, (b, n, 2))], -1),
        dtype=torch.float32, device=cuda)
    by, bx = _batched_prep(boxes, hw, hw, (7, 7), 1 / 16,
                           -0.5 if ps else 0.0, 0.1 if ps else 1.0, -1, 4)
    return feats, by.to(dtype).contiguous(), bx.to(dtype).contiguous()


@pytest.mark.parametrize("b,n,hw", [(1, 96, 26), (3, 20, 13)])
def test_roi_kernels_match_plain(cuda, b, n, hw):
    rng = np.random.default_rng(n)
    f, by, bx = _roi_inputs(cuda, rng, b, n, hw, 7 * 128, True)
    want = ps_roi_align_padded_plain(f, by, bx, 10)
    assert torch.equal(ps_roi_align_padded_kernel(f, by, bx, 10), want)
    before = ps_roi_align_padded_vpu_kernel.launches
    assert torch.equal(ps_roi_align_padded_vpu_kernel(f, by, bx, 10), want)
    assert ps_roi_align_padded_vpu_kernel.launches == before + 1
    f, by, bx = _roi_inputs(cuda, rng, b, n, hw, 10, False)
    assert torch.equal(roi_align_kernel(f, by, bx),
                       roi_align_plain(f, by, bx))


@pytest.mark.parametrize("case", ["whole_frame", "sub_cell",
                                  "partly_outside", "wholly_outside",
                                  "negative_map", "non_square"])
def test_k2_bit_equal_on_support_edge_cases(cuda, case):
    """K2 ("dot" and "vpu") sums only the nonzero spans of by and bx: on
    RoIs that span the whole frame, fall below one cell, or lie partly or
    wholly outside the map, on a negative map and on a 13x21 map (its
    shared-memory t buffer off the square maps' alignment), it stays
    bit-equal to its plain version."""
    rng = np.random.default_rng(len(case))
    b, n = 2, 96
    hh, ww = (13, 21) if case == "non_square" else (26, 26)
    xy = rng.uniform(-20, 380, (b, n, 2))
    wh = rng.uniform(4, 300, (b, n, 2))
    if case == "whole_frame":
        xy, wh = rng.uniform(-2, 2, (b, n, 2)), np.full((b, n, 2), 416.0)
    elif case == "sub_cell":
        wh = rng.uniform(0.5, 12, (b, n, 2))
    elif case == "partly_outside":
        xy = np.where(rng.random((b, n, 2)) < 0.5,
                      rng.uniform(-100, -40, (b, n, 2)),
                      rng.uniform(330, 400, (b, n, 2)))
        wh = rng.uniform(120, 300, (b, n, 2))
    elif case == "wholly_outside":
        xy = rng.choice([-1.0, 1.0], (b, n, 2)) * 500 + 208
        wh = rng.uniform(10, 60, (b, n, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], -1),
                         dtype=torch.float32, device=cuda)
    by, bx = _batched_prep(boxes, hh, ww, (7, 7), 1 / 16, -0.5, 0.1, -1, 4)
    by, bx = by.to(torch.bfloat16), bx.to(torch.bfloat16)
    f = rng.standard_normal((b, hh, ww, 7 * 128))
    if case == "negative_map":
        f = -np.abs(f)
    f = torch.tensor(f, dtype=torch.bfloat16, device=cuda)
    want = ps_roi_align_padded_plain(f, by, bx, 10)
    assert torch.equal(ps_roi_align_padded_kernel(f, by, bx, 10), want)
    assert torch.equal(ps_roi_align_padded_vpu_kernel(f, by, bx, 10), want)


@pytest.mark.parametrize("precision", ["default", "split", "highest"])
@pytest.mark.parametrize("b,n,hw", [(1, 200, 26), (3, 20, 13)])
def test_roi_f32_kernels_match_plain(cuda, precision, b, n, hw):
    """K6 (both channel orders and the bin-free layout), K7 and K3's
    float32 mode, at each rung of the precision ladder."""
    rng = np.random.default_rng(n)
    f32 = torch.float32
    f, by, bx = _roi_inputs(cuda, rng, b, n, hw, 490, True, f32)
    for layout in ("upq", "puq"):
        before = ps_roi_align_f32_kernel.launches
        got = ps_roi_align_f32_kernel(f, by, bx, 10, precision, layout)
        assert ps_roi_align_f32_kernel.launches == before + 1
        assert torch.equal(got, ps_roi_align_f32_plain(f, by, bx, 10,
                                                       precision, layout))
    fpad = torch.zeros((b, hw, hw, 7 * 128), device=cuda)
    fpad[..., torch.as_tensor(ps_channel_perm_pad(10, 7, 7), device=cuda)] = f
    got = ps_roi_align_padded_f32_kernel(fpad, by, bx, 10, precision)
    assert torch.equal(got, ps_roi_align_f32_plain(fpad, by, bx, 10,
                                                   precision, "padded"))
    # the padded map holds the same numbers as the "upq" one
    assert torch.equal(got, ps_roi_align_f32_kernel(f, by, bx, 10, precision,
                                                    "upq"))
    f, by, bx = _roi_inputs(cuda, rng, b, n, hw, 10, False, f32)
    want = roi_align_f32_plain(f, by, bx, precision)
    assert torch.equal(ps_roi_align_f32_kernel(f, by, bx, 10, precision, "c"),
                       want)
    if precision != "default":
        assert torch.equal(roi_align_kernel(f, by, bx, precision), want)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((1, 416, 416, 3, 16), torch.float16),
    ((2, 208, 208, 16, 32), torch.float16),
    ((2, 104, 104, 32, 64), torch.bfloat16),
    ((1, 52, 52, 64, 128), torch.float32),
    ((2, 20, 36, 5, 40), torch.float32)])
def test_stem_stage_kernel_matches_plain(cuda, precision, shape, out_dtype):
    """K9 at the four stage shapes of the 416 px network (52 rows is a
    ragged tile) and an odd one (40 output channels: a partial slice)."""
    n, h, w, cin, cout = shape
    g = torch.Generator(device="cpu").manual_seed(h + cin)
    x = torch.randn((n, h, w, cin), generator=g).to(cuda)
    wt = (0.2 * torch.randn((cout, cin, 3, 3), generator=g)).to(cuda)
    bs = (0.1 * torch.randn(cout, generator=g)).to(cuda)
    before = fused_stem_stage.launches
    got = fused_stem_stage(x, wt, bs, precision, out_dtype)
    assert fused_stem_stage.launches == before + 1
    assert got.dtype == out_dtype
    assert torch.equal(got, fused_stem_stage_plain(x, wt, bs, precision,
                                                   out_dtype))


# the share of outputs of the tensor-core pair ("default") that must be
# bit-equal to the plain version, by store type (each case prints its
# share; run with -s): with a 16-bit store 0.9979 or more on an H100; a
# float32 store shows every difference of the tensor cores' sums
_PAIR_EXACT_FLOOR = {torch.float16: 0.99, torch.bfloat16: 0.99,
                     torch.float32: 0.02}


def _held_to_pair_plain(got, want, precision):
    """The pair's contract: bit-equal at "highest"; within
    PAIR_DEFAULT_TOL of the largest plain output at "default", with the
    exact share above its floor."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if precision == "highest":
        assert torch.equal(got, want)
        return
    err = float((got.float() - want.float()).abs().max())
    assert err <= PAIR_DEFAULT_TOL * float(want.float().abs().max()), err
    exact = float((got == want).double().mean())
    print(f"pair exact share {exact:.5f}, error 2^"
          f"{np.log2(max(err, 1e-30) / float(want.float().abs().max())):.2f}"
          f" of the largest output, {got.dtype}, {tuple(got.shape)}")
    assert exact >= _PAIR_EXACT_FLOOR[got.dtype], exact


@pytest.mark.parametrize("shape", [(1, 416, 416, 3, 16, 32),
                                   (2, 96, 96, 3, 16, 32),
                                   (1, 32, 48, 3, 8, 16)])
def test_stem_kernel_matches_plain(cuda, shape):
    n, h, w, cin, cmid, cout = shape
    g = torch.Generator(device="cpu").manual_seed(h)
    x = torch.rand((n, h, w, cin), generator=g).to(cuda)
    w0 = (0.3 * torch.randn((cmid, cin, 3, 3), generator=g)).to(cuda)
    b0 = (0.1 * torch.randn(cmid, generator=g)).to(cuda)
    w1 = (0.3 * torch.randn((cout, cmid, 3, 3), generator=g)).to(cuda)
    b1 = (0.1 * torch.randn(cout, generator=g)).to(cuda)
    _held_to_pair_plain(fused_stem_pair(x, w0, b0, w1, b1),
                        fused_stem_pair_plain(x, w0, b0, w1, b1), "default")


def _pair_weights(cuda, n, h, w, cin, cmid, cout):
    g = torch.Generator(device="cpu").manual_seed(h + cin)
    x = torch.rand((n, h, w, cin), generator=g).to(cuda)
    w0 = (0.3 * torch.randn((cmid, cin, 3, 3), generator=g)).to(cuda)
    b0 = (0.1 * torch.randn(cmid, generator=g)).to(cuda)
    w1 = (0.3 * torch.randn((cout, cmid, 3, 3), generator=g)).to(cuda)
    b1 = (0.1 * torch.randn(cout, generator=g)).to(cuda)
    return x, w0, b0, w1, b1


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((1, 416, 416, 3, 16, 32), torch.float16),
    ((2, 96, 96, 3, 16, 32), torch.bfloat16),
    ((1, 32, 48, 3, 8, 16), torch.float32),
    ((1, 64, 40, 5, 24, 40), torch.bfloat16)])
def test_stem_pair_wrappers_match_plain(cuda, precision, shape, out_dtype):
    """K4, K8, K11 and K12 at the stem widths and at odd ones (Cmid 24:
    a padded 16-channel slice; Cout 40: a partial group of n-tiles), at
    both precisions, each counting its own launches; K8 is its own pool
    mode at "default". The four wrappers launch one kernel: bit-identical
    to one another."""
    args = _pair_weights(cuda, *shape)
    want = fused_stem_pair_plain(*args, precision, out_dtype)
    k4 = fused_stem_pair(*args, precision, out_dtype)
    for fn, select in ((fused_stem_pair, False),
                       (fused_stem_pair_select, precision == "default"),
                       (fused_stem_pair_packed, False),
                       (fused_stem_pair_s2d, False)):
        if fn is fused_stem_pair_select and shape[1] % 32:
            continue
        before = fn.launches
        got = fn(*args, precision, out_dtype)
        assert fn.launches == before + 1
        _held_to_pair_plain(got, fused_stem_pair_plain(
            *args, precision, out_dtype, select) if select else want,
            precision)
        if not select:
            assert torch.equal(got, k4)


def test_stem_pair_is_batch_independent(cuda):
    """The tensor-core pair walks its tiles on a persistent grid, in an
    order that depends on the batch (4 frames of 416 px: 676 tiles, more
    than the card holds blocks at once): each image's output must not."""
    x, w0, b0, w1, b1 = _pair_weights(cuda, 4, 416, 416, 3, 16, 32)
    got = fused_stem_pair(x, w0, b0, w1, b1)
    for i in range(x.shape[0]):
        assert torch.equal(got[i:i + 1],
                           fused_stem_pair(x[i:i + 1], w0, b0, w1, b1))


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((2, 104, 104, 32, 64, 128), torch.bfloat16),
    ((1, 20, 36, 8, 24, 40), torch.float32)])
def test_deep_pair_kernel_matches_plain(cuda, precision, shape, out_dtype):
    """The deep pair kernel at stages 4+6 of the 416 px network (26 output
    rows: a ragged 4x4 tile) and at odd widths (channel chunks of 8 with a
    40-channel output), through K12's wrapper where the pair kernel's
    shared memory does not hold the weights."""
    args = _pair_weights(cuda, *shape)
    want = fused_stem_pair_deep_plain(*args, precision, out_dtype)
    before = fused_stem_pair_deep.launches
    assert torch.equal(fused_stem_pair_deep(*args, precision, out_dtype),
                       want)
    if shape[3] == 32:
        n_s2d = fused_stem_pair_s2d.launches
        assert torch.equal(fused_stem_pair_s2d(*args, precision, out_dtype,
                                               groups0=2), want)
        assert fused_stem_pair_s2d.launches == n_s2d
        assert fused_stem_pair_deep.launches == before + 2


@pytest.mark.parametrize("variant", ["vconcat", "vroll", "im2col"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((2, 416, 416, 3, 16), torch.float16),
    ((2, 208, 208, 16, 32), torch.float16),
    ((1, 64, 48, 5, 8), torch.bfloat16),
    ((1, 20, 36, 70, 44), torch.float32)])
def test_fused_stem_kernel_matches_plain(cuda, variant, shape, out_dtype):
    """K10 at the stem's two stage shapes, an odd one and a wide one (70
    input channels: past the 48 KB shared-memory default; 44 outputs: a
    partial slice and a partial channel group)."""
    n, h, w, cin, cout = shape
    g = torch.Generator(device="cpu").manual_seed(h + cin)
    x = torch.randn((n, h, w, cin), generator=g).to(cuda)
    wt = (0.2 * torch.randn((3, 3, cin, cout), generator=g)).to(cuda)
    bs = (0.1 * torch.randn(cout, generator=g)).to(cuda)
    before = fused_stem.launches
    got = fused_stem(x, wt, bs, th=2, out_dtype=out_dtype, variant=variant)
    assert fused_stem.launches == before + 1
    assert got.dtype == out_dtype
    assert torch.equal(got, fused_stem_plain(x, wt, bs, 2, out_dtype,
                                             variant))


@pytest.mark.parametrize("shape,row_tile", [((8, 128), 512),
                                            ((4608, 1024), 512),
                                            ((1030, 130), 256),
                                            ((5, 3), 2)])
def test_quantize_stochastic_kernel_matches_plain(cuda, shape, row_tile):
    """K13 on the carrier of benchmarks/quantize_tpu_check.py, block 12's
    weight shape (9 tiles), a ragged last tile and a tiny tail: the same
    Philox words and roundings as the plain version."""
    g = torch.Generator(device="cpu").manual_seed(shape[0])
    w = torch.randn(shape, generator=g).to(cuda)
    for seed in (0, 7, -3):
        before = tq.quantize_int8_stochastic.launches
        q, s = tq.quantize_int8_stochastic(w, seed, row_tile)
        assert tq.quantize_int8_stochastic.launches == before + 1
        wq, ws = tq.quantize_int8_stochastic_plain(w, seed, row_tile)
        assert q.dtype == torch.int8 and torch.equal(s, ws)
        assert torch.equal(q, wq)


@pytest.mark.parametrize("shape,k,stride", [((1, 512, 13, 13), 3, 1),
                                            ((4, 130, 9, 7), 3, 2),
                                            ((2, 256, 26, 26), 1, 1)])
def test_int8_conv_on_card_equals_cpu(cuda, shape, k, stride):
    """The int8 x int8 -> int32 convolution through torch._int_mm on the
    card is the exact integer result the CPU computes."""
    g = torch.Generator(device="cpu").manual_seed(shape[1])
    zq = torch.randint(-127, 128, shape, dtype=torch.int8, generator=g)
    q = torch.randint(-127, 128, (shape[1] * 2, shape[1], k, k),
                      dtype=torch.int8, generator=g)
    want = tq.int8_conv2d(zq, q, stride, k // 2)
    got = tq.int8_conv2d(zq.to(cuda), q.to(cuda), stride, k // 2)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_wrappers_refuse_wrong_inputs(cuda):
    with pytest.raises(TypeError):
        nms_keep_mask_blocked(torch.zeros((1, 128, 4), dtype=torch.float16,
                                          device=cuda),
                              torch.ones((1, 128), dtype=torch.bool,
                                         device=cuda), 0.5)
    with pytest.raises(ValueError):
        nms_keep_mask_blocked(torch.zeros((1, 96, 4), device=cuda),
                              torch.ones((1, 96), dtype=torch.bool,
                                         device=cuda), 0.5)
    with pytest.raises(ValueError):
        nms_keep_mask_full(torch.zeros((1, 1025, 4), device=cuda),
                           torch.ones((1, 1025), dtype=torch.bool,
                                      device=cuda), 0.5)
    with pytest.raises(TypeError):
        ps_roi_align_f32_kernel(
            torch.zeros((1, 13, 13, 490), dtype=torch.bfloat16, device=cuda),
            torch.zeros((1, 4, 7, 13), device=cuda),
            torch.zeros((1, 4, 7, 13), device=cuda), 10)
    with pytest.raises(ValueError):
        fused_stem_stage(torch.zeros((1, 32, 32, 3), device=cuda),
                         torch.zeros((12, 3, 3, 3), device=cuda),
                         torch.zeros(12, device=cuda))
    with pytest.raises(TypeError):
        fused_stem_pair(torch.zeros((1, 32, 32, 3), dtype=torch.float16,
                                    device=cuda),
                        *(torch.zeros(s, device=cuda) for s in
                          ((8, 3, 3, 3), (8,), (8, 8, 3, 3), (8,))))
    with pytest.raises(ValueError):            # deep widths: no fit
        fused_stem_pair(*_pair_weights(cuda, 1, 32, 32, 32, 64, 128))
    with pytest.raises(ValueError):            # H % 32 for K8
        fused_stem_pair_select(*_pair_weights(cuda, 1, 20, 32, 3, 8, 16))
    with pytest.raises(ValueError):            # too wide for shared memory
        fused_stem(torch.zeros((1, 8, 8, 93), device=cuda),
                   torch.zeros((3, 3, 93, 8), device=cuda),
                   torch.zeros(8, device=cuda), th=1)
