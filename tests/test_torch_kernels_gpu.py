"""The CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip. This file imports
no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Every kernel is bit-equal to its plain version: each plain version
repeats its kernel's operations in the kernel's order (products of bf16
operands are exact in float32, so the kernels' FMAs round like the plain
versions' adds; where operands are float32, at "highest", the kernels
round each product before its add, as eager PyTorch does). The
exception: at precision "default" the stem pair (K4, K8, K11, K12), the
deep pair and the single stage K9 run on the tensor cores, which sum
each k-group in an order and with a rounding no PyTorch spelling
repeats; they are held within ``PAIR_DEFAULT_TOL`` (2^-6) of their plain
versions' largest output, with a floor on the share of outputs that are
bit-equal (``_PAIR_EXACT_FLOOR``).
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
                                           roi_align_group,
                                           roi_align_kernel, roi_align_plain)
from millieye_torch.ops import quantize as tq
from millieye_torch.ops import stem
from millieye_torch.ops.stem import (PAIR_DEFAULT_TOL, fused_stem,
                                     fused_stem_plain,
                                     fused_stem_pair, fused_stem_pair_deep,
                                     fused_stem_pair_deep_plain,
                                     fused_stem_pair_f64,
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


def _nms_pattern_inputs(rng, b, k, pattern, device):
    """Clustered score-sorted boxes [b, k, 4] with exact duplicates and
    zero-area rows (a zero width, a zero height, a point), and valid
    [b, k] as the pattern says: a prefix of random length per image (the
    serving shape), random at 85%, all false, only the last row, only the
    first row."""
    c = rng.uniform(0, 100, (b, k, 2))
    wh = rng.uniform(5, 60, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes[:, 5] = boxes[:, 4]
    boxes[:, 7, 2] = boxes[:, 7, 0]
    boxes[:, 9, 3] = boxes[:, 9, 1]
    boxes[:, 11, 2:] = boxes[:, 11, :2]
    boxes[:, 12] = boxes[:, 11]
    if pattern == "prefix":
        valid = np.arange(k)[None] < rng.integers(0, k + 1, (b, 1))
    elif pattern == "random":
        valid = rng.random((b, k)) < 0.85
    else:
        valid = np.zeros((b, k), bool)
        if pattern != "all_false":
            valid[:, -1 if pattern == "last" else 0] = True
    return (torch.tensor(boxes, device=device),
            torch.tensor(valid, device=device))


@pytest.mark.parametrize("k", [96, 128, 135, 232, 512, 1024])
@pytest.mark.parametrize("b", [1, 8, 32, 200])
def test_nms_kernels_valid_patterns(cuda, b, k):
    """K5 at every K, and K1 where K % 128 == 0, against their plain
    versions on every valid pattern, at thresholds 0.5, 0.3 and -0.2
    (below every IoU: the kernels' inter == 0 shortcut must not apply),
    one launch a call, at batch 1 and 8 (8 CTAs an image), 32 (4) and 200
    (more images than the SMs: one CTA an image); the first and last
    images also against the sequential golden."""
    rng = np.random.default_rng(1000 * b + k)
    kernels = [(nms_keep_mask_full, nms_keep_mask_full_plain)]
    if k % 128 == 0:
        kernels.append((nms_keep_mask_blocked, nms_keep_mask_blocked_plain))
    for pattern in ("prefix", "random", "all_false", "last", "first"):
        boxes, valid = _nms_pattern_inputs(rng, b, k, pattern, cuda)
        for t in (0.5, 0.3, -0.2):
            want = nms_keep_mask_full_plain(boxes, valid, t)
            for i in {0, b - 1}:
                assert torch.equal(want[i], tnms.nms_keep_mask_ref(
                    boxes[i], valid[i], t)), (pattern, t, i)
            for kern, plain in kernels:
                before = kern.launches
                got = kern(boxes, valid, t)
                assert kern.launches == before + 1
                assert torch.equal(got, plain(boxes, valid, t)), (
                    kern.__name__, pattern, t)
                assert torch.equal(got, want), (kern.__name__, pattern, t)


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


def _knife_edge_rows(rng, k, t):
    """k score-sorted boxes: clusters, exact duplicates and adjacent pairs
    whose float32 IoU (the reference's expression order) lies on the
    other side of t than the exact IoU (tests/test_torch_nms.py's
    knife-edge cases)."""
    m = 20000
    xy = rng.uniform(0, 5000, (m, 2))
    a = np.concatenate([xy, xy + rng.uniform(5, 30, (m, 2))], -1).astype(
        np.float32)
    d = (a[:, 2] - a[:, 0]) * (1 - 2 * t / (1 + t)) * (
        1 + rng.normal(0, 3e-7, m))
    bb = (a + np.stack([d, 0 * d, d, 0 * d], -1)).astype(np.float32)

    def iou(p, q, dt):
        p, q = p.astype(dt), q.astype(dt)
        inter = (np.maximum(np.minimum(p[:, 2], q[:, 2])
                            - np.maximum(p[:, 0], q[:, 0]), dt(0))
                 * np.maximum(np.minimum(p[:, 3], q[:, 3])
                              - np.maximum(p[:, 1], q[:, 1]), dt(0)))
        ua = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])
        ub = (q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1])
        return inter / (ua + ub - inter + dt(1e-16))

    edge = (iou(a, bb, np.float32) > t) != (iou(a, bb, np.float64) > t)
    c = rng.uniform(0, 80, (k, 2))
    wh = rng.uniform(10, 60, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    n = k // 8
    boxes[0:2 * n:2], boxes[1:2 * n:2] = a[edge][:n], bb[edge][:n]
    dup = rng.choice(np.arange(k // 2 + 1, k), k // 8, replace=False)
    boxes[dup] = boxes[dup - 1]
    return boxes


@pytest.mark.parametrize("k,plus_one", [(96, False), (232, False),
                                        (128, False), (96, True)])
def test_nms_xyxy_takes_a_kernel(cuda, k, plus_one):
    """The post-merge NMS on the card: K5 at the engine's K (64 + 32 and
    200 + 32 rows), K1 at K % 128 == 0, neither with plus_one (K5's plain
    version, no launch); the keep set bit-equal to the sequential golden
    on knife-edge IoUs, at thresholds 0.5 and 0.3."""
    rng = np.random.default_rng(k)
    for t in (0.5, 0.3):
        boxes = torch.tensor(_knife_edge_rows(rng, k, t), device=cuda)
        scores = torch.tensor(np.round(rng.uniform(0, 1, k) * 20) / 20,
                              dtype=torch.float32, device=cuda)
        labels = torch.tensor(rng.integers(0, 3, k), dtype=torch.int32,
                              device=cuda)
        valid = torch.tensor(rng.random(k) < 0.85, device=cuda)
        n1, n5 = nms_keep_mask_blocked.launches, nms_keep_mask_full.launches
        rows, rvalid = tnms.nms_xyxy(boxes, scores, labels, valid, t, k,
                                     plus_one)
        want = (0, 0) if plus_one else (1, 0) if k % 128 == 0 else (0, 1)
        assert (nms_keep_mask_blocked.launches - n1,
                nms_keep_mask_full.launches - n5) == want
        # the golden: the same sort and class offset, the sequential keep
        s = torch.where(valid, scores, torch.full_like(scores, -np.inf))
        order = torch.argsort(-s, stable=True)
        ob, os_, ol = boxes[order], s[order], labels[order]
        ov = torch.isfinite(os_)
        shifted = ob + (ol.float() * tnms._class_offset(ob, ov))[:, None]
        keep = tnms.nms_keep_mask_ref(shifted, ov, t, plus_one)
        n_keep = int(keep.sum())
        assert int(rvalid.sum()) == n_keep and bool(rvalid[:n_keep].all())
        assert torch.equal(rows[rvalid][:, :4], ob[keep])


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


_SUPPORT_CASES = ["whole_frame", "sub_cell", "partly_outside",
                  "wholly_outside", "negative_map", "non_square"]


def _support_case(cuda, case, rng, b, n):
    """RoIs of one kind, [B, N, 4] xyxy on the card, and the map's size:
    every RoI the whole frame, below one cell, across an edge, wholly
    outside; random RoIs on "negative_map" and on a 13x21 map."""
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
    return torch.tensor(np.concatenate([xy, xy + wh], -1),
                        dtype=torch.float32, device=cuda), (hh, ww)


@pytest.mark.parametrize("case", _SUPPORT_CASES)
def test_k2_bit_equal_on_support_edge_cases(cuda, case):
    """K2 ("dot" and "vpu") sums only the nonzero spans of by and bx: on
    RoIs that span the whole frame, fall below one cell, or lie partly or
    wholly outside the map, on a negative map and on a 13x21 map (its
    shared-memory t buffer off the square maps' alignment), it stays
    bit-equal to its plain version."""
    rng = np.random.default_rng(len(case))
    b, n = 2, 96
    boxes, (hh, ww) = _support_case(cuda, case, rng, b, n)
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
    f, by, bx = _roi_inputs(cuda, rng, b, n, hw, 490, True, torch.float32)
    fc, ry, rx = _roi_inputs(cuda, rng, b, n, hw, 10, False, torch.float32)
    _roi_f32_layouts(cuda, f, by, bx, ry, rx, fc, precision)


def _roi_f32_layouts(cuda, f, by, bx, ry, rx, fc, precision):
    """K6 at "upq" and "puq" and K7 on the padded copy of ``f`` (490
    channels; by, bx from the PS prep), and K6 at layout "c" on ``fc``
    (10 channels; ry, rx from the RoIAlign prep): each held bit-equal to
    its plain version, its launch counted; at "split" and "highest" K6's
    "c" also bit-equal to K3's float32 mode. Returns the four outputs."""
    outs = []
    for layout in ("upq", "puq"):
        before = ps_roi_align_f32_kernel.launches
        got = ps_roi_align_f32_kernel(f, by, bx, 10, precision, layout)
        assert ps_roi_align_f32_kernel.launches == before + 1
        assert torch.equal(got, ps_roi_align_f32_plain(f, by, bx, 10,
                                                       precision, layout))
        outs.append(got)
    b, hh, ww = f.shape[:3]
    fpad = torch.zeros((b, hh, ww, 7 * 128), device=cuda)
    fpad[..., torch.as_tensor(ps_channel_perm_pad(10, 7, 7), device=cuda)] = f
    before = ps_roi_align_padded_f32_kernel.launches
    got = ps_roi_align_padded_f32_kernel(fpad, by, bx, 10, precision)
    assert ps_roi_align_padded_f32_kernel.launches == before + 1
    assert torch.equal(got, ps_roi_align_f32_plain(fpad, by, bx, 10,
                                                   precision, "padded"))
    assert torch.equal(got, outs[0])      # the same numbers as "upq"
    outs.append(got)
    got = ps_roi_align_f32_kernel(fc, ry, rx, 10, precision, "c")
    assert torch.equal(got, roi_align_f32_plain(fc, ry, rx, precision))
    if precision != "default":
        assert torch.equal(got, roi_align_kernel(fc, ry, rx, precision))
    outs.append(got)
    return outs


@pytest.mark.parametrize("precision", ["default", "split", "highest"])
@pytest.mark.parametrize("case", _SUPPORT_CASES)
def test_roi_f32_bit_equal_on_support_edge_cases(cuda, case, precision):
    """K6 ("upq", "puq", "c") and K7 sum only the nonzero spans of by and
    bx: on K2's edge cases (whole-frame, sub-cell, partly and wholly
    outside RoIs, a negative map, a 13x21 map) and at every rung of the
    ladder they stay bit-equal to their plain versions, and K6 at layout
    "c" to K3's float32 mode."""
    rng = np.random.default_rng(len(case))
    b, n = 2, 96
    boxes, (hh, ww) = _support_case(cuda, case, rng, b, n)
    by, bx = _batched_prep(boxes, hh, ww, (7, 7), 1 / 16, -0.5, 0.1, -1, 4)
    ry, rx = _batched_prep(boxes, hh, ww, (7, 7), 1 / 16, 0.0, 1.0, -1, 4)
    f = rng.standard_normal((b, hh, ww, 490))
    fc = rng.standard_normal((b, hh, ww, 10))
    if case == "negative_map":
        f, fc = -np.abs(f), -np.abs(fc)
    outs = _roi_f32_layouts(
        cuda, torch.tensor(f, dtype=torch.float32, device=cuda), by, bx, ry,
        rx, torch.tensor(fc, dtype=torch.float32, device=cuda), precision)
    if case == "wholly_outside":
        assert all(float(o.abs().max()) == 0.0 for o in outs)


@pytest.mark.parametrize("precision", ["default", "split", "highest"])
def test_roi_f32_kernels_are_batch_independent(cuda, precision):
    """K6 (each layout) and K7 on a batch of 3 images: each image's crops
    equal those of the same image alone."""
    rng = np.random.default_rng(3)
    f, by, bx = _roi_inputs(cuda, rng, 3, 40, 26, 490, True, torch.float32)
    fc, ry, rx = _roi_inputs(cuda, rng, 3, 40, 26, 10, False, torch.float32)
    whole = _roi_f32_layouts(cuda, f, by, bx, ry, rx, fc, precision)
    for i in range(3):
        one = _roi_f32_layouts(
            cuda, *(t[i:i + 1].contiguous() for t in (f, by, bx, ry, rx, fc)),
            precision)
        assert all(torch.equal(w[i:i + 1], o) for w, o in zip(whole, one))


def _k3_operands(cuda, f, by, bx, precision):
    dt = torch.bfloat16 if precision == "default" else torch.float32
    return (torch.as_tensor(f, dtype=dt, device=cuda).contiguous(),
            by.to(dt).contiguous(), bx.to(dt).contiguous())


def _k3_plain(f, by, bx, precision):
    return (roi_align_plain(f, by, bx) if precision == "default"
            else roi_align_f32_plain(f, by, bx, precision))


# (batch, RoIs): one image, and a batch whose RoIs split into groups of
# more than one RoI a block with a ragged last group (asserted below)
_K3_BATCHES = [(1, 96), (16, 101)]


@pytest.mark.parametrize("precision", ["default", "split", "highest"])
@pytest.mark.parametrize("b,n", _K3_BATCHES)
@pytest.mark.parametrize("case", _SUPPORT_CASES + ["random"])
def test_k3_bit_equal_on_support_edge_cases(cuda, case, b, n, precision):
    """K3 stages each image's map in shared memory for a group of RoIs
    and sums only the nonzero spans of by and bx: on random RoIs and on
    K2's edge cases (whole-frame, sub-cell, partly and wholly outside
    RoIs, a negative map, a 13x21 map whose map rows break the 16-byte
    copies), at each rung, at batch 1 and across several RoI groups, it
    stays bit-equal to its plain version, one launch a call."""
    if b > 1:
        group = roi_align_group(b, n)
        assert group > 1 and n % group, group
    rng = np.random.default_rng(len(case) + b)
    # "negative_map" draws random RoIs
    boxes, (hh, ww) = _support_case(
        cuda, "negative_map" if case == "random" else case, rng, b, n)
    f = rng.standard_normal((b, hh, ww, 10))
    if case == "negative_map":
        f = -np.abs(f)
    by, bx = _batched_prep(boxes, hh, ww, (7, 7), 1 / 16, 0.0, 1.0, -1, 4)
    f, by, bx = _k3_operands(cuda, f, by, bx, precision)
    before = roi_align_kernel.launches
    got = roi_align_kernel(f, by, bx, precision)
    assert roi_align_kernel.launches == before + 1
    want = _k3_plain(f, by, bx, precision)
    assert torch.equal(got, want)
    if case == "wholly_outside":
        assert float(want.abs().max()) == 0.0


@pytest.mark.parametrize("precision", ["default", "split", "highest"])
def test_k3_is_batch_independent(cuda, precision):
    """K3's blocks each take a group of one image's RoIs, sized by the
    batch: each image's crops equal those of the same image alone."""
    rng = np.random.default_rng(7)
    b, n = _K3_BATCHES[1]
    boxes, _ = _support_case(cuda, "negative_map", rng, b, n)
    by, bx = _batched_prep(boxes, 26, 26, (7, 7), 1 / 16, 0.0, 1.0, -1, 4)
    f, by, bx = _k3_operands(cuda, rng.standard_normal((b, 26, 26, 10)), by,
                             bx, precision)
    got = roi_align_kernel(f, by, bx, precision)
    for i in range(b):
        assert torch.equal(got[i:i + 1], roi_align_kernel(
            *(t[i:i + 1].contiguous() for t in (f, by, bx)), precision))


def _stage_inputs(cuda, n, h, w, cin, cout):
    g = torch.Generator(device="cpu").manual_seed(h + cin)
    x = torch.randn((n, h, w, cin), generator=g).to(cuda)
    wt = (0.2 * torch.randn((cout, cin, 3, 3), generator=g)).to(cuda)
    bs = (0.1 * torch.randn(cout, generator=g)).to(cuda)
    return x, wt, bs


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((1, 416, 416, 3, 16), torch.float16),
    ((2, 208, 208, 16, 32), torch.float16),
    ((2, 104, 104, 32, 64), torch.bfloat16),
    ((1, 52, 52, 64, 128), torch.float32),
    ((2, 20, 36, 5, 40), torch.float32),
    ((1, 20, 36, 24, 40), torch.float16),
    ((3, 52, 52, 64, 128), torch.bfloat16),
    ((1, 26, 26, 200, 16), torch.bfloat16)])
def test_stem_stage_kernel_matches_plain(cuda, precision, shape, out_dtype):
    """K9 at the four stage shapes of the 416 px network (52 px is a 26 px
    map: 8x8 tiles ragged by 6 rows and columns), 20x36 frames (partial
    tiles) with Cin 5 and 24 (not multiples of 16: zero-padded slices)
    and 40 outputs (a partial slice), and Cin 200 (13 slices), in every
    store type: bit-equal at "highest", within PAIR_DEFAULT_TOL at
    "default" (the tensor cores)."""
    x, wt, bs = _stage_inputs(cuda, *shape)
    before = fused_stem_stage.launches
    got = fused_stem_stage(x, wt, bs, precision, out_dtype)
    assert fused_stem_stage.launches == before + 1
    _held_to_pair_plain(got, fused_stem_stage_plain(x, wt, bs, precision,
                                                    out_dtype), precision)


@pytest.mark.parametrize("shape", [(5, 104, 104, 32, 64),
                                   (5, 52, 52, 64, 128)])
def test_stem_stage_is_batch_independent(cuda, shape):
    """K9 at "default" walks (tile, channel slice) items on a persistent
    grid in an order that depends on the batch: each image's output must
    not."""
    x, wt, bs = _stage_inputs(cuda, *shape)
    got = fused_stem_stage(x, wt, bs, "default", torch.bfloat16)
    for i in range(x.shape[0]):
        assert torch.equal(got[i:i + 1], fused_stem_stage(
            x[i:i + 1], wt, bs, "default", torch.bfloat16))


@pytest.mark.parametrize("shape", [(3, 416, 416, 3, 16),
                                   (3, 208, 208, 16, 32)])
def test_stem_stage_highest_is_batch_independent(cuda, shape):
    """K9 at "highest" walks its tiles on a persistent grid sized by the
    batch (stages 0 and 2 of the network): each image's output must equal
    the same image alone, and the plain version."""
    x, wt, bs = _stage_inputs(cuda, *shape)
    got = fused_stem_stage(x, wt, bs, "highest", torch.float16)
    assert torch.equal(got, fused_stem_stage_plain(x, wt, bs, "highest",
                                                   torch.float16))
    for i in range(x.shape[0]):
        assert torch.equal(got[i:i + 1], fused_stem_stage(
            x[i:i + 1], wt, bs, "highest", torch.float16))


@pytest.mark.parametrize("shape,out_dtype", [
    ((1, 20, 20, 264, 16), torch.bfloat16),
    ((2, 14, 18, 300, 40), torch.float32)])
def test_stem_stage_default_wide_cin_on_cuda_cores(cuda, shape, out_dtype):
    """K9 at "default" where not even 8 channels of tensor-core weights fit
    shared memory (Cin above 256) sums on the CUDA cores, bf16 operands
    and float32 FMAs (each product exact): bit-equal to its plain
    version."""
    x, wt, bs = _stage_inputs(cuda, *shape)
    before = fused_stem_stage.launches
    got = fused_stem_stage(x, wt, bs, "default", out_dtype)
    assert fused_stem_stage.launches == before + 1
    assert torch.equal(got, fused_stem_stage_plain(x, wt, bs, "default",
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


@pytest.mark.parametrize("precision,batches", [("default", (4,)),
                                               ("highest", (5, 33))])
def test_stem_pair_is_batch_independent(cuda, precision, batches):
    """Both pair kernels walk their tiles on a persistent grid, in an
    order that depends on the batch (4 frames of 416 px: 676 tiles, more
    than the card holds blocks at once; at "highest" 5 and 33 frames, 845
    and 5577 tiles): each image's output must not."""
    for n in batches:
        x, w0, b0, w1, b1 = _pair_weights(cuda, n, 416, 416, 3, 16, 32)
        got = fused_stem_pair(x, w0, b0, w1, b1, precision)
        for i in range(n) if n <= 5 else (0, n // 2, n - 1):
            assert torch.equal(got[i:i + 1], fused_stem_pair(
                x[i:i + 1], w0, b0, w1, b1, precision))


@pytest.mark.parametrize("shape,out_dtype", [
    ((1, 64, 64, 16, 32, 64), torch.float32),
    ((2, 20, 36, 3, 16, 32), torch.float16)])
def test_stem_pair_highest_wide_and_ragged(cuda, shape, out_dtype):
    """The stem pair at "highest" at 16 -> 32 -> 64 (226,432 bytes of
    shared memory: one halo buffer, one block an SM) and on a 20x36 frame
    (5x9 outputs: one ragged tile, an odd last column): K4, K12 (and K8
    and K11 where H % 32 == 0) each launch it and are bit-equal to the
    plain version."""
    assert stem.pair_route(*shape[3:], "highest") == "pair"
    args = _pair_weights(cuda, *shape)
    want = fused_stem_pair_plain(*args, "highest", out_dtype)
    for fn in (fused_stem_pair, fused_stem_pair_select,
               fused_stem_pair_packed, fused_stem_pair_s2d):
        if fn in (fused_stem_pair_select, fused_stem_pair_packed) \
                and shape[1] % 32:
            continue
        before, deep = fn.launches, fused_stem_pair_deep.launches
        got = fn(*args, "highest", out_dtype)
        assert (fn.launches, fused_stem_pair_deep.launches) == (before + 1,
                                                                deep)
        assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((2, 104, 104, 32, 64, 128), torch.bfloat16),
    ((1, 20, 36, 8, 24, 40), torch.float32),
    ((1, 64, 64, 16, 32, 64), torch.float16),
    ((1, 24, 24, 72, 16, 24), torch.bfloat16)])
def test_deep_pair_kernel_matches_plain(cuda, precision, shape, out_dtype):
    """The deep pair at stages 4+6 of the 416 px network (26 output rows:
    a ragged 8x8 tile), at odd widths (Cin 8 and Cmid 24: zero-padded
    16-channel slices; a 40-channel output), at 16 -> 32 -> 64, and at
    Cin 72, whose input halo does not fit the tensor-core kernel's shared
    memory (the CUDA-core kernel takes it at "default" too), through
    K12's wrapper where the pair kernel's shared memory does not hold the
    weights: bit-equal at "highest", within PAIR_DEFAULT_TOL at
    "default"."""
    args = _pair_weights(cuda, *shape)
    want = fused_stem_pair_deep_plain(*args, precision, out_dtype)
    before = fused_stem_pair_deep.launches
    got = fused_stem_pair_deep(*args, precision, out_dtype)
    _held_to_pair_plain(got, want, precision)
    if precision == "highest" and out_dtype == torch.float32:
        # against the function in float64: no worse than the plain version
        ref = fused_stem_pair_f64(*args)
        err = float((got.double() - ref).abs().max())
        err_plain = float((want.double() - ref).abs().max())
        print(f"deep pair {shape}: float64 error {err:.3g}, plain "
              f"{err_plain:.3g}")
        assert err <= 2 * err_plain, (err, err_plain)
    if shape[3] == 32:
        n_s2d = fused_stem_pair_s2d.launches
        assert torch.equal(fused_stem_pair_s2d(*args, precision, out_dtype,
                                               groups0=2), got)
        assert fused_stem_pair_s2d.launches == n_s2d
        assert fused_stem_pair_deep.launches == before + 2
    if precision == "default":          # K8's select epilogue
        _held_to_pair_plain(
            fused_stem_pair_deep(*args, precision, out_dtype, select=True),
            fused_stem_pair_deep_plain(*args, precision, out_dtype, True),
            precision)


@pytest.mark.parametrize("n,precision,shape", [
    (16384, "highest", (4, 4, 64, 64, 128)),
    (65536, "default", (4, 4, 72, 16, 24))])
def test_deep_pair_past_the_old_batch_cap(cuda, n, precision, shape):
    """The batch has no grid dimension's cap: at "highest" the deep pair's
    two deep_stage_kernel launches (stage 1 at 4 slices of 32 channels an
    image put 65536 blocks on grid z at n = 16384), at "default" Cin 72
    the CUDA-core deep pair (n alone on grid z past 65535); held to the
    plain version as at any batch."""
    args = _pair_weights(cuda, n, *shape)
    before = fused_stem_pair_deep.launches
    got = fused_stem_pair_deep(*args, precision)
    assert fused_stem_pair_deep.launches == before + 1
    _held_to_pair_plain(got, fused_stem_pair_deep_plain(*args, precision),
                        precision)


def test_deep_stage_kernel_past_the_old_batch_cap(cuda):
    """K9 at "default" and Cin 272 (past the tensor-core kernel's widest
    weight slice) runs deep_stage_kernel; at n = 16384, 4 slices of 32
    output channels an image once put 65536 blocks on grid z."""
    g = torch.Generator(device="cpu").manual_seed(272)
    x = torch.rand((16384, 4, 4, 272), generator=g).to(cuda)
    w = (0.1 * torch.randn((128, 272, 3, 3), generator=g)).to(cuda)
    b = (0.1 * torch.randn(128, generator=g)).to(cuda)
    before = fused_stem_stage.launches
    got = fused_stem_stage(x, w, b, "default")
    assert fused_stem_stage.launches == before + 1
    _held_to_pair_plain(got, fused_stem_stage_plain(x, w, b, "default"),
                        "default")


def test_stream_equals_infer(cuda, tmp_path):
    """chip_smoke.py's P15 at 16 frames: the lossless stream at
    pallas_max_s01, each frame bit-identical to FusionEngine.infer fed by
    a second RadarPipeline, and no host sync inside the step."""
    from pathlib import Path

    import chip_smoke as cs
    from millieye_torch.cli._common import build_fusion
    from millieye_torch.radar.pipeline import RadarParams
    from millieye_torch.runtime.engine import FusionEngine
    from millieye_torch.runtime.stream import StreamingPipeline
    ckpt = Path(__file__).resolve().parents[1] / "artifacts/stage3_final.npz"
    frames = cs.write_recording(str(tmp_path), n_frames=16)
    eng = FusionEngine(*build_fusion(str(ckpt), "pallas_max_s01"),
                       frame_size=cs.FRAME)
    params = RadarParams()
    replay, _ = cs.radar_replay(str(tmp_path), eng, params)
    got = {}
    n, _ = StreamingPipeline(eng, str(tmp_path), cs.STREAM_CALIB, params,
                             frames=frames, drop_on_full=False).run(
        on_result=lambda i, bx, v: got.update({i: (bx, v)}))
    assert n == 16
    for (i, f), r in zip(frames, replay):
        assert cs.same_answer(got[i], eng.infer(f, *r))
    step = eng.step_fn(0)
    tens = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (frames[0][1],) + eng.pack_radar(*replay[0])]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*tens)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_deep_pair_is_batch_independent(cuda, precision):
    """At "default" the deep pair walks its tiles on a persistent grid (5
    frames at 104 px: 80 tiles; 33 frames: more tiles than blocks); at
    "highest" its grid and its scratch intermediate grow with the batch:
    each image's output must not depend on the batch."""
    for n in (5, 33):
        x, w0, b0, w1, b1 = _pair_weights(cuda, n, 104, 104, 32, 64, 128)
        got = fused_stem_pair_deep(x, w0, b0, w1, b1, precision)
        for i in (0, n // 2, n - 1):
            assert torch.equal(got[i:i + 1], fused_stem_pair_deep(
                x[i:i + 1], w0, b0, w1, b1, precision))


@pytest.mark.parametrize("deterministic", [False, True])
def test_window_batch_dependence_lies_outside_the_kernels(cuda,
                                                         deterministic):
    """The served network of ``pallas_max4`` on 8 letterboxed frames, each
    alone and as one batch, compared block by block: every block the
    port's stem kernels compute (the pair and K9) is bit-identical alone
    and batched, with cuDNN as set and with
    ``torch.backends.cudnn.deterministic``; the blocks that depend on the
    batch (cuDNN's) are printed, the first one named."""
    from pathlib import Path

    from millieye_torch.cli._common import build_fusion
    from millieye_torch.models.fusion import _DTYPES
    from millieye_torch.ops.letterbox import letterbox_image
    from millieye_torch.runtime.engine import fold_for_serving
    ckpt = Path(__file__).resolve().parents[1] / "artifacts/stage3_final.npz"
    model, params, state = build_fusion(str(ckpt), "pallas_max4",
                                        device=cuda)
    params, state = fold_for_serving(model, params, state)
    dn = model.darknet
    rng = np.random.default_rng(0)
    imgs = torch.stack([letterbox_image(torch.tensor(
        rng.integers(0, 256, (480, 640, 3)), dtype=torch.uint8,
        device=cuda), dn.img_size)[0] for _ in range(8)])

    def blocks(x):
        with torch.no_grad():
            return dn.apply(params["darknet"], state["darknet"], x,
                            compute_dtype=_DTYPES[model.cfg.compute_dtype],
                            collect_outputs=True)["outputs"]

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        batch = blocks(imgs)
        alone = [blocks(imgs[i:i + 1]) for i in range(len(imgs))]
    finally:
        torch.backends.cudnn.deterministic = prev
    differ = [b for b in range(len(batch))
              if any(not torch.equal(a[b], batch[b][i:i + 1])
                     for i, a in enumerate(alone))]
    kernel_blocks = {j for s in dn.stem_stages for j in (s, s + 1)}
    assert kernel_blocks and not kernel_blocks & set(differ)
    print(f"cudnn.deterministic={deterministic}: {len(differ)} of "
          f"{len(batch)} blocks depend on the batch, first "
          f"{differ[:1]} ({dn._plan[differ[0]]['type'] if differ else '-'})")


def test_f32_window_equals_per_frame(cuda):
    """The reference's window contract at its float32 default
    (tests/test_runtime.py:147-150): the ``f32`` preset's
    ``batched_step_fn`` on ``chip_smoke.py``'s 8 requests
    (``default_rng(1)``), each frame's answer against ``step_fn`` on that
    frame alone: ``valid`` equal, rows within rtol 1e-4 and atol 1e-4."""
    from pathlib import Path

    import chip_smoke as cs
    from millieye_torch.cli._common import build_fusion
    from millieye_torch.runtime.engine import FusionEngine
    ckpt = Path(__file__).resolve().parents[1] / cs.CKPT
    model, params, state = build_fusion(str(ckpt), "f32", device=cuda)
    eng = FusionEngine(model, params, state, frame_size=cs.FRAME,
                       device=cuda)
    reqs = cs.requests(np.random.default_rng(1), cs.N_REQUESTS)
    packed = [eng.pack_radar(pts, props) for _, pts, props in reqs]
    tens = [torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(cuda)
            for a in [[f for f, _, _ in reqs]] + [list(c)
                                                  for c in zip(*packed)]]
    rows, valid = (a.cpu().numpy() for a in eng.batched_step_fn(0)(*tens))
    step = eng.step_fn(0)
    for i in range(len(reqs)):
        r, v = (a.cpu().numpy() for a in step(*(t[i] for t in tens)))
        np.testing.assert_array_equal(valid[i], v)
        np.testing.assert_allclose(rows[i], r, rtol=1e-4, atol=1e-4)


def test_pair_wrappers_take_the_deep_pair_at_wide_widths(cuda):
    """K4, K8 and K11 (and K12) at 16 -> 32 -> 64, where the stem pair's
    tile does not fit shared memory at "default", run the deep pair (K8
    with its select), which counts the launch, within PAIR_DEFAULT_TOL of
    the plain version the CPU runs for the same call."""
    assert stem.pair_route(16, 32, 64, "default") == "deep"
    args = _pair_weights(cuda, 2, 64, 64, 16, 32, 64)
    for fn in (fused_stem_pair, fused_stem_pair_select,
               fused_stem_pair_packed, fused_stem_pair_s2d):
        deep, own = fused_stem_pair_deep.launches, fn.launches
        got = fn(*args)
        assert (fused_stem_pair_deep.launches, fn.launches) == (deep + 1, own)
        _held_to_pair_plain(got, fn(*(t.cpu() for t in args)).to(cuda),
                            "default")


@pytest.mark.parametrize("variant", ["vconcat", "vroll", "im2col"])
@pytest.mark.parametrize("shape,out_dtype", [
    ((2, 416, 416, 3, 16), torch.float16),
    ((2, 208, 208, 16, 32), torch.float16),
    ((1, 64, 48, 5, 8), torch.bfloat16),
    ((1, 20, 36, 70, 44), torch.float32)])
def test_fused_stem_kernel_matches_plain(cuda, variant, shape, out_dtype):
    """K10 at the stem's two stage shapes, an odd one and a wide one (70
    input channels: past the 48 KB shared-memory default; 44 outputs: not
    a multiple of 8, so four channels a thread, 11 groups)."""
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


def _k10_inputs(cuda, shape, seed):
    n, h, w, cin, cout = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    return ((torch.randn((n, h, w, cin), generator=g)).to(cuda),
            (0.2 * torch.randn((3, 3, cin, cout), generator=g)).to(cuda),
            (0.1 * torch.randn(cout, generator=g)).to(cuda))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("variant", ["vconcat", "im2col"])
@pytest.mark.parametrize("cout", [4, 12, 33])
@pytest.mark.parametrize("cin,hw", [(93, (2, 16, 12)), (128, (2, 12, 20)),
                                    (256, (1, 18, 10)), (1024, (1, 10, 14))])
def test_fused_stem_wide_cin(cuda, cin, hw, cout, variant, out_dtype):
    """K10 at wide inputs, as the JAX function takes them: both routes
    (``nhwc_route``: the resident kernel up to its shared memory, then the
    streamed one, whose halo stays for the nine taps up to 176 channels
    and walks in chunks past it), ragged output groups, every store
    type; one launch, bit-equal to the plain version."""
    n, h, w = hw
    x, wt, bs = _k10_inputs(cuda, (n, h, w, cin, cout), cin + cout)
    route = stem._lib().millieye_stem_nhwc_route(cin, cout)
    assert ("resident", "streamed")[route] == stem.nhwc_route(cin, cout)
    before = fused_stem.launches
    got = fused_stem(x, wt, bs, th=1, out_dtype=out_dtype, variant=variant)
    assert fused_stem.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (n, h // 2, w // 2, cout)
    assert torch.equal(got, fused_stem_plain(x, wt, bs, 1, out_dtype,
                                             variant))


@pytest.mark.parametrize("variant", ["vconcat", "im2col"])
@pytest.mark.parametrize("shape", [(32, 26, 26, 128, 256),
                                   (40, 32, 32, 200, 96)])
def test_fused_stem_streamed_at_batch(cuda, shape, variant):
    """The streamed route at batches whose items fill the card, where it
    takes 8 channels a thread (block 8's shape at b32; a halo in chunks
    and a ragged last slice of 64 channels): bit-equal."""
    x, wt, bs = _k10_inputs(cuda, shape, 8)
    assert stem.nhwc_route(shape[3], shape[4]) == "streamed"
    assert torch.equal(fused_stem(x, wt, bs, 1, torch.float16, variant),
                       fused_stem_plain(x, wt, bs, 1, torch.float16,
                                        variant))


@pytest.mark.parametrize("shape", [(5, 26, 30, 3, 16), (5, 26, 30, 16, 32),
                                   (5, 14, 18, 24, 12), (3, 26, 26, 128, 256),
                                   (3, 10, 12, 300, 8)])
def test_fused_stem_is_batch_independent(cuda, shape):
    """Each image of a batch gets the answer it gets alone, on every
    route (tiles and blocks run the batch in another order)."""
    x, wt, bs = _k10_inputs(cuda, shape, 7)
    for variant in ("vconcat", "im2col"):
        full = fused_stem(x, wt, bs, 1, torch.float32, variant)
        for i in range(shape[0]):
            one = fused_stem(x[i:i + 1].contiguous(), wt, bs, 1,
                             torch.float32, variant)
            assert torch.equal(one, full[i:i + 1])


def _device_kernels(fn, traces=3):
    """The device kernels one call of ``fn`` launches, by name: the
    longest list of ``traces`` profiler traces of one call each (late in
    a long process the profiler drops some device records of a short
    trace; it adds none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    found = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 for _ in range(e.count)]
        found = max(found, names, key=len)
    return found


def test_k10_k13_run_no_pytorch_reduction(cuda):
    """On a CUDA tensor K13 is its two hand-written launches and nothing
    else (no abs, amax, clamp or division kernel for the scale); K10 is
    its one kernel in either tap order (the HWIO weights as given)."""
    w = torch.randn((300, 70), device=cuda)
    names = _device_kernels(lambda: tq.quantize_int8_stochastic(w, 1, 64))
    assert len(names) == 2, names
    assert any("absmax_kernel(" in n for n in names), names
    assert any("round_kernel(" in n for n in names), names
    x, wt, bs = _k10_inputs(cuda, (2, 16, 16, 16, 32), 3)
    for variant in ("im2col", "vconcat"):
        names = _device_kernels(
            lambda: fused_stem(x, wt, bs, 1, torch.float16, variant))
        assert len(names) == 1 and "stem_nhwc" in names[0], names


def _k13_special(kind):
    g = torch.Generator(device="cpu").manual_seed(13)
    w = torch.randn((9, 20), generator=g)
    if kind == "zeros":
        w[:] = 0.0
    elif kind == "negative zeros":
        w[:] = -0.0
    elif kind == "inf":
        w[3, 7] = float("inf")
    elif kind == "-inf":
        w[8, 19] = -float("inf")
    elif kind == "nan":
        w[0, 5] = float("nan")
    elif kind == "-nan":
        w[4, 4] = -float("nan")
    return w


@pytest.mark.parametrize("kind", ["zeros", "negative zeros", "inf", "-inf",
                                  "nan", "-nan"])
def test_quantize_stochastic_special_values(cuda, kind):
    """K13 on all-zero, -0.0, inf and NaN inputs, bit-equal to its plain
    version: the values (a NaN becomes what PyTorch's cast makes of it)
    and the scale, NaN where the plain scale is NaN."""
    w = _k13_special(kind).to(cuda)
    for seed in (0, 9):
        q, s = tq.quantize_int8_stochastic(w, seed, 4)
        wq, ws = tq.quantize_int8_stochastic_plain(w, seed, 4)
        assert torch.equal(q, wq)
        if "nan" in kind:
            assert bool(s.isnan()) and bool(ws.isnan())
        else:
            assert torch.equal(s, ws)


@pytest.mark.parametrize("shape,row_tile", [((37, 13), 5), ((70000, 3), 1),
                                            ((65536, 2), 1), ((999, 7), 33)])
def test_quantize_stochastic_ragged_and_many_tiles(cuda, shape, row_tile):
    """K13 on a ragged last tile whose start is not 16-byte aligned, more
    than 65535 row tiles (more than a grid's y dimension holds), and an
    input that is a view 4 bytes into its storage: one launch, bit-equal
    to the plain version."""
    g = torch.Generator(device="cpu").manual_seed(shape[0])
    w = torch.randn((shape[0] * shape[1] + 1,), generator=g).to(cuda)
    w = w[1:].view(shape)
    before = tq.quantize_int8_stochastic.launches
    q, s = tq.quantize_int8_stochastic(w, 4, row_tile)
    assert tq.quantize_int8_stochastic.launches == before + 1
    wq, ws = tq.quantize_int8_stochastic_plain(w, 4, row_tile)
    assert torch.equal(s, ws) and torch.equal(q, wq)


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
    with pytest.raises(ValueError):            # H % 32 for K8
        fused_stem_pair_select(*_pair_weights(cuda, 1, 20, 32, 3, 8, 16))
    # K10 takes any number of input channels (93 here), bit-equal
    g = torch.Generator(device="cpu").manual_seed(93)
    args = (torch.randn((1, 8, 8, 93), generator=g).to(cuda),
            torch.randn((3, 3, 93, 8), generator=g).to(cuda),
            torch.randn(8, generator=g).to(cuda))
    assert torch.equal(fused_stem(*args, th=1),
                       fused_stem_plain(*args, th=1))
