"""Port parity: millieye_torch NMS (kernel K1's plain version, the fixpoint,
batched_nms, nms_xyxy) against millieye_tpu's. Keep sets must be BIT-EQUAL
(tests/test_nms.py pins that for the JAX package): the IoU is elementwise
float32 in the same expression order on both sides. The inputs carry
duplicate boxes, tied scores and knife-edge IoUs: pairs whose float32 IoU
lies on the other side of the threshold than the exact one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.ops import nms as tnms
from millieye_torch.ops.nms_kernel import nms_keep_mask_blocked
from millieye_tpu.ops import nms as jnms
from millieye_tpu.ops.nms_pallas import nms_keep_mask_pallas_blocked


def _iou_np(a, b, dt):
    a, b = a.astype(dt), b.astype(dt)
    inter = (np.maximum(np.minimum(a[:, 2], b[:, 2])
                        - np.maximum(a[:, 0], b[:, 0]), dt(0))
             * np.maximum(np.minimum(a[:, 3], b[:, 3])
                          - np.maximum(a[:, 1], b[:, 1]), dt(0)))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter + dt(1e-16))


def _knife_edge_pairs(rng, n, t):
    """n box pairs whose float32 IoU (the reference's expression order)
    falls on the other side of t than the exact IoU: an IoU computed in
    more precision, or fused into FMAs, flips their keep bits."""
    m = 20000
    xy = rng.uniform(0, 5000, (m, 2))        # pairs far from each other
    wh = rng.uniform(5, 30, (m, 2))
    a = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    d = (a[:, 2] - a[:, 0]) * (1 - 2 * t / (1 + t)) * (
        1 + rng.normal(0, 3e-7, m))          # shift giving IoU ~= t
    b = (a + np.stack([d, 0 * d, d, 0 * d], -1)).astype(np.float32)
    sel = (_iou_np(a, b, np.float32) > t) != (_iou_np(a, b, np.float64) > t)
    assert sel.sum() >= n
    return a[sel][:n], b[sel][:n]


def _hard_boxes(rng, b, k, knife_edges=True):
    """Score-sorted boxes [b, k, 4]: clusters and exact duplicates in the
    second half; in the first half knife-edge pairs for thresholds 0.5
    and 0.3, each pair at adjacent ranks (or more clusters)."""
    out = np.zeros((b, k, 4), np.float32)
    for i in range(b):
        c = rng.uniform(0, 80, (k, 2))
        wh = rng.uniform(10, 60, (k, 2))
        bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        n = k // 8
        for off, t in ((0, 0.5), (k // 4, 0.3)) if knife_edges else ():
            pa, pb = _knife_edge_pairs(rng, n, t)
            bx[off:off + 2 * n:2], bx[off + 1:off + 2 * n:2] = pa, pb
        dup = rng.choice(np.arange(k // 2 + 1, k), k // 8, replace=False)
        bx[dup] = bx[dup - 1]                      # exact duplicates
        out[i] = bx
    return out


@pytest.mark.parametrize("k", [128, 256])
def test_keep_mask_bit_equal_golden(rng, k):
    """Kernel K1's plain version (what the CPU takes) against the
    sequential golden, knife-edge pairs included."""
    b = 3
    boxes = _hard_boxes(rng, b, k)
    valid = rng.random((b, k)) < 0.85
    tbx, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    for thr in (0.5, 0.3):
        got = nms_keep_mask_blocked(tbx, tv, thr).numpy()
        # eager on purpose: under jit XLA:CPU fuses the IoU arithmetic and
        # contracts it into FMAs, which flips knife-edge keep bits
        want = np.stack([np.asarray(jnms.nms_keep_mask_ref(
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]), thr))
            for i in range(b)])
        np.testing.assert_array_equal(got, want)
        # the port's other spellings agree too
        np.testing.assert_array_equal(
            tnms.nms_keep_mask(tbx, tv, thr).numpy(), want)
        for i in range(b):
            np.testing.assert_array_equal(
                tnms.nms_keep_mask_ref(tbx[i], tv[i], thr).numpy(), want[i])


@pytest.mark.parametrize("k", [128, 256])
def test_keep_mask_bit_equal_pallas_interpret(rng, k):
    """Against the blocked Pallas kernel in interpret mode, on clusters,
    duplicates and ties. Knife-edge pairs are left out: there XLA:CPU's
    fused build of the interpret kernel disagrees with the eager golden
    itself (its decisions match an FMA-contracted area_a + area_b), while
    the port matches the golden."""
    b = 3
    boxes = _hard_boxes(rng, b, k, knife_edges=False)
    valid = rng.random((b, k)) < 0.85
    for thr in (0.5, 0.3):
        got = nms_keep_mask_blocked(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), thr).numpy()
        pallas = np.asarray(nms_keep_mask_pallas_blocked(
            jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
        np.testing.assert_array_equal(got, pallas)


def _pred(rng, b=2, a=300, classes=12):
    pred = np.zeros((b, a, 5 + classes), np.float32)
    pred[..., :2] = rng.uniform(20, 90, (b, a, 2))
    pred[..., 2:4] = rng.uniform(5, 40, (b, a, 2))
    # objectness on a 0.02 grid: many tied scores
    pred[..., 4] = np.round(rng.uniform(0, 1, (b, a)) * 50) / 50
    pred[..., 5:] = rng.uniform(0, 1, (b, a, classes))
    pred[:, 7, :4] = pred[:, 3, :4]                # duplicate boxes
    return pred


@pytest.mark.parametrize("pre_top_k,max_det", [(128, 64), (96, 40)])
def test_batched_nms_matches_jax(rng, pre_top_k, max_det):
    """K=128 takes the kernel path (plain on the CPU), K=96 the fixpoint;
    rows and validity must equal the JAX package's."""
    pred = _pred(rng)
    got, gv = tnms.batched_nms(torch.from_numpy(pred), 0.2, 0.5,
                               max_det=max_det, pre_top_k=pre_top_k)
    want, wv = jnms.batched_nms(jnp.asarray(pred), 0.2, 0.5, max_det=max_det,
                                pre_top_k=pre_top_k, use_pallas=False)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nms_xyxy_matches_jax(rng):
    k = 96
    boxes = _hard_boxes(rng, 1, k)[0]
    scores = np.round(rng.uniform(0, 1, k) * 20).astype(np.float32) / 20
    labels = rng.integers(0, 3, k).astype(np.int32)
    valid = rng.random(k) < 0.8
    got, gv = tnms.nms_xyxy(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(labels), torch.from_numpy(valid),
                            0.3, k)
    want, wv = jax.jit(jnms.nms_xyxy, static_argnums=(4, 5))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid), 0.3, k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
