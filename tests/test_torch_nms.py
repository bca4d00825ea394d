"""Port parity: millieye_torch NMS (kernel K1's and K5's plain versions,
the fixpoint, batched_nms, pre_top_k_sufficient, nms_xyxy) against
millieye_tpu's. Keep sets must be BIT-EQUAL (tests/test_nms.py pins that
for the JAX package): the IoU is elementwise float32 in the same
expression order on both sides. The inputs carry
duplicate boxes, tied scores and knife-edge IoUs: pairs whose float32 IoU
lies on the other side of the threshold than the exact one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.ops import nms as tnms
from millieye_torch.ops.nms_kernel import (nms_keep_mask_blocked,
                                           nms_keep_mask_full)
from millieye_tpu.ops import nms as jnms
from millieye_tpu.ops.nms_pallas import (nms_keep_mask_pallas,
                                         nms_keep_mask_pallas_blocked)

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)


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
        n = min(k // 8, 64)
        for off, t in ((0, 0.5), (k // 4, 0.3)) if knife_edges else ():
            pa, pb = _knife_edge_pairs(rng, n, t)
            bx[off:off + 2 * n:2], bx[off + 1:off + 2 * n:2] = pa, pb
        dup = rng.choice(np.arange(k // 2 + 1, k), k // 8, replace=False)
        bx[dup] = bx[dup - 1]                      # exact duplicates
        out[i] = bx
    return out


def _edge_boxes(rng, b, k, knife_edges=True):
    """``_hard_boxes`` with zero-area rows among them: a zero width, a
    zero height, a point, and a zero-area duplicate of a zero-area row."""
    out = _hard_boxes(rng, b, k, knife_edges)
    z = k // 2 + rng.choice(k // 2 - 4, 4, replace=False)
    out[:, z[0], 2] = out[:, z[0], 0]
    out[:, z[1], 3] = out[:, z[1], 1]
    out[:, z[2], 2:] = out[:, z[2], :2]
    out[:, z[3] + 1] = out[:, z[3]] = out[:, z[2]]
    return out


def _valid(rng, b, k, pattern):
    """valid [b, k]: a prefix of random length per image (what the serving
    paths give: candidates sorted by score, -inf below the threshold),
    random at 85%, all false, only the last row, only the first row."""
    if pattern == "prefix":
        return np.arange(k)[None] < rng.integers(0, k + 1, (b, 1))
    if pattern == "random":
        return rng.random((b, k)) < 0.85
    v = np.zeros((b, k), bool)
    if pattern == "last":
        v[:, -1] = True
    elif pattern == "first":
        v[:, 0] = True
    return v


PATTERNS = ("prefix", "random", "all_false", "last", "first")


def _cases(ks, first):
    """(k, pattern) cases; the ``first`` Ks' random-valid cases keep the
    ids these tests had before they took patterns."""
    return [pytest.param(k, p, id=str(k) if k in first and p == "random"
                         else f"{k}-{p}") for k in ks for p in PATTERNS]


def _golden(boxes, valid, thr):
    # eager on purpose: under jit XLA:CPU fuses the IoU arithmetic and
    # contracts it into FMAs, which flips knife-edge keep bits
    return np.stack([np.asarray(jnms.nms_keep_mask_ref(
        jnp.asarray(boxes[i]), jnp.asarray(valid[i]), thr))
        for i in range(len(boxes))])


# 0.5 and 0.3: the knife edges; -0.2: every pair is above it, so the
# kernels' inter == 0 shortcut (taken only for a non-negative threshold)
# must not apply
THRESHOLDS = (0.5, 0.3, -0.2)


@pytest.mark.parametrize("k,pattern",
                         _cases((128, 256, 512, 1024), (128, 256)))
def test_keep_mask_bit_equal_golden(rng, k, pattern):
    """Kernel K1's plain version (what the CPU takes) against the
    sequential golden, on knife-edge pairs, duplicates and zero-area
    boxes, for each valid pattern."""
    b = 3 if k <= 256 else 2
    boxes = _edge_boxes(rng, b, k)
    valid = _valid(rng, b, k, pattern)
    tbx, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    for thr in THRESHOLDS:
        got = nms_keep_mask_blocked(tbx, tv, thr).numpy()
        want = _golden(boxes, valid, thr)
        np.testing.assert_array_equal(got, want)
        # the port's other spellings agree too
        np.testing.assert_array_equal(
            tnms.nms_keep_mask(tbx, tv, thr).numpy(), want)
        for i in range(b):
            np.testing.assert_array_equal(
                tnms.nms_keep_mask_ref(tbx[i], tv[i], thr).numpy(), want[i])


@pytest.mark.parametrize("k,pattern",
                         _cases((128, 256, 512, 1024), (128, 256)))
def test_keep_mask_bit_equal_pallas_interpret(rng, k, pattern):
    """Against the blocked Pallas kernel in interpret mode, on clusters,
    duplicates, zero-area boxes and ties. Knife-edge pairs are left out:
    there XLA:CPU's fused build of the interpret kernel disagrees with the
    eager golden itself (its decisions match an FMA-contracted area_a +
    area_b), while the port matches the golden."""
    b = 3 if k <= 256 else 2
    boxes = _edge_boxes(rng, b, k, knife_edges=False)
    valid = _valid(rng, b, k, pattern)
    for thr in THRESHOLDS:
        got = nms_keep_mask_blocked(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), thr).numpy()
        pallas = np.asarray(nms_keep_mask_pallas_blocked(
            jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("k,pattern",
                         _cases((96, 128, 135, 232, 512, 1024), (135, 512)))
def test_full_keep_mask_bit_equal_golden(rng, k, pattern):
    """Kernel K5's plain version against the sequential golden, at Ks
    that are no multiple of 32 (135), the post-merge NMS's (96, 232), the
    flagship's 512 and the largest, on knife-edge pairs, duplicates and
    zero-area boxes, for each valid pattern."""
    b = 2
    boxes = _edge_boxes(rng, b, k)
    valid = _valid(rng, b, k, pattern)
    tbx, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    for thr in THRESHOLDS:
        got = nms_keep_mask_full(tbx, tv, thr).numpy()
        np.testing.assert_array_equal(got, _golden(boxes, valid, thr))


@pytest.mark.parametrize("k,pattern",
                         _cases((96, 128, 135, 232, 512, 1024), (135, 512)))
def test_full_keep_mask_bit_equal_pallas_interpret(rng, k, pattern):
    """K5's plain version against the whole-matrix Pallas kernel it
    replaces, in interpret mode, off the knife edges (where XLA:CPU's
    fused build of the kernel leaves the eager golden)."""
    b = 2
    boxes = _edge_boxes(rng, b, k, knife_edges=False)
    valid = _valid(rng, b, k, pattern)
    for thr in THRESHOLDS:
        got = nms_keep_mask_full(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), thr).numpy()
        pallas = np.asarray(nms_keep_mask_pallas(
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


@pytest.mark.parametrize("pre_top_k,max_det,use_blocked", [
    pytest.param(128, 64, None, id="128-64"),
    pytest.param(96, 40, None, id="96-40"),
    pytest.param(128, 64, False, id="128-64-whole_matrix")])
def test_batched_nms_matches_jax(rng, pre_top_k, max_det, use_blocked):
    """K=128 takes kernel K1's path (plain on the CPU), or K5's with
    use_blocked=False; K=96 takes K5's; rows and validity must equal the
    JAX package's."""
    pred = _pred(rng)
    got, gv = tnms.batched_nms(torch.from_numpy(pred), 0.2, 0.5,
                               max_det=max_det, pre_top_k=pre_top_k,
                               use_blocked=use_blocked)
    want, wv = jnms.batched_nms(jnp.asarray(pred), 0.2, 0.5, max_det=max_det,
                                pre_top_k=pre_top_k, use_pallas=False)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_nms_dispatch(rng, monkeypatch):
    """The JAX package's dispatch: K1 at K % 128 == 0 unless use_blocked
    is False, else K5, the fixpoint only above 1024 candidates."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("nms_keep_mask_blocked", "nms_keep_mask_full",
                 "nms_keep_mask"):
        monkeypatch.setattr(tnms, name, spy(name, getattr(tnms, name)))
    pred = torch.from_numpy(_pred(rng, b=1, a=1100))
    for k, blocked in ((128, None), (128, False), (100, None), (1100, None)):
        tnms.batched_nms(pred, 0.2, 0.5, max_det=20, pre_top_k=k,
                         use_blocked=blocked)
    assert calls == ["nms_keep_mask_blocked", "nms_keep_mask_full",
                     "nms_keep_mask_full", "nms_keep_mask"]


@pytest.mark.parametrize("pre_top_k,max_det", [(64, 200), (64, 10),
                                               (300, 200)])
def test_pre_top_k_sufficient_matches_jax(rng, pre_top_k, max_det):
    pred = _pred(rng)
    pred[1, :, 4] *= 0.25                     # few rows pass in image 1
    got = tnms.pre_top_k_sufficient(torch.from_numpy(pred), 0.2, 0.5,
                                    max_det=max_det, pre_top_k=pre_top_k)
    want = jnms.pre_top_k_sufficient(jnp.asarray(pred), 0.2, 0.5,
                                     max_det=max_det, pre_top_k=pre_top_k)
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


@pytest.mark.parametrize("k,plus_one,route", [
    (96, False, "nms_keep_mask_full"),
    (135, False, "nms_keep_mask_full"),
    (128, False, "nms_keep_mask_blocked"),
    (96, True, "nms_keep_mask_full_plain"),
    (1100, False, "nms_keep_mask")])
def test_nms_xyxy_keep_mask_route(rng, monkeypatch, k, plus_one, route):
    """The post-merge NMS takes the batched path's kernels for one image:
    K5 (any K <= 1024) or K1 (K % 128 == 0), which run their plain
    versions on a CPU tensor; with plus_one K5's plain version, which
    takes it; the fixpoint only above 1024 rows. Every route gives the
    sequential golden's keep set on knife-edge IoUs."""
    calls = []
    for name in ("nms_keep_mask_blocked", "nms_keep_mask_full",
                 "nms_keep_mask_full_plain", "nms_keep_mask"):
        fn = getattr(tnms, name)
        monkeypatch.setattr(tnms, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    b = k if k <= 256 else 128
    boxes = np.concatenate([_hard_boxes(rng, 1, b)[0]]
                           * -(-k // b))[:k]        # rows repeat past 256
    boxes = torch.from_numpy(np.ascontiguousarray(boxes))
    valid = torch.from_numpy(rng.random(k) < 0.85)
    for t in (0.5, 0.3):
        calls.clear()
        keep = tnms._keep_mask(boxes[None], valid[None], t, plus_one)[0]
        assert calls == [route]
        assert torch.equal(keep, tnms.nms_keep_mask_ref(boxes, valid, t,
                                                        plus_one))


@pytest.mark.parametrize("k", [96, 232])
def test_nms_xyxy_batched_matches_vmap_and_per_frame(rng, k):
    """A window's post-merge NMS in one call (the engine's
    ``batched_step_fn``, one keep-mask launch): rows and validity equal
    the JAX package's ``jax.vmap`` of ``nms_xyxy`` (eager, so that XLA
    contracts no IoU into an FMA) and, bit for bit, the port's per-frame
    calls, on knife-edge IoUs, tied scores and three classes, at the
    engine's K (64 + 32 and 200 + 32 rows)."""
    w = 4
    boxes = _hard_boxes(rng, w, k)
    scores = np.round(rng.uniform(0, 1, (w, k)) * 20).astype(np.float32) / 20
    labels = rng.integers(0, 3, (w, k)).astype(np.int32)
    valid = rng.random((w, k)) < 0.8
    valid[1] = False                           # a frame with no row
    for t in (0.5, 0.3):
        args = [torch.from_numpy(a) for a in (boxes, scores, labels, valid)]
        got, gv = tnms.nms_xyxy(*args, t, k)
        assert got.shape == (w, k, 6) and gv.shape == (w, k)
        want, wv = jax.vmap(lambda b, s, lab, v: jnms.nms_xyxy(
            b, s, lab, v, t, k))(*(jnp.asarray(a) for a in (boxes, scores,
                                                            labels, valid)))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for i in range(w):
            fr, fv = tnms.nms_xyxy(*(a[i] for a in args), t, k)
            assert torch.equal(fr, got[i]) and torch.equal(fv, gv[i])


def test_nms_times_needs_a_card(monkeypatch):
    """The NMS timing tool stops with its message where there is no card,
    before it builds or times anything."""
    from millieye_torch.cli import nms_times
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        nms_times.main()
