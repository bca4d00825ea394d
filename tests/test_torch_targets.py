"""Port parity of the YOLO targets and loss: ``ops/targets.py:
build_targets`` and ``models/yolo_head.py`` of millieye_torch against
millieye_tpu on the same numpy-seeded inputs (CPU).

Tolerances: the targets are compared for equality (float32, the same
operations; the inputs hold no two targets on one (cell, anchor), whose
winner neither package specifies), except tw and th, which take a log:
XLA's float32 log and torch's differ by an ulp now and then, so those
two within 2 ulp (rtol 2.4e-7, and 1e-7 absolute near 0). The loss, its
metrics and its gradient with respect to the predictions within 1e-5
relative (float32 summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.models import yolo_head as tyh
from millieye_torch.ops.targets import build_targets as t_build
from millieye_tpu.models import yolo_head as jyh
from millieye_tpu.ops.targets import build_targets as j_build

torch.set_num_threads(1)

ANCHORS_PX = ((10, 14), (23, 27), (37, 58))
G, C, S = 8, 12, 128
STRIDE = S / G
LOSS_RTOL = 1e-5


def _targets(rng, b, t, g=G, valid=None):
    """[b, t, 5] targets with no two valid ones on the same (cell, anchor):
    each image's targets take distinct cells. Some rows invalid (and
    holding garbage, which must drop)."""
    out = rng.uniform(-1, 2, (b, t, 5)).astype(np.float32)
    mask = (rng.uniform(size=(b, t)) < 0.75) if valid is None else valid
    for i in range(b):
        cells = rng.choice(g * g, size=t, replace=False)
        for j in range(t):
            cy, cx = divmod(int(cells[j]), g)
            out[i, j] = (rng.integers(0, C),
                         (cx + rng.uniform(0.05, 0.95)) / g,
                         (cy + rng.uniform(0.05, 0.95)) / g,
                         rng.uniform(0.02, 0.6), rng.uniform(0.02, 0.6))
    return out, mask


def _pred(rng, b, g=G):
    p = rng.uniform(0.02, 0.98, (b, 3, g, g, 5 + C)).astype(np.float32)
    p[..., 2:4] = rng.normal(0, 1, (b, 3, g, g, 2))
    return p


LOG_KEYS = ("tw", "th")


def _same_targets(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in LOG_KEYS:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2.4e-7, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("b,t", [(1, 1), (2, 6), (3, 20)])
def test_build_targets_equal(b, t):
    rng = np.random.default_rng(b * 100 + t)
    targets, tmask = _targets(rng, b, t)
    boxes = rng.uniform(0, G, (b, 3, G, G, 4)).astype(np.float32)
    cls = rng.uniform(0, 1, (b, 3, G, G, C)).astype(np.float32)
    anchors = np.asarray(ANCHORS_PX, np.float32) / STRIDE
    want = j_build(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(targets),
                   jnp.asarray(tmask), jnp.asarray(anchors))
    got = t_build(torch.from_numpy(boxes), torch.from_numpy(cls),
                  torch.from_numpy(targets), torch.from_numpy(tmask),
                  torch.from_numpy(anchors))
    _same_targets(got, want)
    assert float(got["obj_mask"].sum()) == int(tmask.sum())


def test_build_targets_drops_invalid_and_out_of_range_labels():
    """Masked targets change nothing; a valid target's label outside [0, C)
    drops from tcls (negative ones index from the end), as in JAX."""
    rng = np.random.default_rng(7)
    targets, _ = _targets(rng, 2, 4)
    tmask = np.array([[True, False, True, True], [False, True, True, True]])
    targets[0, 2, 0] = C + 3
    targets[1, 3, 0] = -1
    boxes = rng.uniform(0, G, (2, 3, G, G, 4)).astype(np.float32)
    cls = rng.uniform(0, 1, (2, 3, G, G, C)).astype(np.float32)
    anchors = np.asarray(ANCHORS_PX, np.float32) / STRIDE
    want = j_build(*map(jnp.asarray, (boxes, cls, targets, tmask, anchors)))
    got = t_build(*map(torch.from_numpy, (boxes, cls, targets, tmask,
                                          anchors)))
    _same_targets(got, want)


def _losses(pred, targets, tmask, anchors=ANCHORS_PX):
    jp = jnp.asarray(pred)

    def jloss(p):
        return jyh.yolo_scale_loss(p, np.asarray(anchors, np.float32), STRIDE,
                                   jnp.asarray(targets), jnp.asarray(tmask))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = torch.from_numpy(pred).requires_grad_(True)
    tl, tm = tyh.yolo_scale_loss(tp, anchors, STRIDE,
                                 torch.from_numpy(targets),
                                 torch.from_numpy(tmask))
    (tg,) = torch.autograd.grad(tl, tp)
    return (float(jl), jm, np.asarray(jg)), (float(tl.detach()), tm,
                                              tg.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yolo_scale_loss_and_gradient(seed):
    rng = np.random.default_rng(seed)
    targets, tmask = _targets(rng, 2, 5)
    (jl, jm, jg), (tl, tm, tg) = _losses(_pred(rng, 2), targets, tmask)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_RTOL,
                                             abs=1e-6), k
    scale = np.abs(jg).max()
    assert np.abs(tg - jg).max() <= LOSS_RTOL * scale


def test_yolo_loss_sums_scales():
    """``yolo_loss`` over two scales (the tiny-YOLOv3 pair) and an image of
    no valid target (every noobj cell, no obj cell: loss terms of an empty
    mask are 0)."""
    rng = np.random.default_rng(3)
    anchors = (((81, 82), (135, 169), (344, 319)), ((10, 14), (23, 27),
                                                    (37, 58)))
    preds = [_pred(rng, 2, 4), _pred(rng, 2, 8)]
    targets, tmask = _targets(rng, 2, 3, g=4)
    tmask[1] = False
    jl, jms = jyh.yolo_loss([jnp.asarray(p) for p in preds], anchors, S,
                            jnp.asarray(targets), jnp.asarray(tmask))
    tl, tms = tyh.yolo_loss([torch.from_numpy(p) for p in preds], anchors, S,
                            torch.from_numpy(targets),
                            torch.from_numpy(tmask))
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for jm, tm in zip(jms, tms):
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_RTOL,
                                                 abs=1e-6), k


def test_yolo_loss_gradient_survives_poisoned_unassigned_cells():
    """The port's twin of tests/test_train.py's test: NaN predictions in a
    cell outside the obj/noobj masks leave the loss and every other cell's
    gradient finite (masking before the differentiable ops), and the
    gradient equals JAX's within LOSS_RTOL."""
    b, a, g, c = 1, 3, 4, 2
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.1, 0.9, (b, a, g, g, 5 + c)).astype(np.float32)
    targets = np.zeros((b, 1, 5), np.float32)
    targets[0, 0] = (0, 0.52, 0.52, 0.4, 0.4)
    tmask = np.ones((b, 1), bool)
    anchors = ((10.0, 10.0), (20.0, 20.0), (30.0, 30.0))
    pred[0, 0, 0, 0, :4] = np.nan
    pred[0, 0, 0, 0, 5:] = np.nan

    jg = np.asarray(jax.grad(lambda p: jyh.yolo_scale_loss(
        p, np.asarray(anchors), 64.0 / g, jnp.asarray(targets),
        jnp.asarray(tmask))[0])(jnp.asarray(pred)))
    tp = torch.from_numpy(pred).requires_grad_(True)
    loss, _ = tyh.yolo_scale_loss(tp, anchors, 64.0 / g,
                                  torch.from_numpy(targets),
                                  torch.from_numpy(tmask))
    assert torch.isfinite(loss)
    (tg,) = torch.autograd.grad(loss, tp)
    tg = tg.numpy()
    keep = np.ones(tg.shape[:-1], bool)
    keep[0, 0, 0, 0] = False
    assert np.isfinite(tg[keep]).all()
    np.testing.assert_array_equal(np.isfinite(tg), np.isfinite(jg))
    ok = np.isfinite(jg)
    assert np.abs(tg[ok] - jg[ok]).max() <= LOSS_RTOL * np.abs(jg[ok]).max()


def test_masked_mean_ignores_poison_outside_mask():
    v = torch.tensor([1.0, float("nan"), float("inf"), 3.0],
                     requires_grad=True)
    m = torch.tensor([1.0, 0.0, 0.0, 1.0])
    out = tyh._masked_mean(v, m)
    assert float(out) == 2.0
    (g,) = torch.autograd.grad(out, v)
    assert torch.isfinite(g).all()
