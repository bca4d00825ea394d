"""Port parity: millieye_torch/ops/boxes.py against millieye_tpu/ops/boxes.py
on the same numpy-seeded inputs. Float32 elementwise arithmetic in the same
expression order, so the tolerance is a few float32 ulps (libm exp may
differ by one ulp between XLA and PyTorch)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.ops import boxes as tb
from millieye_tpu.ops import boxes as jb

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-5


def _boxes(rng, n):
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(0.5, 120, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_xywh_xyxy_roundtrip(rng):
    b = rng.uniform(1, 400, (3, 17, 4)).astype(np.float32)
    for tf, jf in ((tb.xywh_to_xyxy, jb.xywh_to_xyxy),
                   (tb.xyxy_to_xywh, jb.xyxy_to_xywh)):
        np.testing.assert_allclose(tf(torch.from_numpy(b)).numpy(),
                                   np.asarray(jf(jnp.asarray(b))),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("plus_one", [False, True])
def test_iou_matrix(rng, plus_one):
    a, b = _boxes(rng, 40), _boxes(rng, 33)
    got = tb.iou_matrix(torch.from_numpy(a), torch.from_numpy(b), plus_one)
    want = jb.iou_matrix(jnp.asarray(a), jnp.asarray(b), plus_one)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (416, 416)])
def test_rescale_boxes(rng, shape):
    b = _boxes(rng, 25)
    got = tb.rescale_boxes(torch.from_numpy(b), 416, shape)
    want = jb.rescale_boxes(jnp.asarray(b), 416, shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_box_regress(rng):
    rois = _boxes(rng, 50)
    deltas = rng.normal(0, 1, (50, 4)).astype(np.float32)
    deltas[0, 2:] = 30.0                 # clamped at +-20
    got = tb.box_regress(torch.from_numpy(deltas), torch.from_numpy(rois))
    want = jb.box_regress(jnp.asarray(deltas), jnp.asarray(rois))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=ATOL)


@pytest.mark.parametrize("plus_one", [False, True])
def test_iou_pairwise(rng, plus_one):
    a, b = _boxes(rng, 60).reshape(3, 20, 4), _boxes(rng, 60).reshape(3, 20, 4)
    b[0, :5] = a[0, :5]                  # identical pairs: IoU 1
    got = tb.iou_pairwise(torch.from_numpy(a), torch.from_numpy(b), plus_one)
    want = jb.iou_pairwise(jnp.asarray(a), jnp.asarray(b), plus_one)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


def test_wh_iou(rng):
    wh1 = rng.uniform(0.5, 120, (9, 2)).astype(np.float32)
    wh2 = rng.uniform(0.5, 120, (14, 2)).astype(np.float32)
    wh2[0] = 0.0                         # a degenerate anchor: the 1e-16
    got = tb.wh_iou(torch.from_numpy(wh1), torch.from_numpy(wh2))
    want = jb.wh_iou(jnp.asarray(wh1), jnp.asarray(wh2))
    assert got.shape == (9, 14)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


def test_encode_boxes(rng):
    """The regression targets, and box_regress of them back to the
    targets (log then exp: a few float32 ulps)."""
    rois, tgt = _boxes(rng, 50), _boxes(rng, 50)
    tgt[0] = rois[0]                     # zero deltas
    got = tb.encode_boxes(torch.from_numpy(rois), torch.from_numpy(tgt))
    want = jb.encode_boxes(jnp.asarray(rois), jnp.asarray(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tb.box_regress(got, torch.from_numpy(
        rois)).numpy(), tgt, rtol=1e-5, atol=1e-3)
