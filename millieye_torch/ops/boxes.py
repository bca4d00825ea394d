"""Box coordinate math (port of ``millieye_tpu/ops/boxes.py``).

All functions take [..., 4] tensors: (x1, y1, x2, y2) for "xyxy" and
(cx, cy, w, h) for "xywh". ``plus_one`` selects the reference's +1 pixel
convention; torchvision's NMS (and so this package's NMS) uses
``plus_one=False``. ``box_regress`` runs ``exp`` in float32;
``encode_boxes`` is its inverse, the regression targets, with the
reference's ``1e-16`` guards.
"""
from __future__ import annotations

import torch


def xywh_to_xyxy(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_xywh(b):
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def _iou_core(a, b, plus_one):
    """Elementwise float32 IoU in the reference's expression order,
    ``inter / (area_a + area_b - inter + 1e-16)``: NMS keep sets depend
    on every rounding step, so no operation here is fused or reordered."""
    one = 1.0 if plus_one else 0.0
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = ((ix2 - ix1 + one).clamp_min(0) * (iy2 - iy1 + one).clamp_min(0))
    area_a = (a[..., 2] - a[..., 0] + one) * (a[..., 3] - a[..., 1] + one)
    area_b = (b[..., 2] - b[..., 0] + one) * (b[..., 3] - b[..., 1] + one)
    return inter / (area_a + area_b - inter + 1e-16)


def iou_pairwise(a, b, plus_one=True):
    """Elementwise IoU of equal-shaped [..., 4] xyxy boxes."""
    return _iou_core(a, b, plus_one)


def iou_matrix(a, b, plus_one=True):
    """All-pairs IoU: a [..., n, 4] x b [..., m, 4] -> [..., n, m]."""
    return _iou_core(a[..., :, None, :], b[..., None, :, :], plus_one)


def wh_iou(wh1, wh2):
    """IoU by shape only (boxes co-centred): wh1 [n, 2] x wh2 [m, 2] ->
    [n, m], with the reference's 1e-16 inside the union."""
    w1, h1 = wh1[:, None, 0], wh1[:, None, 1]
    w2, h2 = wh2[None, :, 0], wh2[None, :, 1]
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    union = (w1 * h1 + 1e-16) + w2 * h2 - inter
    return inter / union


def rescale_boxes(boxes, current_dim, original_shape):
    """Undo letterbox padding: boxes [..., 4] xyxy in the ``current_dim``
    square -> the original (h, w) image, with the reference's ``//2``."""
    orig_h, orig_w = original_shape
    m = max(original_shape)
    pad_x = max(orig_h - orig_w, 0) * (current_dim / m)
    pad_y = max(orig_w - orig_h, 0) * (current_dim / m)
    unpad_h = current_dim - pad_y
    unpad_w = current_dim - pad_x
    x1 = (boxes[..., 0] - pad_x // 2) / unpad_w * orig_w
    y1 = (boxes[..., 1] - pad_y // 2) / unpad_h * orig_h
    x2 = (boxes[..., 2] - pad_x // 2) / unpad_w * orig_w
    y2 = (boxes[..., 3] - pad_y // 2) / unpad_h * orig_h
    return torch.stack([x1, y1, x2, y2], -1)


def box_regress(regress_param, roi_xyxy):
    """Apply (dx, dy, dw, dh) deltas to xyxy RoIs; exp in float32, with
    the deltas clamped to +-20 so untrained heads stay finite."""
    xywh = xyxy_to_xywh(roi_xyxy)
    x, y, w, h = xywh[..., 0], xywh[..., 1], xywh[..., 2], xywh[..., 3]
    p = regress_param.float()
    xr = p[..., 0] * w + x
    yr = p[..., 1] * h + y
    wr = torch.exp(p[..., 2].clamp(-20.0, 20.0)) * w
    hr = torch.exp(p[..., 3].clamp(-20.0, 20.0)) * h
    return xywh_to_xyxy(torch.stack([xr, yr, wr, hr], -1))


def encode_boxes(roi_xyxy, target_xyxy):
    """Regression targets for roi -> target: ((xt - x) / w, (yt - y) / h,
    log(wt / w + 1e-16), log(ht / h + 1e-16)), the 1e-16 where the
    reference puts it."""
    r = xyxy_to_xywh(roi_xyxy)
    t = xyxy_to_xywh(target_xyxy)
    x, y, w, h = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    xt, yt, wt, ht = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    return torch.stack([(xt - x) / (w + 1e-16), (yt - y) / (h + 1e-16),
                        torch.log(wt / w + 1e-16),
                        torch.log(ht / h + 1e-16)], -1)
