"""YOLO detection loss over padded targets (port of
``millieye_tpu/models/yolo_head.py``).

The reference's training branch of YOLOLayer: masked MSE on x/y/w/h at
the assigned cells, BCE objectness with obj_scale 1 and noobj_scale 100,
BCE classification at the assigned cells. A mean over a boolean
selection becomes sum(selected) / count, an empty selection dividing by
a count clamped to 1 (the loss is 0 there, where the reference gives
NaN). The targets and the metrics carry no gradient. Under an active
mesh (``parallel/``) every count is the global batch's, so a rank's loss
and metrics are its partial sums of the global ones.
"""
from __future__ import annotations

import torch

from millieye_torch.device import constant
from millieye_torch.ops.targets import build_targets
from millieye_torch.parallel import collectives as pc

OBJ_SCALE = 1.0
NOOBJ_SCALE = 100.0
_EPS = 1e-12


def _masked_mean(values, mask):
    """sum(selected) / count, the count over the global batch: under an
    active mesh a rank's value is its partial sum of the global mean."""
    count = torch.clamp(pc.data_count(mask.sum()), min=1.0)
    # select, don't multiply: a NaN in a masked-out cell times 0 is NaN
    return torch.where(mask > 0, values, torch.zeros_like(values)).sum() \
        / count


def _sel(mask, values, neutral):
    """Masked-out cells replaced by a neutral constant BEFORE the
    differentiable ops: backprop multiplies the upstream zero by the local
    derivative, and 0 * NaN = NaN, so masking only the summed output would
    let a saturated prediction in an unassigned cell NaN the gradient."""
    return torch.where(mask > 0, values, torch.full_like(values, neutral))


def _bce(p, t):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def yolo_scale_loss(pred, anchors_px, stride, targets, tmask,
                    ignore_thresh=0.5):
    """Loss for one YOLO scale.

    pred: [B, A, G, G, 5+C], (sigmoid-x, sigmoid-y, tw, th, sigmoid-conf,
          sigmoid-cls): the ``preds`` output of ``Darknet.apply(train=True)``.
    anchors_px: [A, 2] anchors in pixels; stride: image pixels per cell.
    targets: [B, T, 5] normalized (class, cx, cy, w, h); tmask: [B, T].

    Returns (total loss, metrics dict of detached scalars).
    """
    dev = pred.device
    anchors_grid = constant(tuple(map(tuple, anchors_px)), dev) / stride
    g = pred.shape[2]
    ar = torch.arange(g, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    bx = pred[..., 0] + gx[None, None]
    by = pred[..., 1] + gy[None, None]
    # clamped like the decode: no-object cells' tw/th are free to drift
    # past exp's overflow
    bw = torch.exp(pred[..., 2].clamp(-20.0, 20.0)) * \
        anchors_grid[None, :, 0, None, None]
    bh = torch.exp(pred[..., 3].clamp(-20.0, 20.0)) * \
        anchors_grid[None, :, 1, None, None]
    pred_boxes = torch.stack([bx, by, bw, bh], -1)

    t = build_targets(pred_boxes, pred[..., 5:], targets, tmask,
                      anchors_grid, ignore_thresh)
    obj, noobj = t["obj_mask"], t["noobj_mask"]

    loss_x = _masked_mean((_sel(obj, pred[..., 0], 0.0) - t["tx"]) ** 2, obj)
    loss_y = _masked_mean((_sel(obj, pred[..., 1], 0.0) - t["ty"]) ** 2, obj)
    loss_w = _masked_mean((_sel(obj, pred[..., 2], 0.0) - t["tw"]) ** 2, obj)
    loss_h = _masked_mean((_sel(obj, pred[..., 3], 0.0) - t["th"]) ** 2, obj)
    conf = pred[..., 4]
    loss_conf_obj = _masked_mean(_bce(_sel(obj, conf, 0.5), t["tconf"]), obj)
    loss_conf_noobj = _masked_mean(_bce(_sel(noobj, conf, 0.5), t["tconf"]),
                                   noobj)
    loss_conf = OBJ_SCALE * loss_conf_obj + NOOBJ_SCALE * loss_conf_noobj
    loss_cls = _masked_mean(
        _bce(_sel(obj[..., None], pred[..., 5:], 0.5), t["tcls"]).mean(-1),
        obj)
    total = loss_x + loss_y + loss_w + loss_h + loss_conf + loss_cls

    with torch.no_grad():
        conf = conf.detach()
        n_obj = torch.clamp(pc.data_count(obj.sum()), min=1e-16)
        conf50 = (conf > 0.5).float()
        iou50 = (t["iou_scores"] > 0.5).float()
        iou75 = (t["iou_scores"] > 0.75).float()
        detected = conf50 * t["class_mask"] * t["tconf"]
        metrics = {
            "loss": total.detach(),
            "x": loss_x.detach(), "y": loss_y.detach(),
            "w": loss_w.detach(), "h": loss_h.detach(),
            "conf": loss_conf.detach(), "cls": loss_cls.detach(),
            "cls_acc": 100.0 * _masked_mean(t["class_mask"], obj),
            "recall50": (iou50 * detected).sum() / n_obj,
            "recall75": (iou75 * detected).sum() / n_obj,
            "precision": (iou50 * detected).sum()
            / torch.clamp(pc.data_count(conf50.sum()), min=1e-16),
            "conf_obj": _masked_mean(conf, obj),
            "conf_noobj": _masked_mean(conf, noobj),
        }
    return total, metrics


def yolo_loss(preds, anchors_per_scale, img_dim, targets, tmask,
              ignore_thresh=0.5):
    """The sum of the per-scale losses. Returns (loss, [metrics per
    scale])."""
    total = 0.0
    all_metrics = []
    for pred, anchors in zip(preds, anchors_per_scale):
        stride = img_dim / pred.shape[2]
        loss, metrics = yolo_scale_loss(pred, anchors, stride, targets,
                                        tmask, ignore_thresh)
        total = total + loss
        all_metrics.append(metrics)
    return total, all_metrics
