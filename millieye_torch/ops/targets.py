"""YOLO target assignment over padded targets (port of
``millieye_tpu/ops/targets.py``).

Targets arrive as [B, T, 5] (class, cx, cy, w, h normalized to (0, 1))
with a validity mask [B, T]; the assignment is one batched scatter:

* the best anchor of each target by shape-only IoU;
* the no-object mask cleared at the assigned cell and for every anchor
  whose shape IoU exceeds ``ignore_thresh`` there;
* tw/th = log(gwh / anchor + 1e-16);
* iou_scores / class_mask at the assigned cell against the decoded
  prediction (+1 pixel IoU on xywh boxes).

The JAX package scatters invalid targets out of bounds (``mode="drop"``);
torch has no drop mode, so every scatter here writes into tensors one
batch row (and, for ``tcls``, one class column) larger and the invalid
targets land in that spare row, which is cut off. No host sync: the
masks stay tensors. Two valid targets on the same (cell, anchor) leave
one of their values, which one unspecified, as in the JAX package.
"""
from __future__ import annotations

import torch

from millieye_torch.ops.boxes import iou_pairwise, xywh_to_xyxy


def build_targets(pred_boxes, pred_cls, targets, tmask, anchors,
                  ignore_thresh=0.5):
    """
    pred_boxes: [B, A, G, G, 4] decoded (cx, cy, w, h) in grid units
    pred_cls:   [B, A, G, G, C] sigmoid class scores
    targets:    [B, T, 5] (class, cx, cy, w, h) normalized to (0, 1)
    tmask:      [B, T] bool
    anchors:    [A, 2] in grid units

    Returns a dict of [B, A, G, G] float32 tensors (tcls [B, A, G, G, C]):
    obj_mask, noobj_mask, tx, ty, tw, th, tcls, tconf, iou_scores,
    class_mask. No gradient flows through them.
    """
    with torch.no_grad():
        return _build(pred_boxes.detach(), pred_cls.detach(), targets,
                      tmask.bool(), anchors, ignore_thresh)


def _build(pred_boxes, pred_cls, targets, tmask, anchors, ignore_thresh):
    b_sz, a_sz, g = pred_boxes.shape[0], pred_boxes.shape[1], \
        pred_boxes.shape[2]
    c_sz = pred_cls.shape[-1]
    dev = pred_boxes.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)

    labels = targets[..., 0].to(torch.int32).long()            # truncation
    gxy = targets[..., 1:3] * g
    gwh = targets[..., 3:5] * g

    # shape-only IoU against each anchor: [B, T, A]
    inter = (torch.minimum(gwh[..., None, 0], anchors[None, None, :, 0])
             * torch.minimum(gwh[..., None, 1], anchors[None, None, :, 1]))
    union = (anchors[None, None, :, 0] * anchors[None, None, :, 1] + 1e-16
             + gwh[..., 0:1] * gwh[..., 1:2] - inter)
    anchor_ious = inter / union
    best_n = torch.argmax(anchor_ious, -1)                      # [B, T]

    gi = gxy[..., 0].to(torch.int32).long().clamp(0, g - 1)
    gj = gxy[..., 1].to(torch.int32).long().clamp(0, g - 1)
    b_idx = torch.arange(b_sz, device=dev)[:, None].expand_as(labels)
    # invalid targets scatter into the spare row b_sz
    b_safe = torch.where(tmask, b_idx, torch.full_like(b_idx, b_sz))
    at = (b_safe, best_n, gj, gi)

    def grid(fill):
        return torch.full((b_sz + 1, a_sz, g, g), fill, dtype=torch.float32,
                          device=dev)

    def scatter(fill, values):
        out = grid(fill)
        out.index_put_(at, torch.as_tensor(values, dtype=torch.float32,
                                           device=dev).expand(labels.shape))
        return out

    obj_mask = scatter(0.0, 1.0)
    noobj = scatter(1.0, 0.0)
    # also ignore every anchor over the shape-IoU threshold at that cell
    ignore = anchor_ious > ignore_thresh                        # [B, T, A]
    b_ig = torch.where(tmask[..., None] & ignore, b_idx[..., None],
                       torch.full_like(ignore, b_sz, dtype=torch.long))
    anchor_range = torch.arange(a_sz, device=dev).expand(ignore.shape)
    noobj.index_put_((b_ig, anchor_range, gj[..., None].expand(ignore.shape),
                      gi[..., None].expand(ignore.shape)),
                     torch.zeros((), device=dev).expand(ignore.shape))

    tx = scatter(0.0, gxy[..., 0] - torch.floor(gxy[..., 0]))
    ty = scatter(0.0, gxy[..., 1] - torch.floor(gxy[..., 1]))
    anchor_best = anchors[best_n]                               # [B, T, 2]
    tw = scatter(0.0, torch.log(gwh[..., 0] / anchor_best[..., 0] + 1e-16))
    th = scatter(0.0, torch.log(gwh[..., 1] / anchor_best[..., 1] + 1e-16))
    # labels index as JAX's do: negative ones count from the end, the
    # rest out of range drop (into the spare column)
    lab = torch.where(labels < 0, labels + c_sz, labels)
    lab = torch.where((lab >= 0) & (lab < c_sz), lab,
                      torch.full_like(lab, c_sz))
    tcls = torch.zeros((b_sz + 1, a_sz, g, g, c_sz + 1), dtype=torch.float32,
                       device=dev)
    tcls.index_put_(at + (lab,),
                    torch.ones((), device=dev).expand(labels.shape))

    # metrics at the assigned cell
    b_in = torch.clamp(b_idx, max=b_sz - 1)
    pred_at = pred_boxes[b_in, best_n, gj, gi]                  # [B, T, 4]
    tb_xywh = torch.cat([gxy, gwh], -1)
    ious = iou_pairwise(xywh_to_xyxy(pred_at), xywh_to_xyxy(tb_xywh))
    iou_scores = scatter(0.0, ious)
    pred_lab = torch.argmax(pred_cls[b_in, best_n, gj, gi], -1)
    class_mask = scatter(0.0, (pred_lab == labels).float())

    obj_mask = obj_mask[:b_sz]
    return {
        "obj_mask": obj_mask,
        "noobj_mask": noobj[:b_sz],
        "tx": tx[:b_sz],
        "ty": ty[:b_sz],
        "tw": tw[:b_sz],
        "th": th[:b_sz],
        "tcls": tcls[:b_sz, ..., :c_sz],
        "tconf": obj_mask,
        "iou_scores": iou_scores[:b_sz],
        "class_mask": class_mask[:b_sz],
    }
