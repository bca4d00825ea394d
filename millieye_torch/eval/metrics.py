"""mAP engine (host-side numpy): a copy of ``millieye_tpu/eval/metrics.py``.

Matches the reference's evaluation semantics exactly — mAP parity depends
on every quirk here:

* ``iou_np`` uses the +1 pixel convention (utils/utils.py:248-278);
* ``get_batch_statistics`` (utils/utils.py:185-236) greedily matches
  predictions in their given order at one IoU threshold, each GT matched at
  most once, stopping early when all GTs are claimed; the class check is
  only "predicted label occurs among the image's target labels";
* ``ap_per_class`` (utils/utils.py:77-154) sorts by confidence, builds
  per-class PR curves, VOC-envelope AP (``compute_ap``, :157-182), and the
  global PR curve over classes present in the targets.

Evaluation is not a throughput path — plain numpy keeps it simple and
bit-faithful.
"""
from __future__ import annotations

import numpy as np


def iou_np(box, boxes):
    """IoU of one box [4] vs boxes [n, 4] (xyxy, +1 convention)."""
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(ix2 - ix1 + 1, 0, None) * np.clip(iy2 - iy1 + 1, 0, None)
    a1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a1 + a2 - inter + 1e-16)


def get_batch_statistics(outputs, targets, iou_threshold):
    """Per-image TP flags for mAP.

    outputs: list (len B) of [n_i, 7] arrays
             (x1, y1, x2, y2, conf, class_score, class_pred) or None;
    targets: [m, 6] (image_i, class, x1, y1, x2, y2) in image scale.
    Returns list of [tp, conf, pred_label] triples.
    """
    stats = []
    targets = np.asarray(targets)
    for image_i, output in enumerate(outputs):
        if output is None:
            continue
        output = np.asarray(output)
        pred_boxes = output[:, :4]
        pred_scores = output[:, 4]
        pred_labels = output[:, -1]
        tp = np.zeros(len(output))

        ann = targets[targets[:, 0] == image_i][:, 1:]
        if len(ann):
            claimed = []
            target_labels = ann[:, 0]
            target_boxes = ann[:, 1:]
            for pred_i in range(len(pred_boxes)):
                if len(claimed) == len(ann):
                    break
                if pred_labels[pred_i] not in target_labels:
                    continue
                ious = iou_np(pred_boxes[pred_i], target_boxes)
                best = int(ious.argmax())
                if ious[best] >= iou_threshold and best not in claimed:
                    tp[pred_i] = 1
                    claimed.append(best)
        stats.append([tp, pred_scores, pred_labels])
    return stats


def compute_ap(recall, precision):
    """VOC-style AP: precision envelope integrated over recall steps."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    steps = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[steps + 1] - mrec[steps]) * mpre[steps + 1]))


def ap_per_class(tp, conf, pred_cls, target_cls):
    """Returns (precision, recall, AP, f1, unique_classes, (p_curve, r_curve)).

    The final tuple is the all-classes-together PR curve the reference plots
    (test_fusion.py:195-208).
    """
    tp = np.asarray(tp, np.float64)
    conf = np.asarray(conf, np.float64)
    pred_cls = np.asarray(pred_cls, np.float64)
    target_cls = np.asarray(target_cls, np.float64)

    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)

    ap, p, r = [], [], []
    for c in unique_classes:
        sel = pred_cls == c
        n_p = int(sel.sum())
        n_gt = int((target_cls == c).sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            ap.append(0.0)
            p.append(0.0)
            r.append(0.0)
            continue
        fpc = (1 - tp[sel]).cumsum()
        tpc = tp[sel].cumsum()
        recall_curve = tpc / (n_gt + 1e-16)
        precision_curve = tpc / (tpc + fpc)
        r.append(recall_curve[-1])
        p.append(precision_curve[-1])
        ap.append(compute_ap(recall_curve, precision_curve))

    p, r, ap = np.array(p), np.array(r), np.array(ap)
    f1 = 2 * p * r / (p + r + 1e-16)

    in_targets = np.isin(pred_cls, unique_classes)
    tp_all = tp[in_targets]
    if len(tp_all) == 0 or len(target_cls) == 0:
        curve = (0, 0)
    else:
        fpc = (1 - tp_all).cumsum()
        tpc = tp_all.cumsum()
        curve = (tpc / (tpc + fpc), tpc / (len(target_cls) + 1e-16))
    return p, r, ap, f1, unique_classes.astype(np.int32), curve
