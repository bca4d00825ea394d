"""Plain greedy NMS with the program's contract: candidates whose
objectness passes ``conf_thresh``, the ``pre_top_k`` highest by
objectness (a stable sort: ties in index order), class-aware (a box
suppresses only boxes of its class), IoU above ``iou_thresh`` without
the +1 pixel, at most ``max_det`` kept rows."""
from __future__ import annotations

import torch


def iou(a, b):
    """a [n, 4] x b [m, 4] xyxy -> [n, m]."""
    ix1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-16)


def keep_indices(xyxy, obj, cls, conf_thresh, iou_thresh, max_det,
                 pre_top_k):
    """One image: xyxy [A, 4], objectness [A], class [A] -> the indices
    of the kept rows, highest objectness first."""
    order = torch.argsort(-obj, stable=True)
    order = order[obj[order] >= conf_thresh][:pre_top_k]
    boxes, classes = xyxy[order], cls[order]
    over = (iou(boxes, boxes) > iou_thresh) & (classes[:, None]
                                               == classes[None, :])
    over = over.cpu()
    alive = torch.ones(len(order), dtype=torch.bool)
    kept = []
    for i in range(len(order)):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == max_det:
            break
        alive &= ~over[i]
    return order[torch.tensor(kept, dtype=torch.long, device=order.device)]
