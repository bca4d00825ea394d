"""Fixed-shape, class-aware NMS (port of ``millieye_tpu/ops/nms.py``).

Confidence filter and score sort become a stable descending sort cut at
``pre_top_k`` (``lax.top_k`` keeps ties in index order; ``torch.topk``
promises no order, so it is not used). Class awareness is torchvision's
coordinate-offset trick. The keep mask is the greedy one, with the JAX
package's dispatch: for K <= 1024 kernel K1 (``ops/nms_kernel.py``, the
blocked kernel) when K % 128 == 0 and ``use_blocked`` is not False, else
kernel K5 (the whole-matrix kernel); above 1024 candidates the fixpoint
iteration, as the JAX package ran its XLA fixpoint there. Outputs are
padded to ``max_det`` rows with a validity mask. The post-merge pass
``nms_xyxy`` takes the same kernels, one launch for a batch of images.
"""
from __future__ import annotations

import torch

from millieye_torch.ops.boxes import iou_matrix, xywh_to_xyxy
from millieye_torch.ops.nms_kernel import (MAX_K, nms_keep_mask_blocked,
                                           nms_keep_mask_full,
                                           nms_keep_mask_full_plain)


def _class_offset(boxes, valid):
    """``boxes.max() + 1`` over the valid boxes of each image ([..., K, 4]
    -> [...]), so every class occupies a disjoint coordinate region."""
    neg = torch.full((), float("-inf"), dtype=boxes.dtype,
                     device=boxes.device)
    mx = torch.where(valid[..., None], boxes, neg).amax(dim=(-2, -1))
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)) + 1.0


def nms_keep_mask_ref(boxes_xyxy, valid, iou_thresh, plus_one=False):
    """Golden sequential greedy NMS; boxes [K, 4] score-sorted, valid [K]."""
    k = boxes_xyxy.shape[0]
    iou = iou_matrix(boxes_xyxy, boxes_xyxy, plus_one=plus_one)
    idx = torch.arange(k, device=boxes_xyxy.device)
    keep = valid.clone()
    for i in range(k):
        keep &= ~((iou[i] > iou_thresh) & (idx > i) & keep[i])
    return keep


def nms_keep_mask(boxes_xyxy, valid, iou_thresh, plus_one=False):
    """Greedy NMS keep mask by fixpoint iteration over [..., K, 4] boxes:
    F(keep)_i = valid_i and no higher-ranked kept j overlaps i, iterated
    from keep = valid until it stops changing (suppression-chain depth
    steps, at most K)."""
    k = boxes_xyxy.shape[-2]
    iou = iou_matrix(boxes_xyxy, boxes_xyxy, plus_one=plus_one)
    idx = torch.arange(k, device=boxes_xyxy.device)
    overlap = (iou > iou_thresh) & (idx[None, :] < idx[:, None])

    def step(keep):
        return valid & ~(overlap & keep[..., None, :]).any(-1)

    keep = step(valid)
    for _ in range(k):
        new = step(keep)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _compact(rows, keep, max_out):
    """Kept rows (in order) to the front of a [..., max_out, C] buffer;
    rows [..., K, C], keep [..., K]."""
    rank = torch.cumsum(keep.long(), -1) - 1
    ok = keep & (rank < max_out)
    dst = torch.where(ok, rank, torch.full_like(rank, max_out))
    # rows past max_out land in the spare slot
    lead = rows.shape[:-2]
    out = rows.new_zeros(lead + (max_out + 1, rows.shape[-1]))
    out.scatter_(-2, dst[..., None].expand_as(rows), rows)
    valid_out = torch.zeros(lead + (max_out + 1,), dtype=torch.bool,
                            device=rows.device)
    valid_out.scatter_(-1, dst, ok)
    return out[..., :max_out, :], valid_out[..., :max_out]


def _keep_mask(boxes, valid, iou_thresh, plus_one=False, use_blocked=None):
    """The greedy keep mask of score-sorted boxes [B, K, 4], with the JAX
    package's dispatch: for 0 < K <= 1024, K1 where K % 128 == 0 and
    ``use_blocked`` is not False, else K5 (a CPU tensor takes their plain
    versions; all are bit-equal to ``nms_keep_mask_ref``). Neither kernel
    takes ``plus_one``: with it, K5's plain version runs, on the card too
    (K device steps, no host sync). Other K: the fixpoint."""
    k = boxes.shape[-2]
    if not 0 < k <= MAX_K:
        return nms_keep_mask(boxes, valid, iou_thresh, plus_one)
    if plus_one:
        return nms_keep_mask_full_plain(boxes, valid, iou_thresh,
                                        plus_one=True)
    if k % 128 == 0 and use_blocked is not False:
        return nms_keep_mask_blocked(boxes, valid, iou_thresh)
    return nms_keep_mask_full(boxes, valid, iou_thresh)


def nms_xyxy(boxes, scores, labels, valid, iou_thresh, max_out,
             plus_one=False):
    """Class-aware NMS on explicit boxes [..., K, 4] (the post-merge pass);
    returns (rows [..., max_out, 6] of (x1, y1, x2, y2, score, label),
    valid). A leading batch axis holds independent images (the JAX
    package's ``jax.vmap`` of it): one keep-mask launch for all of them,
    each image's answer bit-identical to its own call."""
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-s, dim=-1, stable=True)
    boxes = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
    s, labels = torch.gather(s, -1, order), torch.gather(labels, -1, order)
    valid = torch.isfinite(s)
    shifted = boxes + (labels.to(boxes.dtype)
                       * _class_offset(boxes, valid)[..., None])[..., None]
    keep = _keep_mask(shifted.reshape(-1, *shifted.shape[-2:]).contiguous(),
                      valid.reshape(-1, valid.shape[-1]), iou_thresh,
                      plus_one).reshape(valid.shape)
    rows = torch.cat([boxes, s[..., None], labels.to(boxes.dtype)[..., None]],
                     -1)
    return _compact(rows, keep, max_out)


def _candidates(pred, conf_thresh, pre_top_k):
    """The top ``pre_top_k`` rows by objectness that pass the confidence
    filter: (rows [B, K, 5+C], xyxy boxes, class-offset boxes, valid,
    class_pred)."""
    k = min(pre_top_k, pred.shape[1])
    obj = pred[..., 4]
    score = torch.where(obj >= conf_thresh, obj,
                        torch.full_like(obj, float("-inf")))
    top_s, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top_s, idx = top_s[:, :k], idx[:, :k]
    rows_k = torch.gather(pred, 1, idx[..., None].expand(-1, -1,
                                                         pred.shape[2]))
    bxyxy = xywh_to_xyxy(rows_k[..., :4])
    v = torch.isfinite(top_s)
    class_pred = torch.argmax(rows_k[..., 5:], -1).to(pred.dtype)
    shifted = (bxyxy + (class_pred * _class_offset(bxyxy, v)[:, None])
               [..., None]).contiguous()
    return rows_k, bxyxy, shifted, v, class_pred


def batched_nms(pred, conf_thresh, iou_thresh=0.5, max_det=200,
                pre_top_k=512, use_blocked=None):
    """YOLO-decode postprocessing for a batch.

    pred [B, A, 5+C] rows of (cx, cy, w, h, obj, cls_0..) in image scale.
    Returns (detections [B, max_det, 7+C], valid [B, max_det]); a row is
    (x1, y1, x2, y2, obj, class_score, class_pred, class scores...).
    ``use_blocked=False`` pins the whole-matrix kernel K5 where K1 would
    run; every path returns the same keep set.
    """
    b = pred.shape[0]
    rows_k, bxyxy, shifted, v, class_pred = _candidates(pred, conf_thresh,
                                                        pre_top_k)
    k = shifted.shape[1]
    keep = _keep_mask(shifted, v, iou_thresh, use_blocked=use_blocked)

    # late assembly: compact the kept candidate positions, then gather
    # only the max_det surviving rows
    rank = torch.cumsum(keep.long(), 1) - 1
    ok = keep & (rank < max_det)
    dst = torch.where(ok, rank, torch.full_like(rank, max_det))
    pos = torch.arange(k, device=pred.device).expand(b, k)
    sel = torch.zeros((b, max_det + 1), dtype=torch.long, device=pred.device)
    sel.scatter_(1, dst, pos)
    valid_out = torch.zeros((b, max_det + 1), dtype=torch.bool,
                            device=pred.device)
    valid_out.scatter_(1, dst, ok)
    sel, valid_out = sel[:, :max_det], valid_out[:, :max_det]
    rd = torch.gather(rows_k, 1, sel[..., None].expand(-1, -1,
                                                       rows_k.shape[2]))
    c = rd[..., 5:]
    out = torch.cat([
        torch.gather(bxyxy, 1, sel[..., None].expand(-1, -1, 4)),
        rd[..., 4:5], c.amax(-1, keepdim=True),
        torch.gather(class_pred, 1, sel)[..., None], c], -1)
    out = torch.where(valid_out[..., None], out, torch.zeros_like(out))
    return out, valid_out


def pre_top_k_sufficient(pred, conf_thresh, iou_thresh=0.5, max_det=200,
                         pre_top_k=512):
    """[B] bool: whether cutting to the top ``pre_top_k`` objectness rows
    provably leaves ``batched_nms``'s output unchanged against NMS over
    all rows that pass the confidence filter. Suppression flows only from
    higher to lower ranks, so the cut is exact if at most ``pre_top_k``
    rows pass, or if at least ``max_det`` of the top ``pre_top_k`` rows
    survive. A diagnostic for choosing ``FusionConfig.pre_nms_top_k``,
    not part of the serving path."""
    _, _, shifted, v, _ = _candidates(pred, conf_thresh, pre_top_k)
    keep = nms_keep_mask(shifted, v, iou_thresh, plus_one=False)
    n_pass = (pred[..., 4] >= conf_thresh).sum(1)
    return (n_pass <= shifted.shape[1]) | (keep.sum(1) >= max_det)
