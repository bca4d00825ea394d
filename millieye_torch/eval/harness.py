"""Evaluation harnesses (port of ``millieye_tpu/eval/harness.py``): the
reference's three mAP scripts as library calls.

* ``evaluate_yolo``    — raw Darknet + NMS (stage-1 check,
                         module2_mixed/test_mixed.py:23-97)
* ``evaluate_refine``  — YOLO + refinement (module2_mixed/
                         test_module2.py:25-96)
* ``evaluate_fusion``  — full radar fusion with per-mode / per-illumination
                         slicing and auto mode selection
                         (module3_our_dataset/test_fusion.py:24-115)

Each takes an iterable of device batches (``train.recipes.
fusion_device_batch`` over a ``data.loader.DataLoader`` or a
``DeviceCache`` loader), runs one forward per batch under
``torch.inference_mode()`` with the preset's kernels, copies the answer
to the host once, unpads it there and feeds the numpy mAP engine
(eval/metrics.py), with the targets from the batch's host copy. Returns
(precision, recall, AP, f1, classes) per class plus the global PR curve:
the ``ap_per_class`` contract.
"""
from __future__ import annotations

import numpy as np
import torch

from millieye_torch.eval.metrics import ap_per_class, get_batch_statistics
from millieye_torch.ops.nms import batched_nms


def _unpad(boxes, valid, n=None):
    """[B, K, 7] + [B, K] -> list of [n_i, 7] numpy arrays (None if
    empty), in one copy to the host.

    ``n`` trims a tail batch that was padded to the fixed batch shape by
    repeating rows (DeviceCache loader, ``batch["_n"]``): without it the
    duplicated samples would be double-counted in mAP."""
    if n is not None:
        boxes, valid = boxes[:n], valid[:n]
    both = torch.cat([boxes.float(), valid[..., None].float()], -1)
    both = both.cpu().numpy()
    boxes, valid = both[..., :-1], both[..., -1] != 0
    return [b[v] if v.any() else None for b, v in zip(boxes, valid)]


def _batch_n(batch):
    return int(batch.get("_n", batch["images"].shape[0]))


def _targets_to_eval(targets, tmask, img_size):
    """[B, T, 5] (class, cx, cy, w, h in 0..1) -> [m, 6]
    (image_i, class, x1, y1, x2, y2) in image scale (test_fusion.py:94-99)."""
    rows = []
    targets, tmask = np.asarray(targets), np.asarray(tmask)
    for i, (t, m) in enumerate(zip(targets, tmask)):
        t = t[m]
        if not len(t):
            continue
        cx, cy, w, h = t[:, 1], t[:, 2], t[:, 3], t[:, 4]
        xyxy = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        -1) * img_size
        rows.append(np.concatenate(
            [np.full((len(t), 1), i), t[:, :1], xyxy], -1))
    return np.concatenate(rows, 0) if rows else np.zeros((0, 6))


def _host_targets(batch):
    """(targets, tmask) as numpy: the batch's host copy where it has one
    (``fusion_device_batch``, ``DeviceCache``), else its own arrays."""
    host = batch.get("host") or batch
    return (np.asarray(host["targets"]), np.asarray(host["tmask"]))


def _finish(stats, all_target_cls):
    if not stats:
        return None
    tp = np.concatenate([s[0] for s in stats])
    conf = np.concatenate([s[1] for s in stats])
    pred = np.concatenate([s[2] for s in stats])
    return ap_per_class(tp, conf, pred, all_target_cls)


def _evaluate(batches, forward, iou_thresh):
    """The loop the three harnesses share: ``forward(batch)`` -> (rows
    [B, K, 7], valid [B, K]) on the device, then the mAP statistics."""
    stats, target_cls = [], []
    for batch in batches:
        n = _batch_n(batch)
        with torch.inference_mode():
            boxes, valid = forward(batch)
        targets, tmask = _host_targets(batch)
        targets = _targets_to_eval(targets[:n], tmask[:n],
                                   batch["images"].shape[1])
        target_cls.extend(targets[:, 1].tolist())
        stats.extend(get_batch_statistics(_unpad(boxes, valid, n), targets,
                                          iou_thresh))
    return _finish(stats, target_cls)


def evaluate_yolo(darknet, params, state, batches, conf_thresh=0.5,
                  nms_thresh=0.5, iou_thresh=0.5, max_det=200):
    """Stage-1: backbone + decode + NMS only (test_mixed.py path)."""
    def forward(batch):
        out = darknet.apply(params, state, batch["images"])
        det, valid = batched_nms(out["detections"], conf_thresh, nms_thresh,
                                 max_det=max_det)
        return det[:, :, :7], valid

    return _evaluate(batches, forward, iou_thresh)


def evaluate_refine(model, params, state, batches, iou_thresh=0.5):
    """Stage-2: YOLO + refinement + ensemble (test_module2.py path)."""
    def forward(batch):
        out = model.apply(params, state, batch["images"])
        return out["boxes"], out["valid"]

    return _evaluate(batches, forward, iou_thresh)


def auto_mode(images, brightness=None):
    """mode 3 selection: dark frames -> millieye, bright -> yolo
    (test_fusion.py:24-32: img.mean() < 0.1).

    ``brightness``: the host-side batch mean (collate and DeviceCache
    provide it), so the choice never waits for the device; without it
    the mean is fetched from ``images``."""
    if brightness is None:
        brightness = float(images.mean())
    return 0 if brightness < 0.1 else 1


def evaluate_fusion(model, params, state, batches, mode=0, iou_thresh=0.5,
                    mesh=None):
    """Stage-3 full fusion. ``mode``: 0 millieye / 1 yolo / 2 radar /
    3 auto (per-batch selection). ``mesh`` must be None: sharding a batch
    over devices (the JAX package's mesh) waits for ``parallel/``
    (ROADMAP.md §1 item 9)."""
    if mesh is not None:
        raise NotImplementedError(
            "evaluate_fusion: a device mesh needs the port of parallel/ "
            "(ROADMAP.md §1 item 9); evaluate on one device")

    def forward(batch):
        m = (auto_mode(batch["images"], batch.get("brightness"))
             if mode == 3 else mode)
        out = model.apply(params, state, batch["images"],
                          batch["radar_maps"], batch["radar_boxes"],
                          batch["rmask"], mode=m)
        return out["boxes"], out["valid"]

    return _evaluate(batches, forward, iou_thresh)


def summarize(result, class_names=None):
    """ap_per_class output -> printable per-class table + mAP
    (train.py:268-271 AsciiTable equivalent)."""
    if result is None:
        return "no detections", 0.0
    p, r, ap, f1, classes = result[:5]
    lines = ["cls     name            AP      P       R       F1"]
    for i, c in enumerate(classes):
        name = (class_names[int(c)] if class_names
                and int(c) < len(class_names) else str(int(c)))
        lines.append(f"{int(c):<7d} {name:<15s} {ap[i]:.4f}  {p[i]:.4f}  "
                     f"{r[i]:.4f}  {f1[i]:.4f}")
    m_ap = float(np.mean(ap)) if len(ap) else 0.0
    lines.append(f"mAP: {m_ap:.4f}")
    return "\n".join(lines), m_ap


def save_pr_curve(result, path, title="PR curve"):
    """Write the global PR-curve artifact (test_fusion.py:195-208 /
    test_module2.py:168-187 equivalent). Returns the path or None."""
    if result is None:
        return None
    curve = result[5]
    if not hasattr(curve[0], "__len__"):
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    precision, recall = curve
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(recall, precision)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
