"""Per-frame ingest + inference (port of
``millieye_tpu/runtime/engine.py``).

  uint8 frame -> letterbox ---------------------------------------\\
  radar points -> heatmap rasterize -> pad + resize ---------------+-> fusion
  radar boxes (padded, normalized) --------------------------------/  forward
  -> post-merge NMS (IoU 0.3) -> boxes in camera coordinates

Everything after the host-side radar padding runs on the engine's
device, in eager PyTorch with the CUDA kernels on the path.
"""
from __future__ import annotations

import numpy as np
import torch

from millieye_torch.device import resolve_device, set_numerics
from millieye_torch.io.checkpoint import to_device
from millieye_torch.models.fusion import _DTYPES
from millieye_torch.ops import letterbox as lb
from millieye_torch.ops.boxes import rescale_boxes
from millieye_torch.ops.nms import nms_xyxy
from millieye_torch.ops.rasterize import radar_heatmap
from millieye_torch.radar.pipeline import normalize_boxes_to_padded, pad_rows

POST_NMS_IOU = 0.3      # post-merge NMS across image and radar rows


def _sanitize_radar(points, pmask, radar_boxes, radar_mask):
    """Make untrusted sensor inputs total: non-finite points and boxes
    are masked out, box coordinates clamp to (0, 1), empty boxes drop."""
    points = points.float()
    pmask = pmask & torch.isfinite(points).all(-1)
    points = torch.where(torch.isfinite(points), points,
                         torch.zeros_like(points))
    rb = radar_boxes.float()
    finite_rb = torch.isfinite(rb).all(-1)
    rb = torch.where(torch.isfinite(rb), rb, torch.zeros_like(rb)).clamp(0, 1)
    nonempty = (rb[..., 2] > rb[..., 0]) & (rb[..., 3] > rb[..., 1])
    return points, pmask, rb, radar_mask & finite_rb & nonempty


def fold_for_serving(model, params, state):
    """Trained weights -> the serving representation: BN folded, cast to
    the compute dtype, the hi-prec stages kept float32."""
    cd = _DTYPES[model.cfg.compute_dtype]
    fp, fs = model.darknet.fold_batchnorm(
        params["darknet"], state["darknet"],
        dtype=None if cd == torch.float32 else cd)
    return dict(params, darknet=fp), dict(state, darknet=fs)


class FusionEngine:
    """Owns a FusionNetwork and its weights (BN folded for serving) on one
    device; ``infer`` answers one frame."""

    def __init__(self, model, params, state, frame_size=(640, 480),
                 max_points=256, device="cuda"):
        self.device = resolve_device(device)
        set_numerics()
        self.model = model
        self.params, self.state = fold_for_serving(
            model, to_device(params, self.device),
            to_device(state, self.device))
        self.frame_size = frame_size
        self.max_points = max_points

    def step_fn(self, mode=0):
        """(frame_u8, points, pmask, radar_boxes, radar_mask) tensors on
        the engine's device -> (rows [K, 6], valid [K])."""
        s = self.model.darknet.img_size
        w, h = self.frame_size

        @torch.no_grad()
        def step(frame_u8, points, pmask, radar_boxes, radar_mask):
            points, pmask, radar_boxes, radar_mask = _sanitize_radar(
                points, pmask, radar_boxes, radar_mask)
            img, _ = lb.letterbox_image(frame_u8, s)
            heat = radar_heatmap(points, pmask, (w, h))
            heat, _ = lb.pad_to_square(heat, 0.0)
            heat = lb.resize_bilinear_align_corners(heat, s // 16)
            out = self.model.apply(self.params, self.state, img[None],
                                   heat[None], radar_boxes[None],
                                   radar_mask[None], mode=mode)
            boxes, valid = out["boxes"][0], out["valid"][0]
            merged, mvalid = nms_xyxy(boxes[:, :4], boxes[:, 4],
                                      boxes[:, 6].int(), valid,
                                      POST_NMS_IOU, boxes.shape[0])
            cam = rescale_boxes(merged[:, :4], s, (h, w))
            return torch.cat([cam, merged[:, 4:]], -1), mvalid

        return step

    def pack_radar(self, points_uvzv, proposals_xyxy):
        """Host-side padding of the radar pipeline outputs."""
        pts, pmask = pad_rows(points_uvzv, self.max_points, 4)
        norm, valid = normalize_boxes_to_padded(proposals_xyxy,
                                                self.frame_size)
        rb, rmask = pad_rows(norm, self.model.cfg.max_radar, 4)
        rmask[:valid.shape[0]] &= valid[:self.model.cfg.max_radar]
        return pts, pmask, rb, rmask

    def infer(self, frame_u8, points_uvzv, proposals_xyxy, mode=0):
        """One frame -> (boxes [K, 6] camera coordinates, valid [K]) as
        numpy. Mode 3 picks fusion (0) for dark frames (mean < 0.1 of
        full scale) and yolo only (1) otherwise."""
        if mode == 3:
            mode = 0 if float(np.mean(frame_u8)) < 0.1 * 255 else 1
        dev = self.device
        arrays = (frame_u8,) + self.pack_radar(points_uvzv, proposals_xyxy)
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in arrays]
        boxes, valid = self.step_fn(mode)(*tensors)
        return boxes.cpu().numpy(), valid.cpu().numpy()
