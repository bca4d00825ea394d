"""Per-frame ingest + inference (port of
``millieye_tpu/runtime/engine.py``).

  uint8 frame -> letterbox ---------------------------------------\\
  radar points -> heatmap rasterize -> pad + resize ---------------+-> fusion
  radar boxes (padded, normalized) --------------------------------/  forward
  -> post-merge NMS (IoU 0.3) -> boxes in camera coordinates

Everything after the host-side radar padding runs on the engine's
device, in eager PyTorch with the CUDA kernels on the path.
``batched_step_fn`` answers a window of frames with one forward pass of
the network and one post-merge NMS at batch = window.
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
from millieye_torch.ops.quantize import quantize_darknet
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


def fold_for_serving(model, params, state, act_absmax=None):
    """Trained weights -> the serving representation: BN folded and cast
    to the compute dtype (the hi-prec stages kept float32), the s2d and
    im2col stem transforms applied, then int8 weights and activations as
    the ``FusionConfig`` asks (``act_absmax`` from
    ``ops.quantize.calibrate_act_scales``, needed for ``acts_int8``)."""
    cd = _DTYPES[model.cfg.compute_dtype]
    dn = model.darknet
    fp, fs = dn.fold_batchnorm(params["darknet"], state["darknet"],
                               dtype=None if cd == torch.float32 else cd)
    if dn.s2d_stages:
        fp = dn.fold_s2d(fp)
    if dn.im2col_stages:
        fp = dn.fold_im2col(fp)
    if model.cfg.weights_int8:
        kw = {}
        if model.cfg.acts_int8:
            if act_absmax is None:
                raise ValueError(
                    "acts_int8 serving needs act_absmax from "
                    "ops.quantize.calibrate_act_scales (run on the "
                    "folded/s2d graph over representative frames)")
            kw = dict(act_absmax=act_absmax, act_skip=dn.act_int8_skip)
        fp = quantize_darknet(fp, **kw)
    return dict(params, darknet=fp), dict(state, darknet=fs)


class FusionEngine:
    """Owns a FusionNetwork and its weights (BN folded for serving) on one
    device; ``infer`` answers one frame."""

    def __init__(self, model, params, state, frame_size=(640, 480),
                 max_points=256, post_nms_iou=POST_NMS_IOU, fold_bn=True,
                 act_absmax=None, device="cuda"):
        self.device = resolve_device(device)
        set_numerics()
        self.model = model
        params = to_device(params, self.device)
        state = to_device(state, self.device)
        if fold_bn:
            params, state = fold_for_serving(model, params, state,
                                             act_absmax)
        self.params, self.state = params, state
        self.frame_size = frame_size
        self.max_points = max_points
        self.post_nms_iou = post_nms_iou

    def _ingest(self, frame_u8, points, pmask):
        """One frame -> (letterboxed image [S, S, 3], heatmap [S/16, S/16,
        3])."""
        s = self.model.darknet.img_size
        img, _ = lb.letterbox_image(frame_u8, s)
        heat = radar_heatmap(points, pmask, self.frame_size)
        heat, _ = lb.pad_to_square(heat, 0.0)
        return img, lb.resize_bilinear_align_corners(heat, s // 16)

    def _post(self, boxes, valid):
        """Post-merge NMS across image and radar rows, then boxes to
        camera coordinates: rows [..., K, 7] -> ([..., K, 6], valid
        [..., K]); a window's frames in one call."""
        w, h = self.frame_size
        merged, mvalid = nms_xyxy(boxes[..., :4], boxes[..., 4],
                                  boxes[..., 6].int(), valid,
                                  self.post_nms_iou, boxes.shape[-2])
        cam = rescale_boxes(merged[..., :4], self.model.darknet.img_size,
                            (h, w))
        return torch.cat([cam, merged[..., 4:]], -1), mvalid

    def step_fn(self, mode=0):
        """(frame_u8, points, pmask, radar_boxes, radar_mask) tensors on
        the engine's device -> (rows [K, 6], valid [K])."""
        @torch.no_grad()
        def step(frame_u8, points, pmask, radar_boxes, radar_mask):
            points, pmask, radar_boxes, radar_mask = _sanitize_radar(
                points, pmask, radar_boxes, radar_mask)
            img, heat = self._ingest(frame_u8, points, pmask)
            out = self.model.apply(self.params, self.state, img[None],
                                   heat[None], radar_boxes[None],
                                   radar_mask[None], mode=mode)
            return self._post(out["boxes"][0], out["valid"][0])

        return step

    def batched_step_fn(self, mode=0):
        """Window-of-frames step: (frames_u8 [W, H, W, 3], points [W, P,
        4], pmask [W, P], radar_boxes [W, R, 4], radar_mask [W, R]) on the
        engine's device -> (rows [W, K, 6], valid [W, K]). Ingest runs
        frame by frame, the network once at batch = window, and the
        post-merge NMS once for the window (as the JAX package's
        ``jax.vmap`` of it: one keep-mask launch). The auto mode is chosen
        per frame, so a window needs a static mode."""
        if mode == 3:
            raise ValueError("auto mode is per-frame; batched windows need "
                             "a static mode (0/1/2)")

        @torch.no_grad()
        def step(frames_u8, points, pmask, radar_boxes, radar_mask):
            points, pmask, radar_boxes, radar_mask = _sanitize_radar(
                points, pmask, radar_boxes, radar_mask)
            ingest = [self._ingest(f, p, m)
                      for f, p, m in zip(frames_u8, points, pmask)]
            out = self.model.apply(
                self.params, self.state, torch.stack([i for i, _ in ingest]),
                torch.stack([h for _, h in ingest]), radar_boxes, radar_mask,
                mode=mode)
            return self._post(out["boxes"], out["valid"])

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

    def warmup(self, mode=0):
        """One all-zero frame through ``infer``: builds and loads the
        kernels, and pays the first-call costs of the libraries. Mode 3
        warms both of its branches."""
        w, h = self.frame_size
        if mode == 3:
            self.warmup(0)
            return self.warmup(1)
        return self.infer(np.zeros((h, w, 3), np.uint8), np.zeros((0, 4)),
                          np.zeros((0, 4)), mode)
