"""Radar+camera fusion detector ("module3") and the camera-only
refinement detector ("module2"), inference only (port of
``millieye_tpu/models/fusion.py``: ``FusionNetwork``, ``RefineNetwork``).

backbone -> YOLO decode -> class-aware NMS -> score maps -> RoI crops ->
refinement / ensemble heads -> regression and priority sort, over padded
tensors with validity masks:

* image proposals [B, max_det, ...] from NMS, radar proposals
  [B, max_radar, 4] normalized to (0, 1);
* output rows [B, max_det + max_radar, 7] of (x1, y1, x2, y2, conf,
  class_score, class_pred) with ``valid``, sorted per image by the
  reference's priority (radar confidence divided by 5).

Modes: 0 millieye, 1 yolo only, 2 radar only.

``RefineNetwork``: frozen YOLO -> NMS -> PS-RoIAlign over a 490-channel
score map -> refinement head -> ensemble head -> re-scored, regressed
boxes [B, max_det, 7]; no radar branch, all classes kept.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from millieye_torch.device import constant
from millieye_torch.models import heads
from millieye_torch.models.darknet import Darknet
from millieye_torch.ops.boxes import box_regress
from millieye_torch.ops.nms import batched_nms
from millieye_torch.ops.roi_align import (ps_roi_align_batched,
                                          roi_align_batched)
from millieye_torch.ops.roi_kernel import (PRECISIONS, REDUCES,
                                           ps_channel_perm_pad, ps_roi_align,
                                           ps_roi_align_padded, roi_align)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass
class FusionConfig:
    conf_thresh: float = 0.2
    nms_thresh: float = 0.5
    class_num: int = 1            # module3: person-only refinement
    class_idx: int = 0            # keep only this YOLO class
    max_det: int = 200            # detections per image
    max_radar: int = 32           # padded radar proposals per image
    pre_nms_top_k: int = 512
    refine_threshold_img: float = 0.0
    refine_threshold_radar: float = 0.0
    sampling_max: int = 4         # RoIAlign adaptive grid bound
    compute_dtype: str = "float32"   # backbone convolutions
    heads_dtype: str = "float32"     # score maps, RoI crops, heads
    nms_use_blocked: bool = None  # None: kernel K1 at K % 128 == 0;
                                  # False pins the whole-matrix kernel K5
    roi_impl: str = "einsum"      # "einsum" or "kernel" (the RoI kernels)
    roi_precision: str = "default"   # the kernels' ladder: "default" (bf16
                                     # products), "split" or "highest"
    roi_reduce: str = "dot"          # K2's w-sum as the TPU named it, "dot"
                                     # or "vpu": one kernel on the card
    weights_int8: bool = False       # serving: backbone conv weights int8
                                     # (per-output-channel scales)
    acts_int8: bool = False          # serving: conv inputs int8 too
                                     # (calibrated scales; needs
                                     # weights_int8 and an act_absmax)


def _eff_sampling_max(cfg, img_size):
    """The static sampling grid must cover an image-spanning RoI:
    ceil(img/16/7) rows (4 at 416 px, the default)."""
    return max(cfg.sampling_max, math.ceil(img_size / 16 / 7))


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _check_config(cfg):
    if cfg.roi_impl not in ("einsum", "kernel"):
        raise ValueError(f"unknown roi_impl {cfg.roi_impl!r}")
    if cfg.roi_precision not in PRECISIONS:
        raise ValueError(f"unknown roi_precision {cfg.roi_precision!r}")
    if cfg.roi_reduce not in REDUCES:
        raise ValueError(f"unknown roi_reduce {cfg.roi_reduce!r}")


class FusionNetwork:
    """Radar+camera fusion detector over explicit parameters."""

    def __init__(self, darknet: Darknet, config: FusionConfig = None):
        self.darknet = darknet
        self.cfg = config or FusionConfig()
        _check_config(self.cfg)

    def apply(self, params, state, images, radar_maps, radar_boxes,
              radar_mask, mode=0):
        """images [B, S, S, 3] letterboxed float; radar_maps [B, S/16,
        S/16, 3]; radar_boxes [B, R, 4] xyxy in (0, 1), radar_mask [B, R].
        Returns {"boxes" [B, K+R, 7], "valid" [B, K+R], ...}."""
        cfg = self.cfg
        b_sz, img_size = images.shape[0], images.shape[1]
        k_img, r_rad = cfg.max_det, cfg.max_radar
        dev = images.device

        d_out = self.darknet.apply(params["darknet"], state["darknet"], images,
                                   compute_dtype=_DTYPES[cfg.compute_dtype])
        det, det_valid = batched_nms(
            d_out["detections"], cfg.conf_thresh, cfg.nms_thresh,
            max_det=k_img, pre_top_k=cfg.pre_nms_top_k,
            use_blocked=cfg.nms_use_blocked)
        det_valid = det_valid & (det[:, :, 6].long() == cfg.class_idx)
        img_xyxy, img_conf = det[:, :, 0:4], det[:, :, 4]
        img_class_score, img_class_pred = det[:, :, 5], det[:, :, 6]
        img_cls_scores = det[:, :, 7:]

        if mode == 1:
            boxes_out = torch.cat([img_xyxy, img_conf[..., None],
                                   img_class_score[..., None],
                                   img_class_pred[..., None]], -1)
            return {"boxes": boxes_out, "valid": det_valid, "num_img": k_img}

        hd = _DTYPES[cfg.heads_dtype]
        p_img, s_img = _cast_floats((params["img_cnn"], state["img_cnn"]), hd)
        p_rad, s_rad = _cast_floats((params["radar_enc"], state["radar_enc"]),
                                    hd)
        p_ref, s_ref = _cast_floats((params["refine"], state["refine"]), hd)
        p_ens = _cast_floats(params["ensemble"], hd)
        radar_maps = radar_maps.to(hd)
        use_kernel_roi = cfg.roi_impl == "kernel"
        roi_c_out = None
        if use_kernel_roi:
            # permute AND pad the score-map conv's output channels (a few
            # KB of weights and BN vectors) so the map is born in the
            # [..., 7*128] layout kernel K2 reads
            last_w = p_img[-1]["w"]
            roi_c_out = last_w.shape[0] // 49
            dst = constant(tuple(ps_channel_perm_pad(roi_c_out, 7, 7)
                                 .tolist()), dev, torch.int64)
            c_pad = 7 * 128

            def scat(v, fill):
                out = torch.full((c_pad,) + v.shape[1:], fill, dtype=v.dtype,
                                 device=v.device)
                out[dst] = v
                return out

            last = dict(p_img[-1], w=scat(last_w, 0.0),
                        b=scat(p_img[-1]["b"], 0.0),
                        bn={"gamma": scat(p_img[-1]["bn"]["gamma"], 0.0),
                            "beta": scat(p_img[-1]["bn"]["beta"], 0.0)})
            p_img = p_img[:-1] + [last]
            s_img = s_img[:-1] + [{"mean": scat(s_img[-1]["mean"], 0.0),
                                   "var": scat(s_img[-1]["var"], 1.0)}]
        roi_score_map = heads.conv_bn_stack_apply(
            p_img, s_img, d_out["feature_map"].to(hd))
        radar_score_map = heads.radar_encoder_apply(p_rad, s_rad, radar_maps)

        radar_xyxy = radar_boxes * img_size
        all_xyxy = torch.cat([img_xyxy, radar_xyxy], 1)
        all_valid = torch.cat([det_valid, radar_mask], 1)
        n_all = k_img + r_rad

        smax = _eff_sampling_max(cfg, img_size)
        if use_kernel_roi:
            # "default": kernels K2 and K3 on bf16 operands; "split" and
            # "highest": kernel K7 and K3 on float32 operands
            img_crop = ps_roi_align_padded(
                roi_score_map, all_xyxy, (7, 7), 1.0 / 16, sampling_max=smax,
                c_out=roi_c_out, precision=cfg.roi_precision,
                reduce=cfg.roi_reduce)
            radar_crop = roi_align(radar_score_map, all_xyxy, (7, 7),
                                   1.0 / 16, sampling_max=smax,
                                   precision=cfg.roi_precision)
        else:
            img_crop = ps_roi_align_batched(roi_score_map, all_xyxy, (7, 7),
                                            1.0 / 16, sampling_max=smax,
                                            compute_dtype=hd)
            radar_crop = roi_align_batched(radar_score_map, all_xyxy, (7, 7),
                                           1.0 / 16, sampling_max=smax,
                                           compute_dtype=hd)
        img_crop = img_crop.to(hd).reshape(b_sz * n_all, 7, 7, -1)
        radar_crop = radar_crop.to(hd).reshape(b_sz * n_all, 7, 7, -1)

        regress_param, refinement_vector = heads.refinement_head_apply(
            p_ref, s_ref, radar_crop, img_crop, class_num=cfg.class_num)
        regress_param = regress_param.float().reshape(b_sz, n_all, 4)
        refinement_vector = refinement_vector.float().reshape(
            b_sz, n_all, 1 + cfg.class_num)

        yolo_vector = torch.cat([img_conf[..., None],
                                 img_cls_scores[:, :, :cfg.class_num]], -1)
        ens = heads.ensemble_head_apply(
            p_ens,
            refinement_vector[:, :k_img].to(hd).reshape(b_sz * k_img, -1),
            yolo_vector.to(hd).reshape(b_sz * k_img, -1),
        ).float().reshape(b_sz, k_img, 2)
        fg = torch.cat([ens[:, :, 0], refinement_vector[:, k_img:, 0]], 1)

        thr = torch.cat([
            torch.full((k_img,), 1.0 if mode == 2 else
                       cfg.refine_threshold_img, device=dev),
            torch.full((r_rad,), cfg.refine_threshold_radar, device=dev)])
        positive = all_valid & (fg > thr[None, :])
        out_xyxy = (all_xyxy if mode == 2
                    else box_regress(regress_param, all_xyxy))
        class_score = torch.cat([img_class_score,
                                 refinement_vector[:, k_img:, 1]], 1)
        class_pred = torch.cat([img_class_pred,
                                torch.zeros((b_sz, r_rad), device=dev)], 1)
        boxes_out = torch.cat([out_xyxy, fg[..., None], class_score[..., None],
                               class_pred[..., None]], -1)

        priority = fg * torch.cat([torch.ones(k_img, device=dev),
                                   torch.full((r_rad,), 1.0 / 5,
                                              device=dev)])[None, :]
        priority = torch.where(positive, priority,
                               torch.full_like(priority, float("-inf")))
        order = torch.argsort(-priority, dim=1, stable=True)
        boxes_out = torch.gather(boxes_out, 1,
                                 order[..., None].expand(-1, -1, 7))
        out_valid = torch.gather(positive, 1, order)
        boxes_out = torch.where(out_valid[..., None], boxes_out,
                                torch.zeros_like(boxes_out))
        return {"boxes": boxes_out, "valid": out_valid, "num_img": k_img,
                "radar_attention": radar_score_map[..., :1]}


class RefineNetwork:
    """Camera-only refinement detector ("module2") over explicit
    parameters ``{"darknet", "fcn", "refine", "ensemble"}``. Differences
    from ``FusionNetwork``: no radar branch, all classes kept, the
    ensemble's second layer has a LeakyReLU, and channel 1 of its output
    is p(foreground)."""

    def __init__(self, darknet: Darknet, config: FusionConfig = None):
        self.darknet = darknet
        self.cfg = config or FusionConfig(class_num=12)
        _check_config(self.cfg)

    def init_heads(self, gen):
        """(params, state) of the refinement and ensemble heads from an
        explicit ``torch.Generator``, for serving a checkpoint that has
        none: untrained heads, in the trained layout."""
        ref_p, ref_s = heads.refinement_head_init(
            gen, net2_out=self.cfg.class_num + 1, with_radar=False)
        ens_p = heads.ensemble_head_init(gen, self.cfg.class_num)
        return {"refine": ref_p, "ensemble": ens_p}, {"refine": ref_s}

    def apply(self, params, state, images):
        """images [B, S, S, 3] letterboxed float -> {"boxes" [B, K, 7] rows
        of (x1, y1, x2, y2, p(foreground), class_score, class_pred),
        "valid" [B, K]}, sorted by p(foreground)."""
        cfg = self.cfg
        b_sz, img_size = images.shape[0], images.shape[1]
        k_img = cfg.max_det

        d_out = self.darknet.apply(params["darknet"], state["darknet"], images,
                                   compute_dtype=_DTYPES[cfg.compute_dtype])
        det, det_valid = batched_nms(
            d_out["detections"], cfg.conf_thresh, cfg.nms_thresh,
            max_det=k_img, pre_top_k=cfg.pre_nms_top_k,
            use_blocked=cfg.nms_use_blocked)
        img_xyxy = det[:, :, 0:4]

        hd = _DTYPES[cfg.heads_dtype]
        p_fcn, s_fcn = _cast_floats((params["fcn"], state["fcn"]), hd)
        p_ref, s_ref = _cast_floats((params["refine"], state["refine"]), hd)
        p_ens = _cast_floats(params["ensemble"], hd)
        roi_score_map = heads.conv_bn_stack_apply(
            p_fcn, s_fcn, d_out["feature_map"].to(hd))

        smax = _eff_sampling_max(cfg, img_size)
        if cfg.roi_impl == "kernel":
            img_crop = ps_roi_align(roi_score_map, img_xyxy, (7, 7), 1.0 / 16,
                                    sampling_max=smax,
                                    precision=cfg.roi_precision)
        else:
            img_crop = ps_roi_align_batched(roi_score_map, img_xyxy, (7, 7),
                                            1.0 / 16, sampling_max=smax,
                                            compute_dtype=hd)
        img_crop = img_crop.to(hd).reshape(b_sz * k_img, 7, 7, -1)

        regress_param, refinement_vector = heads.refinement_head_apply(
            p_ref, s_ref, None, img_crop, class_num=cfg.class_num)
        regress_param = regress_param.float().reshape(b_sz, k_img, 4)
        refinement_vector = refinement_vector.float().reshape(b_sz, k_img, -1)

        yolo_vector = torch.cat([det[:, :, 4:5], det[:, :, 7:]], -1)
        masks = heads.ensemble_head_apply(
            p_ens, refinement_vector.to(hd).reshape(b_sz * k_img, -1),
            yolo_vector.to(hd).reshape(b_sz * k_img, -1), fc2_leaky=True,
        ).float().reshape(b_sz, k_img, 2)
        fg = masks[:, :, 1]

        positive = det_valid & (fg > cfg.refine_threshold_img)
        out_xyxy = box_regress(regress_param, img_xyxy)
        boxes_out = torch.cat([out_xyxy, fg[..., None], det[:, :, 5:6],
                               det[:, :, 6:7]], -1)
        priority = torch.where(positive, fg,
                               torch.full_like(fg, float("-inf")))
        order = torch.argsort(-priority, dim=1, stable=True)
        boxes_out = torch.gather(boxes_out, 1,
                                 order[..., None].expand(-1, -1, 7))
        out_valid = torch.gather(positive, 1, order)
        boxes_out = torch.where(out_valid[..., None], boxes_out,
                                torch.zeros_like(boxes_out))
        return {"boxes": boxes_out, "valid": out_valid, "num_img": k_img}
