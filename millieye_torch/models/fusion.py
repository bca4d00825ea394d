"""Radar+camera fusion detector ("module3") and the camera-only
refinement detector ("module2"): inference, training and initialisation
(port of ``millieye_tpu/models/fusion.py``: ``FusionNetwork``,
``RefineNetwork``).

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

Training (``apply(train=True, targets=, tmask=, draw=)``): the Darknet
and its NMS run in eval mode under ``torch.no_grad()`` (the base detector
is frozen, and its kernels have no backward); the heads run in train mode
in float32 with the einsum crops, and the output gains ``loss``,
``metrics`` and the new ``state``. The losses (``_losses``): IoU labels
against same-class targets (+1 pixel), k = min(balance_factor * pos,
neg) negatives chosen at random, a focal loss on the image proposals, a
confidence BCE, and (module2) the smooth-L1 regression and category BCE.
The random numbers come from ``draw(kind, shape)``: "negatives", uniform
[0, 1) float32 keys, and "dropout", module2's bool keep mask at p 0.5
(``train/steps.py:generator_draw`` draws them from a ``torch.Generator``).

Under an active mesh (``parallel/``) a rank holds its slice of the
batch: the negatives' budget and each key's rank are the global batch's
(every rank draws the global keys and keeps its slice, as module2's
dropout mask), the BN statistics are global, and the losses are the
rank's partial sums. The layers listed in ``TP_LEAVES`` run
tensor-parallel where the train step sharded their weights over "model":
the score-map convolution column-parallel, the refinement head's
``net0``-``net2`` row-parallel.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, replace

import torch

from millieye_torch.device import constant
from millieye_torch.io.checkpoint import to_device
from millieye_torch.models import heads
from millieye_torch.models.darknet import Darknet
from millieye_torch.ops.boxes import (box_regress, encode_boxes,
                                      iou_matrix, xywh_to_xyxy)
from millieye_torch.ops.nms import batched_nms
from millieye_torch.ops.roi_align import (ps_roi_align_batched,
                                          roi_align_batched)
from millieye_torch.ops.roi_kernel import (PRECISIONS, REDUCES,
                                           ps_channel_perm_pad, ps_roi_align,
                                           ps_roi_align_padded, roi_align)
from millieye_torch.parallel import collectives as pc

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
    iou_thresh: tuple = (0.3, 0.7)   # training labels: neg below, pos above
    alpha: float = 0.75              # focal loss
    balance_factor: int = 5          # negatives per positive
    loss_lambda: tuple = (6.0, 1.0)  # module3's divisors
    refine_threshold_img: float = 0.0
    refine_threshold_radar: float = 0.0
    loss_variant: str = "module3"    # or "module2" (regression, category)
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


def _row_parallel():
    return tuple(n for n in ("net0", "net1", "net2")
                 if pc.model_parallel(("refine", n, "w")))


class FusionNetwork:
    """Radar+camera fusion detector over explicit parameters."""

    # the leaves whose layers can run tensor-parallel over "model"
    TP_LEAVES = frozenset({("img_cnn", "0", "w"), ("refine", "net0", "w"),
                           ("refine", "net1", "w"), ("refine", "net2", "w")})

    def __init__(self, darknet: Darknet, config: FusionConfig = None):
        self.darknet = darknet
        self.cfg = config or FusionConfig()
        _check_config(self.cfg)

    def init(self, gen, device="cpu"):
        """(params, state) from an explicit ``torch.Generator``, in the
        JAX package's tree: the Darknet, then the 256 -> 490 score-map
        stack, the radar encoder, the refinement head and the ensemble
        head, drawn on the CPU in that order and moved to ``device``."""
        d_params, d_state = self.darknet.init(gen)
        img_cnn_p, img_cnn_s = heads.conv_bn_stack_init(gen, (256, 490))
        radar_p, radar_s = heads.radar_encoder_init(gen)
        ref_p, ref_s = heads.refinement_head_init(gen, with_radar=True)
        ens_p = heads.ensemble_head_init(gen, self.cfg.class_num)
        params = {"darknet": d_params, "img_cnn": img_cnn_p,
                  "radar_enc": radar_p, "refine": ref_p, "ensemble": ens_p}
        state = {"darknet": d_state, "img_cnn": img_cnn_s,
                 "radar_enc": radar_s, "refine": ref_s}
        return to_device(params, device), to_device(state, device)

    def apply(self, params, state, images, radar_maps, radar_boxes,
              radar_mask, mode=0, train=False, targets=None, tmask=None,
              draw=None):
        """images [B, S, S, 3] letterboxed float; radar_maps [B, S/16,
        S/16, 3]; radar_boxes [B, R, 4] xyxy in (0, 1), radar_mask [B, R].
        Returns {"boxes" [B, K+R, 7], "valid" [B, K+R], ...}; with
        ``train`` (targets [B, T, 5] of (class, cx, cy, w, h) in (0, 1),
        tmask [B, T], ``draw`` the random numbers) also "loss", "metrics"
        and the new "state"."""
        cfg = self.cfg
        b_sz, img_size = images.shape[0], images.shape[1]
        k_img, r_rad = cfg.max_det, cfg.max_radar
        dev = images.device

        det, det_valid, feature_map = _frozen_forward(self, params, state,
                                                      images, train)
        det_valid = det_valid & (det[:, :, 6].long() == cfg.class_idx)
        img_xyxy, img_conf = det[:, :, 0:4], det[:, :, 4]
        img_class_score, img_class_pred = det[:, :, 5], det[:, :, 6]
        img_cls_scores = det[:, :, 7:]

        if mode == 1:
            boxes_out = torch.cat([img_xyxy, img_conf[..., None],
                                   img_class_score[..., None],
                                   img_class_pred[..., None]], -1)
            return {"boxes": boxes_out, "valid": det_valid, "num_img": k_img}

        # the heads train in float32, with the einsum crops
        hd = torch.float32 if train else _DTYPES[cfg.heads_dtype]
        p_img, s_img = _cast_floats((params["img_cnn"], state["img_cnn"]), hd)
        p_rad, s_rad = _cast_floats((params["radar_enc"], state["radar_enc"]),
                                    hd)
        p_ref, s_ref = _cast_floats((params["refine"], state["refine"]), hd)
        p_ens = _cast_floats(params["ensemble"], hd)
        radar_maps = radar_maps.to(hd)
        use_kernel_roi = cfg.roi_impl == "kernel" and not train
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
        roi_score_map, img_cnn_s = heads.conv_bn_stack_apply(
            p_img, s_img, feature_map.to(hd), train,
            col_parallel=(0,) if pc.model_parallel(("img_cnn", "0", "w"))
            else ())
        radar_score_map, radar_enc_s = heads.radar_encoder_apply(
            p_rad, s_rad, radar_maps, train)

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

        regress_param, refinement_vector, refine_s = \
            heads.refinement_head_apply(
                p_ref, s_ref, radar_crop, img_crop,
                valid=all_valid.reshape(-1).to(hd) if train else None,
                train=train,
                class_num=cfg.class_num, row_parallel=_row_parallel())
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
        result = _sorted_rows(
            torch.cat([out_xyxy, fg[..., None], class_score[..., None],
                       class_pred[..., None]], -1),
            fg * torch.cat([torch.ones(k_img, device=dev),
                            torch.full((r_rad,), 1.0 / 5,
                                       device=dev)])[None, :], positive)
        result.update(num_img=k_img,
                      radar_attention=radar_score_map[..., :1])
        if not train:
            return result
        new_state = {"darknet": state["darknet"], "img_cnn": img_cnn_s,
                     "radar_enc": radar_enc_s, "refine": refine_s}
        loss, metrics = _losses(
            cfg, draw, targets, tmask, all_xyxy, all_valid, class_pred,
            regress_param, refinement_vector, fg, positive, k_img, img_size)
        result.update(loss=loss, metrics=metrics, state=new_state)
        return result


def _frozen_forward(model, params, state, images, train):
    """The base detector and its NMS: (detections [B, max_det, 7+C],
    valid, feature map NHWC). Eval-mode BN always (the reference keeps
    the base detector in eval mode while the heads train); under
    ``torch.no_grad()`` in training, so that no kernel sees a tensor that
    requires grad (detections and feature map are the JAX package's
    ``stop_gradient`` outputs)."""
    cfg = model.cfg
    with torch.no_grad() if train else contextlib.nullcontext():
        d_out = model.darknet.apply(params["darknet"], state["darknet"],
                                    images,
                                    compute_dtype=_DTYPES[cfg.compute_dtype])
        det, det_valid = batched_nms(
            d_out["detections"], cfg.conf_thresh, cfg.nms_thresh,
            max_det=cfg.max_det, pre_top_k=cfg.pre_nms_top_k,
            use_blocked=cfg.nms_use_blocked)
    return det, det_valid, d_out["feature_map"]


def _sorted_rows(rows, priority, positive):
    """Rows [B, N, 7] sorted by priority among the positives (stable),
    zeroed where not valid: {"boxes", "valid"}."""
    priority = torch.where(positive, priority,
                           torch.full_like(priority, float("-inf")))
    order = torch.argsort(-priority, dim=1, stable=True)
    boxes_out = torch.gather(rows, 1, order[..., None].expand(-1, -1, 7))
    out_valid = torch.gather(positive, 1, order)
    boxes_out = torch.where(out_valid[..., None], boxes_out,
                            torch.zeros_like(boxes_out))
    return {"boxes": boxes_out, "valid": out_valid}


def _losses(cfg, draw, targets, tmask, all_xyxy, all_valid, class_pred,
            regress_param, refinement_vector, fg, positive, k_img, img_size):
    """The training losses over the proposals (all [B, N, ...]):
    (total, metrics). ``draw("negatives", [B*N])`` gives the uniform keys
    that choose the negatives."""
    if draw is None:
        raise ValueError("training needs draw(kind, shape), the random "
                         "numbers of the negative sampling")
    b_sz, n_all = all_valid.shape
    dev = all_valid.device
    with torch.no_grad():
        t_cls = targets[..., 0]
        t_xyxy = xywh_to_xyxy(targets[..., 1:5]) * img_size
        # vectorized IoU labels: max IoU over same-image, same-class targets
        iou = iou_matrix(all_xyxy, t_xyxy, plus_one=True)          # [B, N, T]
        ok = ((class_pred[:, :, None] == t_cls[:, None, :])
              & tmask.bool()[:, None, :] & all_valid[:, :, None])
        iou = torch.where(ok, iou, torch.zeros_like(iou))
        iou_labels = iou.amax(2)
        best = torch.argmax(iou, 2)
        target_loc = torch.gather(t_xyxy, 1,
                                  best[..., None].expand(-1, -1, 4))

        pos = (iou_labels > cfg.iou_thresh[1]) & all_valid
        neg = (iou_labels < cfg.iou_thresh[0]) & all_valid
        # balanced sampling: k = min(balance_factor * pos, neg) negatives,
        # the k of smallest random key, over the global batch
        flat_pos, flat_neg = pos.reshape(-1), neg.reshape(-1)
        all_pos, all_neg = pc.data_gather(flat_pos), pc.data_gather(flat_neg)
        top_k = torch.minimum(all_pos.sum() * cfg.balance_factor,
                              all_neg.sum())
        keys = draw("negatives", all_neg.shape).to(dev)
        keys = torch.where(all_neg, keys, torch.full_like(keys, float("inf")))
        rank = torch.argsort(torch.argsort(keys, stable=True), stable=True)
        sample = flat_pos | (flat_neg & pc.data_slice(rank < top_k))
        is_img = (torch.arange(n_all, device=dev) < k_img).repeat(b_sz)
        w_img = (sample & is_img).float()
        w_pos = flat_pos.float()
        label2 = torch.stack([1.0 - w_pos, w_pos], -1)
        enc = encode_boxes(all_xyxy.reshape(-1, 4), target_loc.reshape(-1, 4))
        cls = class_pred.reshape(-1).long() - cfg.class_idx
        # one_hot as JAX's: an index out of range gives a row of zeros
        cls_onehot = (cls[:, None] == torch.arange(cfg.class_num, device=dev)
                      ).float()

    flat_fg = fg.reshape(-1)
    masks2 = torch.stack([1 - flat_fg, flat_fg], -1)
    # focal loss over the sampled image proposals
    masks_loss = heads.focal_loss(masks2, label2, w_img, cfg.alpha)
    rv = refinement_vector.reshape(-1, refinement_vector.shape[-1])
    # confidence BCE over every sampled proposal
    conf_loss = heads.bce_sum(rv[:, 0], w_pos, sample.float())
    # regression smooth-L1 on the positives
    rp = regress_param.reshape(-1, 4)
    loss_xy = heads.smooth_l1_sum(rp[:, :2], enc[:, :2], w_pos)
    loss_wh = heads.smooth_l1_sum(rp[:, 2:], enc[:, 2:], w_pos)
    # category BCE on the positives (the detector's class ids, shifted to
    # the refinement vector's channels)
    category_loss = heads.bce_sum(rv[:, 1:], cls_onehot, w_pos)

    if cfg.loss_variant == "module2":
        total = (masks_loss
                 + (conf_loss + category_loss) / cfg.loss_lambda[0]
                 + (loss_xy + loss_wh) / cfg.loss_lambda[1])
    else:   # module3 ships with regression and category excluded
        total = masks_loss + conf_loss / cfg.loss_lambda[0]

    flat_positive = positive.reshape(-1)
    metrics = {
        "masks_loss": masks_loss.detach(),
        "conf_loss": conf_loss.detach(),
        "category_loss": category_loss.detach(),
        "loss_xy": loss_xy.detach(),
        "loss_wh": loss_wh.detach(),
        "total": flat_pos.sum() + flat_neg.sum(),
        "true": flat_pos.sum(),
        "positive": flat_positive.sum(),
        "tp": (flat_positive & flat_pos).sum(),
    }
    return total, metrics


class RefineNetwork:
    """Camera-only refinement detector ("module2") over explicit
    parameters ``{"darknet", "fcn", "refine", "ensemble"}``. Differences
    from ``FusionNetwork``: no radar branch, all classes kept, the
    ensemble's second layer has a LeakyReLU, and channel 1 of its output
    is p(foreground)."""

    TP_LEAVES = frozenset({("fcn", "0", "w"), ("refine", "net0", "w"),
                           ("refine", "net1", "w"), ("refine", "net2", "w")})

    def __init__(self, darknet: Darknet, config: FusionConfig = None):
        self.darknet = darknet
        cfg = config or FusionConfig(class_num=12, loss_variant="module2",
                                     loss_lambda=(15.0, 5.0))
        # this IS the module2 network: its loss keeps the category and
        # regression terms whatever config a caller passes for one knob
        self.cfg = replace(cfg, loss_variant="module2")
        _check_config(self.cfg)

    def init(self, gen, device="cpu"):
        """(params, state) from an explicit ``torch.Generator``: the
        Darknet, the score-map stack ``fcn``, then the heads as
        ``init_heads`` draws them; on the CPU, moved to ``device``."""
        d_params, d_state = self.darknet.init(gen)
        fcn_p, fcn_s = heads.conv_bn_stack_init(gen, (256, 490))
        hp, hs = self.init_heads(gen)
        params = {"darknet": d_params, "fcn": fcn_p, **hp}
        state = {"darknet": d_state, "fcn": fcn_s, **hs}
        return to_device(params, device), to_device(state, device)

    def init_heads(self, gen):
        """(params, state) of the refinement and ensemble heads from an
        explicit ``torch.Generator``, for serving a checkpoint that has
        none: untrained heads, in the trained layout."""
        ref_p, ref_s = heads.refinement_head_init(
            gen, net2_out=self.cfg.class_num + 1, with_radar=False)
        ens_p = heads.ensemble_head_init(gen, self.cfg.class_num)
        return {"refine": ref_p, "ensemble": ens_p}, {"refine": ref_s}

    def apply(self, params, state, images, train=False, targets=None,
              tmask=None, draw=None):
        """images [B, S, S, 3] letterboxed float -> {"boxes" [B, K, 7] rows
        of (x1, y1, x2, y2, p(foreground), class_score, class_pred),
        "valid" [B, K]}, sorted by p(foreground); with ``train`` also
        "loss", "metrics" and the new "state" (``draw`` gives the dropout
        mask and the negatives' keys)."""
        cfg = self.cfg
        b_sz, img_size = images.shape[0], images.shape[1]
        k_img = cfg.max_det

        det, det_valid, feature_map = _frozen_forward(self, params, state,
                                                      images, train)
        img_xyxy = det[:, :, 0:4]

        hd = torch.float32 if train else _DTYPES[cfg.heads_dtype]
        p_fcn, s_fcn = _cast_floats((params["fcn"], state["fcn"]), hd)
        p_ref, s_ref = _cast_floats((params["refine"], state["refine"]), hd)
        p_ens = _cast_floats(params["ensemble"], hd)
        roi_score_map, fcn_s = heads.conv_bn_stack_apply(
            p_fcn, s_fcn, feature_map.to(hd), train,
            col_parallel=(0,) if pc.model_parallel(("fcn", "0", "w"))
            else ())

        smax = _eff_sampling_max(cfg, img_size)
        if cfg.roi_impl == "kernel" and not train:
            img_crop = ps_roi_align(roi_score_map, img_xyxy, (7, 7), 1.0 / 16,
                                    sampling_max=smax,
                                    precision=cfg.roi_precision)
        else:
            img_crop = ps_roi_align_batched(roi_score_map, img_xyxy, (7, 7),
                                            1.0 / 16, sampling_max=smax,
                                            compute_dtype=hd)
        img_crop = img_crop.to(hd).reshape(b_sz * k_img, 7, 7, -1)

        keep = None
        if train and draw is not None:
            # the global batch's mask; a rank keeps its rows
            keep = pc.data_slice(draw("dropout", (
                b_sz * pc.data_size() * k_img,
                p_ref["net0"]["w"].shape[1])).to(img_crop.device))
        regress_param, refinement_vector, refine_s = \
            heads.refinement_head_apply(p_ref, s_ref, None, img_crop,
                                        train=train, dropout_keep=keep,
                                        class_num=cfg.class_num,
                                        row_parallel=_row_parallel())
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
        result = _sorted_rows(torch.cat([out_xyxy, fg[..., None],
                                         det[:, :, 5:6], det[:, :, 6:7]], -1),
                              fg, positive)
        result["num_img"] = k_img
        if not train:
            return result
        new_state = {"darknet": state["darknet"], "fcn": fcn_s,
                     "refine": refine_s}
        loss, metrics = _losses(
            cfg, draw, targets, tmask, img_xyxy, det_valid, det[:, :, 6],
            regress_param, refinement_vector, fg, positive, k_img, img_size)
        result.update(loss=loss, metrics=metrics, state=new_state)
        return result
