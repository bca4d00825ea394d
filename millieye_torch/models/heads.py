"""Fusion-stage heads, inference only (port of
``millieye_tpu/models/heads.py``): score-map encoders, the module3
refinement head with radar-confidence fusion, the ensemble head.

Tensors are NHWC at the interfaces; convolution weights are OIHW and
linear weights [in, out], as the weight converter
(``io/checkpoint.py``) leaves them. Every op runs in the dtype of its
inputs, so a bf16 parameter tree gives bf16 heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from millieye_torch.models.darknet import leaky

_BN_EPS = 1e-5


def batch_norm(x, p, s):
    """Eval-mode BN over the last axis (eps in the statistics' dtype, as
    JAX rounds a weakly typed constant)."""
    eps = torch.full((), _BN_EPS, dtype=s["var"].dtype, device=x.device)
    return ((x - s["mean"]) * torch.rsqrt(s["var"] + eps) * p["gamma"]
            + p["beta"])


def _conv2d(x, w, padding):
    """NHWC x, OIHW w -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_bn_stack_apply(params, state, x):
    """1x1 conv + BN + leaky per stage (the 490-channel score map)."""
    for p, s in zip(params, state):
        x = leaky(batch_norm(_conv2d(x, p["w"], "same") + p["b"], p["bn"], s))
    return x


def radar_encoder_apply(params, state, x):
    """[B, H, W, 3] heatmap -> sigmoid score map [B, H, W, 10]."""
    for p, s in zip(params[:-1], state):
        x = leaky(batch_norm(_conv2d(x, p["w"], "same") + p["b"], p["bn"], s))
    return torch.sigmoid(_conv2d(x, params[-1]["w"], "same")
                         + params[-1]["b"])


def _flatten_chw(crop):
    """[N, 7, 7, C] -> [N, C*49] in torch's (C, H, W) order."""
    return crop.permute(0, 3, 1, 2).reshape(crop.shape[0], -1)


def refinement_head_apply(params, state, radar_crop, img_crop, class_num=1):
    """module3 forward: radar_crop, img_crop [N, 7, 7, 10] -> (regress
    [N, 4], refinement vector [N, 1+class_num])."""
    t = leaky(_flatten_chw(img_crop) @ params["net0"]["w"]
              + params["net0"]["b"])
    box_regression = t @ params["net1"]["w"] + params["net1"]["b"]
    class_vector = torch.sigmoid(t @ params["net2"]["w"] + params["net2"]["b"])
    rn = params["radar_net"]
    r = _conv2d(radar_crop, rn["conv7"]["w"], "valid") + rn["conv7"]["b"]
    r = leaky(batch_norm(r, rn["bn"], state["radar_net"]))
    r = _conv2d(r, rn["conv1"]["w"], "valid") + rn["conv1"]["b"]
    radar_conf = torch.sigmoid(r.reshape(r.shape[0], 1))
    confidence = torch.sigmoid(radar_conf + class_vector[:, :1])
    return box_regression, torch.cat(
        [confidence, class_vector[:, 1:1 + class_num]], -1)


def _softmax(x):
    """Softmax spelled as the JAX package spells it, so a bf16 input
    rounds after the exp, the sum and the division."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def ensemble_head_apply(params, refinement_vector, yolo_vector):
    """[N, c+1] x2 -> [N, 2] softmax: stack -> Linear(2->32) -> leaky ->
    flatten -> Linear."""
    x = torch.stack([refinement_vector, yolo_vector], -1)
    x = leaky(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = x.reshape(x.shape[0], -1) @ params["fc2"]["w"] + params["fc2"]["b"]
    return _softmax(x)
