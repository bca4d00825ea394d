"""Fusion-stage heads (port of ``millieye_tpu/models/heads.py``):
score-map encoders, the module3 refinement head with radar-confidence
fusion, module2's without the radar branch (with its dropout), the
ensemble head, train- and eval-mode BN, the losses (focal, BCE and
smooth-L1 sums over a sample mask), and the initialisers, which draw
from an explicit ``torch.Generator`` in the JAX package's layout (its
numbers come from JAX's PRNG and cannot be repeated).

Tensors are NHWC at the interfaces; convolution weights are OIHW and
linear weights [in, out], as the weight converter
(``io/checkpoint.py``) leaves them. Every op runs in the dtype of its
inputs, so a bf16 parameter tree gives bf16 heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from millieye_torch.ops.epilogue import leaky
from millieye_torch.parallel import collectives as pc

_BN_EPS = 1e-5
_HEAD_BN_MOMENTUM = 0.1  # torch's default, every head BN


def batch_norm(x, p, s, train=False, weight=None,
               momentum=_HEAD_BN_MOMENTUM):
    """BN over the last axis; returns (y, new state). In eval mode the
    running statistics normalize (eps in their dtype, as JAX rounds a
    weakly typed constant) and the state is returned unchanged. In train
    mode the batch statistics over all leading axes normalize, with the
    biased variance, and the running variance takes the unbiased one
    (torch's semantics); ``weight`` (broadcastable to x[..., 0]) masks
    padded rows out of the statistics, which are then weighted means over
    ``max(sum(weight), 1)`` rows. The new state carries no gradient.
    Hand-written, not ``nn.BatchNorm``: that update is unweighted.

    Under an active mesh the sums and counts of the statistics run over
    every "data" rank's rows (``parallel/collectives.py``): the batch
    statistics are the global batch's."""
    if not train:
        eps = torch.full((), _BN_EPS, dtype=s["var"].dtype, device=x.device)
        return ((x - s["mean"]) * torch.rsqrt(s["var"] + eps) * p["gamma"]
                + p["beta"]), s
    axes = tuple(range(x.dim() - 1))
    if weight is None:
        cnt = 1
        for d in x.shape[:-1]:
            cnt *= d
        if pc.data_size() == 1:
            mean = x.mean(axes)
            var = x.var(axes, unbiased=False)
        else:
            cnt *= pc.data_size()
            mean = pc.data_sum(x.sum(axes)) / cnt
            var = pc.data_sum(((x - mean) ** 2).sum(axes)) / cnt
        var_u = var * (cnt / max(cnt - 1, 1))
    else:
        wsum = torch.clamp(pc.data_count(weight.sum()), min=1.0)
        # trailing singletons up to x.dim(): a bare [..., None] would
        # right-align [N] against [N, 1, 1, C]
        wx = weight.reshape(weight.shape + (1,) * (x.dim() - weight.dim()))
        mean = pc.data_sum((x * wx).sum(axes)) / wsum
        var = pc.data_sum((((x - mean) ** 2) * wx).sum(axes)) / wsum
        var_u = var * (wsum / torch.clamp(wsum - 1.0, min=1.0))
    new_s = {"mean": (1 - momentum) * s["mean"] + momentum * mean.detach(),
             "var": (1 - momentum) * s["var"] + momentum * var_u.detach()}
    y = (x - mean) * torch.rsqrt(var + _BN_EPS) * p["gamma"] + p["beta"]
    return y, new_s


def _conv2d(x, w, padding):
    """NHWC x, OIHW w -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_bn_stack_apply(params, state, x, train=False, col_parallel=()):
    """1x1 conv + BN + leaky per stage (the 490-channel score map).
    Returns (x, new state). ``col_parallel``: the stages whose weights
    are this rank's "model" shard of the output channels; their outputs
    are all-gathered before the bias and BN (column parallelism)."""
    new_state = []
    for i, (p, s) in enumerate(zip(params, state)):
        y = _conv2d(x, p["w"], "same")
        if i in col_parallel:
            y = pc.model_gather(y, -1)
        x, ns = batch_norm(y + p["b"], p["bn"], s, train)
        x = leaky(x)
        new_state.append(ns)
    return x, new_state


def radar_encoder_apply(params, state, x, train=False):
    """[B, H, W, 3] heatmap -> (sigmoid score map [B, H, W, 10], new
    state)."""
    new_state = []
    for p, s in zip(params[:-1], state):
        x, ns = batch_norm(_conv2d(x, p["w"], "same") + p["b"], p["bn"], s,
                           train)
        x = leaky(x)
        new_state.append(ns)
    return torch.sigmoid(_conv2d(x, params[-1]["w"], "same")
                         + params[-1]["b"]), new_state


def _flatten_chw(crop):
    """[N, 7, 7, C] -> [N, C*49] in torch's (C, H, W) order."""
    return crop.permute(0, 3, 1, 2).reshape(crop.shape[0], -1)


def _linear_init(gen, fan_in, fan_out):
    """Kaiming-normal weights [in, out], as the JAX package initialises."""
    return (torch.randn((fan_in, fan_out), generator=gen)
            * (2.0 / fan_in) ** 0.5)


def _conv_init(gen, k, cin, cout):
    """Conv weights ~ N(0, 0.02), OIHW."""
    return 0.02 * torch.randn((cout, cin, k, k), generator=gen)


def _bn_init(gen, c):
    """(params, state) of a BN: gamma ~ 1 + N(0, 0.02), beta 0, running
    mean 0 and var 1."""
    return ({"gamma": 1.0 + 0.02 * torch.randn(c, generator=gen),
             "beta": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def conv_bn_stack_init(gen, channels):
    """1x1 conv + BN + leaky per stage, channels e.g. (256, 490): each
    stage's weights, then its gamma."""
    params, state = [], []
    for cin, cout in zip(channels[:-1], channels[1:]):
        w = _conv_init(gen, 1, cin, cout)
        bn_p, bn_s = _bn_init(gen, cout)
        params.append({"w": w, "b": torch.zeros(cout), "bn": bn_p})
        state.append(bn_s)
    return params, state


_RADAR_ENC_CHANNELS = (3, 32, 64, 128)


def radar_encoder_init(gen):
    """Three 3x3 conv + BN + leaky stages (3 -> 32 -> 64 -> 128), then a
    1x1 conv to 10 channels."""
    params, state = [], []
    chans = _RADAR_ENC_CHANNELS
    for cin, cout in zip(chans[:-1], chans[1:]):
        w = _conv_init(gen, 3, cin, cout)
        bn_p, bn_s = _bn_init(gen, cout)
        params.append({"w": w, "b": torch.zeros(cout), "bn": bn_p})
        state.append(bn_s)
    params.append({"w": _conv_init(gen, 1, chans[-1], 10),
                   "b": torch.zeros(10)})
    return params, state


def refinement_head_init(gen, in_dim=490, hidden=256, net2_out=13,
                         with_radar=True):
    """(params, state) from an explicit ``torch.Generator``: the layout of
    the JAX package's ``refinement_head_init`` (conv kernels OIHW), not
    its numbers. Zero biases, BN gamma ~ N(1, 0.02)."""
    params = {
        "net0": {"w": _linear_init(gen, in_dim, hidden),
                 "b": torch.zeros(hidden)},
        "net1": {"w": _linear_init(gen, hidden, 4), "b": torch.zeros(4)},
        "net2": {"w": _linear_init(gen, hidden, net2_out),
                 "b": torch.zeros(net2_out)},
    }
    state = {}
    if with_radar:
        conv7 = {"w": _conv_init(gen, 7, 10, 10), "b": torch.zeros(10)}
        bn_p, bn_s = _bn_init(gen, 10)
        params["radar_net"] = {
            "conv7": conv7, "bn": bn_p,
            "conv1": {"w": _conv_init(gen, 1, 10, 1), "b": torch.zeros(1)},
        }
        state["radar_net"] = bn_s
    return params, state


def ensemble_head_init(gen, class_num, hidden=32):
    return {
        "fc1": {"w": _linear_init(gen, 2, hidden), "b": torch.zeros(hidden)},
        "fc2": {"w": _linear_init(gen, hidden * (class_num + 1), 2),
                "b": torch.zeros(2)},
    }


def _linear(x, p, row_parallel):
    """x @ w + b; ``row_parallel``: ``w`` is this rank's "model" shard of
    the input rows, so the product runs on this rank's slice of ``x`` and
    the partial products are summed over "model"."""
    if row_parallel:
        return pc.model_sum(pc.model_split(x, -1) @ p["w"]) + p["b"]
    return x @ p["w"] + p["b"]


def refinement_head_apply(params, state, radar_crop, img_crop, valid=None,
                          train=False, dropout_keep=None, class_num=1,
                          row_parallel=()):
    """radar_crop, img_crop [N, 7, 7, 10] -> (regress [N, 4], refinement
    vector, new state). module3 (``radar_net`` in params): the vector is
    [N, 1+class_num], its confidence fused with the radar crop's, whose BN
    takes ``valid`` [N] as its rows' weights in train mode. module2 (no
    ``radar_net``; ``radar_crop`` is ignored): the whole sigmoid class
    vector [N, net2_out]; ``dropout_keep`` (a bool mask of the hidden
    layer's shape) applies its Dropout(0.5). ``row_parallel``: the names
    of ``net0``-``net2`` that run row-parallel (``_linear``)."""
    new_state = dict(state)
    rows = set(row_parallel)
    t = leaky(_linear(_flatten_chw(img_crop), params["net0"],
                      "net0" in rows))
    if dropout_keep is not None:
        t = torch.where(dropout_keep, t / 0.5, torch.zeros_like(t))
    box_regression = _linear(t, params["net1"], "net1" in rows)
    class_vector = torch.sigmoid(_linear(t, params["net2"], "net2" in rows))
    if "radar_net" not in params:
        return box_regression, class_vector, new_state
    rn = params["radar_net"]
    r = _conv2d(radar_crop, rn["conv7"]["w"], "valid") + rn["conv7"]["b"]
    r, new_state["radar_net"] = batch_norm(r, rn["bn"], state["radar_net"],
                                           train, weight=valid)
    r = leaky(r)
    r = _conv2d(r, rn["conv1"]["w"], "valid") + rn["conv1"]["b"]
    radar_conf = torch.sigmoid(r.reshape(r.shape[0], 1))
    confidence = torch.sigmoid(radar_conf + class_vector[:, :1])
    return box_regression, torch.cat(
        [confidence, class_vector[:, 1:1 + class_num]], -1), new_state


def _softmax(x):
    """Softmax spelled as the JAX package spells it, so a bf16 input
    rounds after the exp, the sum and the division."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def ensemble_head_apply(params, refinement_vector, yolo_vector,
                        fc2_leaky=False):
    """[N, c+1] x2 -> [N, 2] softmax: stack -> Linear(2->32) -> leaky ->
    flatten -> Linear (-> leaky in module2, ``fc2_leaky``)."""
    x = torch.stack([refinement_vector, yolo_vector], -1)
    x = leaky(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = x.reshape(x.shape[0], -1) @ params["fc2"]["w"] + params["fc2"]["b"]
    if fc2_leaky:
        x = leaky(x)
    return _softmax(x)


def _weighted_sum(per, weight):
    return torch.where(weight > 0, per * weight, torch.zeros_like(per)).sum()


def _select_rows(weight, value, neutral):
    """Unsampled rows replaced by a neutral constant BEFORE the
    differentiable ops: a NaN or inf outside the sample set (the encoded
    target of a padded zero-size RoI) must not reach the loss or, through
    0 * NaN, its gradient."""
    sel = weight > 0
    while sel.dim() < value.dim():
        sel = sel[..., None]
    return torch.where(sel, value, torch.full_like(value, neutral))


def focal_loss(inputs, labels, weight, alpha=0.75, gamma=2.0):
    """Binary focal loss, sum reduction: inputs [N, 2] softmaxed, labels
    [N, 2] one-hot, weight [N] the balanced sample set."""
    a = torch.where(labels[:, 1] == 1, torch.full_like(weight, alpha),
                    torch.full_like(weight, 1.0 - alpha))
    inputs = _select_rows(weight, inputs, 0.5)
    probs = torch.clamp((inputs * labels).sum(-1), 1e-12, 1.0)
    per = -a * (1.0 - probs) ** gamma * torch.log(probs)
    return _weighted_sum(per, weight)


def bce_sum(p, t, weight):
    p = _select_rows(weight, p, 0.5)
    t = _select_rows(weight, t, 0.5)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    per = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    if per.dim() > weight.dim():
        per = per.sum(-1)
    return _weighted_sum(per, weight)


def smooth_l1_sum(pred, target, weight):
    target = _select_rows(weight, target, 0.0)
    pred = _select_rows(weight, pred, 0.0)
    d = torch.abs(pred - target)
    per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
    return _weighted_sum(per, weight)
