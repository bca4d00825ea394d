"""Torch checkpoints of the reference ecosystem (port of
``millieye_tpu/io/torch_ckpt.py``):

* full-network ``.pth`` state dicts of the reference's training loops
  (``torch.save(model.state_dict())``), for the fusion network (module3)
  and the refinement network (module2);
* ultralytics ``.pt`` files, loaded by position into the Darknet;
* module2 -> module3 cross-loading: ``fcn_layers`` -> ``img_cnn`` and the
  refinement nets, marked frozen.

The fills take a state dict of tensors or numpy arrays and return new
(params, state) trees in the port's layout: float32 CPU tensors,
convolutions OIHW as the file has them, linear weights turned [out, in]
-> [in, out]. They place leaves into a template (an init or a loaded
tree) and leave the rest of it as it was.
"""
from __future__ import annotations

import numpy as np
import torch


def read_state_dict(path):
    """A torch file -> {key: CPU tensor}: a raw state dict, or an
    ultralytics-style container ``{"model": state dict or nn.Module}``.
    ``weights_only=False``: such a container pickles an ``nn.Module``, and
    torch 2.6 and later refuse it by default; load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if (isinstance(obj, dict) and "model" in obj
            and not isinstance(obj["model"], torch.Tensor)):
        obj = obj["model"]
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in obj.items()}


def _leaf(v):
    """A state-dict value -> a float32 CPU tensor (numpy arrays become
    tensors before the cast)."""
    t = v.detach().cpu() if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.array(v))
    return t.float().clone()


def _conv(sd, key):
    return _leaf(sd[key])          # OIHW, as the port keeps it


def _lin(sd, key):
    return _leaf(sd[key]).t().contiguous()      # [out, in] -> [in, out]


# --------------------------------------------------------------- darknet
def fill_darknet(model, params, state, sd, prefix=""):
    """Fill a Darknet's (params, state) from torch keys
    ``{prefix}module_list.{i}.conv_{i}.*`` / ``batch_norm_{i}.*``."""
    params = [dict(p) for p in params]
    state = [dict(s) for s in state]
    for i, info in enumerate(model._plan):
        if info["type"] != "convolutional":
            continue
        base = f"{prefix}module_list.{i}"
        params[i]["w"] = _conv(sd, f"{base}.conv_{i}.weight")
        if info["bn"]:
            bn = f"{base}.batch_norm_{i}"
            params[i]["gamma"] = _leaf(sd[f"{bn}.weight"])
            params[i]["beta"] = _leaf(sd[f"{bn}.bias"])
            state[i]["mean"] = _leaf(sd[f"{bn}.running_mean"])
            state[i]["var"] = _leaf(sd[f"{bn}.running_var"])
        else:
            params[i]["b"] = _leaf(sd[f"{base}.conv_{i}.bias"])
    return params, state


def load_ultralytics_pt(model, params, state, path):
    """Load by position: the file's tensors, in its state-dict order,
    against this Darknet's convolutions (conv weight, then conv bias, or
    BN weight, bias, running mean, running var and
    ``num_batches_tracked``, which is skipped); the key names are not
    read."""
    values = list(read_state_dict(path).values())
    params = [dict(p) for p in params]
    state = [dict(s) for s in state]
    ptr = 0

    def take():
        nonlocal ptr
        v = values[ptr]
        ptr += 1
        return v

    for i, info in enumerate(model._plan):
        if info["type"] != "convolutional":
            continue
        params[i]["w"] = _leaf(take())
        if info["bn"]:
            params[i]["gamma"] = _leaf(take())
            params[i]["beta"] = _leaf(take())
            state[i]["mean"] = _leaf(take())
            state[i]["var"] = _leaf(take())
            take()  # num_batches_tracked
        else:
            params[i]["b"] = _leaf(take())
    return params, state


# ------------------------------------------------------------- head fills
def _fill_conv_bn_stack(p, s, sd, prefix):
    """``cnn_layers_1`` / ``fcn_layers``: {prefix}.net.conv_{i} and
    batch_norm_{i}."""
    p = [dict(x) for x in p]
    s = [dict(x) for x in s]
    for i in range(len(p)):
        p[i]["w"] = _conv(sd, f"{prefix}.net.conv_{i}.weight")
        p[i]["b"] = _leaf(sd[f"{prefix}.net.conv_{i}.bias"])
        bn = f"{prefix}.net.batch_norm_{i}"
        p[i]["bn"] = {"gamma": _leaf(sd[f"{bn}.weight"]),
                      "beta": _leaf(sd[f"{bn}.bias"])}
        s[i] = {"mean": _leaf(sd[f"{bn}.running_mean"]),
                "var": _leaf(sd[f"{bn}.running_var"])}
    return p, s


def _fill_radar_encoder(p, s, sd, prefix="radar_cnn_layers"):
    """``cnn_layers_3``: conv1 and conv2 Sequential[Conv, BN, Leaky],
    conv3 Sequential[Conv, BN, Leaky, Conv]."""
    p = [dict(x) for x in p]
    s = [dict(x) for x in s]
    specs = [("conv1.0", "conv1.1"), ("conv2.0", "conv2.1"),
             ("conv3.0", "conv3.1")]
    for i, (ck, bk) in enumerate(specs):
        p[i]["w"] = _conv(sd, f"{prefix}.{ck}.weight")
        p[i]["b"] = _leaf(sd[f"{prefix}.{ck}.bias"])
        p[i]["bn"] = {"gamma": _leaf(sd[f"{prefix}.{bk}.weight"]),
                      "beta": _leaf(sd[f"{prefix}.{bk}.bias"])}
        s[i] = {"mean": _leaf(sd[f"{prefix}.{bk}.running_mean"]),
                "var": _leaf(sd[f"{prefix}.{bk}.running_var"])}
    p[3]["w"] = _conv(sd, f"{prefix}.conv3.3.weight")
    p[3]["b"] = _leaf(sd[f"{prefix}.conv3.3.bias"])
    return p, s


def _linear(sd, key):
    return {"w": _lin(sd, f"{key}.weight"), "b": _leaf(sd[f"{key}.bias"])}


def _fill_refinement(p, s, sd, prefix="refinement_head", with_radar=True):
    p = dict(p)
    s = dict(s)
    for net in ("net0", "net1", "net2"):
        p[net] = _linear(sd, f"{prefix}.{net}.0")
    if with_radar:
        rn = f"{prefix}.radar_net"
        p["radar_net"] = {
            "conv7": {"w": _conv(sd, f"{rn}.0.weight"),
                      "b": _leaf(sd[f"{rn}.0.bias"])},
            "bn": {"gamma": _leaf(sd[f"{rn}.1.weight"]),
                   "beta": _leaf(sd[f"{rn}.1.bias"])},
            "conv1": {"w": _conv(sd, f"{rn}.3.weight"),
                      "b": _leaf(sd[f"{rn}.3.bias"])},
        }
        s["radar_net"] = {"mean": _leaf(sd[f"{rn}.1.running_mean"]),
                          "var": _leaf(sd[f"{rn}.1.running_var"])}
    return p, s


def _fill_ensemble(p, sd, prefix="ensemble_head"):
    return {"fc1": _linear(sd, f"{prefix}.fc1.0"),
            "fc2": _linear(sd, f"{prefix}.fc2.0")}


# -------------------------------------------------------------- full models
def fill_fusion_network(model, params, state, sd):
    """A module3 ``Network`` state dict -> ``FusionNetwork`` trees."""
    params, state = dict(params), dict(state)
    params["darknet"], state["darknet"] = fill_darknet(
        model.darknet, params["darknet"], state["darknet"], sd,
        prefix="base_detector.")
    params["img_cnn"], state["img_cnn"] = _fill_conv_bn_stack(
        params["img_cnn"], state["img_cnn"], sd, "img_cnn_layers")
    params["radar_enc"], state["radar_enc"] = _fill_radar_encoder(
        params["radar_enc"], state["radar_enc"], sd)
    params["refine"], state["refine"] = _fill_refinement(
        params["refine"], state["refine"], sd, with_radar=True)
    params["ensemble"] = _fill_ensemble(params["ensemble"], sd)
    return params, state


def fill_refine_network(model, params, state, sd):
    """A module2 ``Network`` state dict -> ``RefineNetwork`` trees."""
    params, state = dict(params), dict(state)
    params["darknet"], state["darknet"] = fill_darknet(
        model.darknet, params["darknet"], state["darknet"], sd,
        prefix="base_detector.")
    params["fcn"], state["fcn"] = _fill_conv_bn_stack(
        params["fcn"], state["fcn"], sd, "fcn_layers")
    params["refine"], state["refine"] = _fill_refinement(
        params["refine"], state["refine"], sd, with_radar=False)
    params["ensemble"] = _fill_ensemble(params["ensemble"], sd)
    return params, state


def load_module2_pretrain(params, state, sd):
    """module2 -> module3 for training stage 3: module2's ``fcn_layers``
    into ``img_cnn`` and its refinement nets 0-2 into a FusionNetwork's
    trees. Returns (params, state, frozen), ``frozen`` marking the loaded
    subtrees for the optimizer's mask."""
    params, state = dict(params), dict(state)
    params["img_cnn"], state["img_cnn"] = _fill_conv_bn_stack(
        params["img_cnn"], state["img_cnn"], sd, "fcn_layers")
    refine = dict(params["refine"])
    for net in ("net0", "net1", "net2"):
        refine[net] = _linear(sd, f"refinement_head.{net}.0")
    params["refine"] = refine
    frozen = {"img_cnn": True, "refine_nets": True}
    return params, state, frozen
