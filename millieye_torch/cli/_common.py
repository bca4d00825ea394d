"""The port's serving presets, network constructors and weight loading
(port of ``millieye_tpu/cli/_common.py``: the 33 rows of
``SERVING_PRESETS``, ``serving_overrides``, ``build_darknet``,
``build_fusion``, ``build_refine``, ``load_weights_any``; and
``load_fusion``, the counterpart of ``cli/evaluate.py:_load_fusion``).

Weights load on the host into CPU trees; the constructors move the
result to the device once, with ``to_device``."""
from __future__ import annotations

import os

import numpy as np
import torch

from millieye_torch.device import resolve_device, set_numerics
from millieye_torch.io.checkpoint import (convert, load_checkpoint,
                                          to_device)
from millieye_torch.io.darknet_weights import (BACKBONE_FILES,
                                               load_darknet_weights)
from millieye_torch.io.torch_ckpt import (fill_darknet, fill_fusion_network,
                                          fill_refine_network,
                                          read_state_dict)
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.fusion import (_DTYPES, FusionConfig,
                                          FusionNetwork, RefineNetwork)
from millieye_torch.models.zoo import tiny_yolov3_defs

_LADDER = {"compute_dtype": "bfloat16", "hi_prec": (0, 2, 4),
           "hi_store": "float16"}
_HEADS = dict(_LADDER, heads_dtype="bfloat16")
# stages 0+2 as one pair kernel with bf16 products; the variant names the
# JAX package's Pallas kernel, mapped to the port's in
# ``models/darknet.py:PAIR_KERNELS``
_PAIR = dict(_HEADS, stem=(0, 2), stem_pair=True, stem_precision="default")
# + the RoI crops through kernels K2 and K3
_MAX = dict(_PAIR, stem_variant="phase", roi_impl="kernel",
            roi_precision="default")
_K128 = dict(_MAX, pre_nms_top_k=128, max_det=64)

# The serving ladder, each row the JAX package's row of the same name.
# ``f32``: the plain float32 network. ``bf16``: bf16 backbone.
# ``bf16_f32stem`` / ``bf16_f16stem``: stem stages 0/2/4 in float32
# arithmetic, stored float32 / float16. ``bf16_heads``: + bf16 score maps,
# RoI crops and heads. ``pallas_stem``: + stages 0 and 2 each through the
# single-stage kernel K9 in float32 products. ``pallas_stem2``: stages 0+2
# through the pair kernel K8 (the hi/lo pool select); ``pallas_phase``:
# through K4. ``pallas_max``: + the RoI kernels; ``pallas_max4``: + stage
# 4 through K9 in bf16 products; ``pallas_packed`` / ``pallas_s2d`` /
# ``pallas_s2d8``: the pair through K11 / K12; ``pallas_deep``: + stages 4
# and 6 through K9; ``pallas_pair2``: stages 4+6 as K12's deep pair;
# ``pallas_maxv``: K2 with ``reduce="vpu"``; ``_k256`` / ``_d64`` /
# ``_k128``: fewer NMS candidates and detections (NMS kernel K1 at 512,
# 256 or 128 candidates); the ``pallas_max_*`` rungs at 128 candidates
# name other pair variants: ``_pk`` K11, ``_s2d`` K12, ``_s01``, ``_vm``,
# ``_vm_s01`` and the ``_bf16s`` twins buffering-only spellings (bf16
# scratches, VMEM input) of the pair they name. ``pallas_lat``: top-256,
# K2 ``vpu`` and the blocked NMS kernel pinned. ``s2d`` / ``bf16_s2d``:
# stages 0 and 2 as space-to-depth convolutions (float32 / bf16);
# ``int8``: + int8 weights; ``int8_acts``: + int8 activations, which need
# an ``act_absmax`` calibration (``cli/demo.py:calibrate``) for
# ``FusionEngine``.
SERVING_PRESETS = {
    "f32": {},
    "bf16": {"compute_dtype": "bfloat16"},
    "bf16_f16stem": dict(_LADDER),
    "bf16_f32stem": {"compute_dtype": "bfloat16", "hi_prec": (0, 2, 4)},
    "bf16_heads": dict(_HEADS),
    "pallas_stem": dict(_HEADS, stem=(0, 2)),
    "pallas_stem2": dict(_PAIR),
    "pallas_phase": dict(_PAIR, stem_variant="phase"),
    "pallas_max": dict(_MAX),
    "pallas_max4": dict(_MAX, stem=(0, 2, 4)),
    "pallas_packed": dict(_MAX, stem_variant="packed"),
    "pallas_s2d": dict(_MAX, stem_variant="s2d"),
    "pallas_s2d8": dict(_MAX, stem_variant="s2d8"),
    "pallas_deep": dict(_MAX, stem=(0, 2, 4, 6), stem_variant="s2d"),
    "pallas_pair2": dict(_MAX, stem=(0, 2, 4, 6), stem_variant="s2d",
                         stem_pairs="all"),
    "pallas_maxv": dict(_MAX, roi_reduce="vpu"),
    "pallas_max_k256": dict(_MAX, pre_nms_top_k=256),
    "pallas_max_d64": dict(_MAX, pre_nms_top_k=256, max_det=64),
    "pallas_max_k128": dict(_K128),
    "pallas_max_pk": dict(_K128, stem_variant="packed"),
    "pallas_max_s2d": dict(_K128, stem_variant="s2d"),
    "pallas_max_bf16s": dict(_K128, stem_variant="phase_bf16s"),
    "pallas_max_pk_bf16s": dict(_K128, stem_variant="packed_bf16s"),
    "pallas_max_s2d_bf16s": dict(_K128, stem_variant="s2d_bf16s"),
    "pallas_max_s01": dict(_K128, stem_variant="phase_s01"),
    "pallas_max_vm": dict(_K128, stem_variant="phase_vmem"),
    "pallas_max_vm_s01": dict(_K128, stem_variant="phase_vmem_s01"),
    "pallas_max_vm_bf16s": dict(_K128, stem_variant="phase_vmem_bf16s"),
    "pallas_lat": dict(_MAX, roi_reduce="vpu", pre_nms_top_k=256,
                       max_det=64, nms_use_blocked=True),
    "s2d": {"s2d": True},
    "bf16_s2d": {"compute_dtype": "bfloat16", "s2d": True},
    "int8": {"s2d": True, "weights_int8": True},
    "int8_acts": {"s2d": True, "weights_int8": True, "acts_int8": True},
}


# ``cli/train.py --fold_frozen``: the JAX package's train-step
# configuration for a folded frozen Darknet (its cli/train.py): bf16
# convolutions, stages 0/2/4 in float32 arithmetic and stored float32,
# stages 0+2 as the pair kernel K4 ("phase_s01") with bf16 products. The
# heads train in float32 whatever the preset.
TRAIN_FOLD = {"compute_dtype": "bfloat16", "hi_prec": (0, 2, 4),
              "stem": (0, 2), "stem_pair": True, "stem_precision": "default",
              "stem_variant": "phase_s01"}


def serving_overrides(name):
    """(hi_prec_stages, hi_prec_store, stem options for ``Darknet``,
    ``FusionConfig`` overrides) of a preset: a name of
    ``SERVING_PRESETS`` or such a row itself (``TRAIN_FOLD``). ``s2d:
    True`` means s2d stages (0, 2)."""
    preset = dict(SERVING_PRESETS[name] if isinstance(name, str) else name)
    hi = tuple(preset.pop("hi_prec", ()))
    store = preset.pop("hi_store", None)
    stem_kw = {
        "s2d_stages": (0, 2) if preset.pop("s2d", False) else (),
        "stem_stages": tuple(preset.pop("stem", ())),
        "stem_pair": bool(preset.pop("stem_pair", False)),
        "stem_precision": preset.pop("stem_precision", "highest"),
        "stem_pair_variant": preset.pop("stem_variant", "select"),
        "stem_pairs": preset.pop("stem_pairs", "first"),
    }
    return hi, store, stem_kw, preset


def build_darknet(model_cfg=None, num_classes=12, img_size=416,
                  **darknet_kw):
    """A Darknet from a darknet ``.cfg`` path (the path that keeps
    ``.weights`` files loadable) or the zoo's tiny-YOLOv3."""
    defs = model_cfg or tiny_yolov3_defs(num_classes=num_classes,
                                         img_size=img_size)
    return Darknet(defs, img_size=img_size, **darknet_kw)


def _build_darknet(preset, img_size, num_classes, model_def):
    hi, store, stem_kw, over = serving_overrides(preset)
    darknet = build_darknet(model_def, num_classes, img_size,
                            hi_prec_stages=hi,
                            hi_prec_store=_DTYPES[store] if store else None,
                            **stem_kw)
    return darknet, over


def _darknet_file(path):
    """A darknet ``.weights`` file, or a backbone file named exactly by
    its convention (``darknet53.conv.74``, ``yolov3-tiny.conv.15``): the
    extension decides, and a file's directories never do."""
    return os.path.splitext(path)[1] == ".weights" or \
        os.path.basename(path) in BACKBONE_FILES


def load_weights_any(model, params, state, path):
    """Fill (params, state) from a weight file, by its extension: a
    darknet ``.weights`` or a backbone file under its conventional name
    (a ``Darknet`` only; returns (params, state, header)), a torch
    ``.pt``/``.pth`` (a module3 state dict for a ``FusionNetwork``,
    module2's for a ``RefineNetwork``, keyed Darknet weights for a
    ``Darknet``), or the JAX package's ``.npz``
    (``load_checkpoint`` into this template). Runs on the host: loaded
    leaves are CPU tensors."""
    ext = os.path.splitext(path)[1]
    if _darknet_file(path):
        return load_darknet_weights(model, params, state, path)
    if ext in (".pt", ".pth"):
        sd = read_state_dict(path)
        if isinstance(model, FusionNetwork):
            return fill_fusion_network(model, params, state, sd)
        if isinstance(model, RefineNetwork):
            return fill_refine_network(model, params, state, sd)
        return fill_darknet(model, params, state, sd)
    if ext == ".npz":
        restored = load_checkpoint(path, {"params": params, "state": state})
        return restored["params"], restored["state"]
    raise ValueError(f"unknown weight format: {path}")


def load_fusion(model, params, state, path):
    """A ``FusionNetwork``'s or ``RefineNetwork``'s (params, state) from
    any weight file: a darknet file replaces (the blocks it holds of) the
    Darknet only and keeps the rest of the template; the other formats go
    through ``load_weights_any``."""
    if not _darknet_file(path):
        return load_weights_any(model, params, state, path)
    params, state = dict(params), dict(state)
    params["darknet"], state["darknet"], _ = load_darknet_weights(
        model.darknet, params["darknet"], state["darknet"], path)
    return params, state


def _init_or_load(model, weights):
    """The CPU (params, state) of ``model`` for ``weights``: a JAX
    ``(params, state)`` pair of nested numpy arrays through ``convert``;
    else the init from ``torch.Generator().manual_seed(0)`` (the JAX
    package's ``PRNGKey(0)``), filled from the file ``weights`` names."""
    if isinstance(weights, (tuple, list)):
        return convert(*weights)
    params, state = model.init(torch.Generator().manual_seed(0))
    if weights is None:
        return params, state
    return load_fusion(model, params, state, weights)


def build_fusion(weights=None, preset="f32", img_size=416, num_classes=12,
                 device="cuda", model_def=None, **overrides):
    """The fusion network at a serving preset, with its weights on
    ``device``. ``weights``: None (the seed-0 init), a weight file of any
    format ``load_fusion`` reads, or a JAX ``(params, state)`` pair of
    nested numpy arrays. ``model_def``: a darknet ``.cfg`` path for the
    backbone (default: the zoo's tiny-YOLOv3). Returns (model, params,
    state) with unfolded BN (``runtime.engine`` folds)."""
    dev = resolve_device(device)
    set_numerics()
    darknet, over = _build_darknet(preset, img_size, num_classes, model_def)
    model = FusionNetwork(darknet, FusionConfig(**{**over, **overrides}))
    params, state = _init_or_load(model, weights)
    return model, to_device(params, dev), to_device(state, dev)


def _fusion_npz(path):
    """Whether ``path`` is a ``.npz`` holding a FusionNetwork's tree."""
    if os.path.splitext(path)[1] != ".npz":
        return False
    with np.load(path, allow_pickle=False) as z:
        return any(k.split("|", 1)[1].startswith("params/img_cnn/")
                   for k in z.files)


def build_refine(weights=None, preset="f32", img_size=416, num_classes=12,
                 device="cuda", model_def=None, **overrides):
    """The camera-only refinement network (module2, ``class_num`` 12) at
    a serving preset. ``weights`` as for ``build_fusion`` (a module2
    ``.pth``, a RefineNetwork ``.npz``, ...), or the path of a fusion
    ``.npz`` checkpoint: then the Darknet and the score-map stack (the
    fusion network's ``img_cnn``, the same 256 -> 490 layout) come from
    it (read through ``load_weights_any`` into a ``FusionNetwork``'s
    seed-0 init), and the refinement and ensemble heads, which no such
    checkpoint holds, from ``RefineNetwork.init_heads`` with
    ``torch.Generator().manual_seed(0)``: untrained heads."""
    dev = resolve_device(device)
    set_numerics()
    darknet, over = _build_darknet(preset, img_size, num_classes, model_def)
    over.setdefault("class_num", 12)
    over.setdefault("loss_variant", "module2")
    over.setdefault("loss_lambda", (15.0, 5.0))
    model = RefineNetwork(darknet, FusionConfig(**{**over, **overrides}))
    if isinstance(weights, str) and _fusion_npz(weights):
        fusion = FusionNetwork(darknet, model.cfg)
        fp, fs = _init_or_load(fusion, weights)
        hp, hs = model.init_heads(torch.Generator().manual_seed(0))
        params = {"darknet": fp["darknet"], "fcn": fp["img_cnn"], **hp}
        state = {"darknet": fs["darknet"], "fcn": fs["img_cnn"], **hs}
    else:
        params, state = _init_or_load(model, weights)
    return model, to_device(params, dev), to_device(state, dev)
