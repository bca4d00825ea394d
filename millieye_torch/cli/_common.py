"""The port's serving presets and network constructors (port of
``millieye_tpu/cli/_common.py``: the 33 rows of ``SERVING_PRESETS``,
``serving_overrides``, ``build_fusion``, ``build_refine``)."""
from __future__ import annotations

import torch

from millieye_torch.device import resolve_device, set_numerics
from millieye_torch.io.checkpoint import convert, read_npz, to_device
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


def serving_overrides(name):
    """(hi_prec_stages, hi_prec_store, stem options for ``Darknet``,
    ``FusionConfig`` overrides). ``s2d: True`` means s2d stages (0, 2)."""
    preset = dict(SERVING_PRESETS[name])
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


def _build_darknet(preset, img_size, num_classes):
    hi, store, stem_kw, over = serving_overrides(preset)
    darknet = Darknet(tiny_yolov3_defs(num_classes=num_classes,
                                       img_size=img_size),
                      img_size=img_size, hi_prec_stages=hi,
                      hi_prec_store=_DTYPES[store] if store else None,
                      **stem_kw)
    return darknet, over


def build_fusion(weights, preset="f32", img_size=416, num_classes=12,
                 device="cuda", **overrides):
    """The fusion network at a serving preset, with its weights on
    ``device``. ``weights``: a JAX-package ``.npz`` checkpoint path or a
    JAX ``(params, state)`` pair of nested numpy arrays. Returns
    (model, params, state) with unfolded BN (``runtime.engine`` folds)."""
    dev = resolve_device(device)
    set_numerics()
    darknet, over = _build_darknet(preset, img_size, num_classes)
    model = FusionNetwork(darknet, FusionConfig(**{**over, **overrides}))
    params, state = convert(*(read_npz(weights) if isinstance(weights, str)
                              else weights))
    return model, to_device(params, dev), to_device(state, dev)


def build_refine(weights, preset="f32", img_size=416, num_classes=12,
                 device="cuda", **overrides):
    """The camera-only refinement network (module2, ``class_num`` 12) at
    a serving preset. ``weights``: a JAX ``(params, state)`` pair of
    nested numpy arrays for ``RefineNetwork``, or the path of a fusion
    ``.npz`` checkpoint: then the Darknet and the score-map stack (the
    fusion network's ``img_cnn``, the same 256 -> 490 layout) come from
    it, and the refinement and ensemble heads, which no such checkpoint
    holds, from ``RefineNetwork.init_heads`` with
    ``torch.Generator().manual_seed(0)``: untrained heads."""
    dev = resolve_device(device)
    set_numerics()
    darknet, over = _build_darknet(preset, img_size, num_classes)
    over.setdefault("class_num", 12)
    model = RefineNetwork(darknet, FusionConfig(**{**over, **overrides}))
    if isinstance(weights, str):
        fp, fs = convert(*read_npz(weights))
        hp, hs = model.init_heads(torch.Generator().manual_seed(0))
        params = {"darknet": fp["darknet"], "fcn": fp["img_cnn"], **hp}
        state = {"darknet": fs["darknet"], "fcn": fs["img_cnn"], **hs}
    else:
        params, state = convert(*weights)
    return model, to_device(params, dev), to_device(state, dev)
