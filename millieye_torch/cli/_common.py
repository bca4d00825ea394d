"""The port's serving presets and network builder (port of the ``f32``
and ``pallas_max_s01`` rows of ``millieye_tpu/cli/_common.py``)."""
from __future__ import annotations

from millieye_torch.device import resolve_device, set_numerics
from millieye_torch.io.checkpoint import convert, read_npz, to_device
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.fusion import _DTYPES, FusionConfig, FusionNetwork
from millieye_torch.models.zoo import tiny_yolov3_defs

# ``pallas_max_s01``: bf16 backbone with stem stages 0/2/4 in float32
# arithmetic and float16 storage, stages 0+2 fused into kernel K4, bf16
# heads, NMS over the top 128 candidates (kernel K1), max_det 64, RoI
# crops through kernels K2 and K3. ``f32``: the plain float32 network.
SERVING_PRESETS = {
    "f32": {},
    "pallas_max_s01": {"compute_dtype": "bfloat16", "hi_prec": (0, 2, 4),
                       "hi_store": "float16", "heads_dtype": "bfloat16",
                       "stem_pair": 0, "roi_impl": "kernel",
                       "pre_nms_top_k": 128, "max_det": 64},
}


def serving_overrides(name):
    """(hi_prec_stages, hi_prec_store, stem_pair, FusionConfig overrides)."""
    preset = dict(SERVING_PRESETS[name])
    hi = tuple(preset.pop("hi_prec", ()))
    store = preset.pop("hi_store", None)
    stem_pair = preset.pop("stem_pair", None)
    return hi, store, stem_pair, preset


def build_fusion(weights, preset="f32", img_size=416, num_classes=12,
                 device="cuda", **overrides):
    """The fusion network at a serving preset, with its weights on
    ``device``. ``weights``: a JAX-package ``.npz`` checkpoint path or a
    JAX ``(params, state)`` pair of nested numpy arrays. Returns
    (model, params, state) with unfolded BN (``runtime.engine`` folds)."""
    dev = resolve_device(device)
    set_numerics()
    hi, store, stem_pair, over = serving_overrides(preset)
    darknet = Darknet(tiny_yolov3_defs(num_classes=num_classes,
                                       img_size=img_size),
                      img_size=img_size, hi_prec_stages=hi,
                      hi_prec_store=_DTYPES[store] if store else None,
                      stem_pair=stem_pair)
    model = FusionNetwork(darknet, FusionConfig(**{**over, **overrides}))
    params, state = convert(*(read_npz(weights) if isinstance(weights, str)
                              else weights))
    return model, to_device(params, dev), to_device(state, dev)
