"""Calibration for int8-activation serving (port of the calibration step
of ``millieye_tpu/cli/demo.py``). The demo CLI itself, which reads a
recording and streams it, comes with the port of the streaming runtime;
``calibrate`` takes frames that have already been read."""
from __future__ import annotations

import numpy as np
import torch

from millieye_torch.ops import letterbox as lb
from millieye_torch.ops.quantize import calibrate_act_scales


@torch.no_grad()
def calibrate(model, params, state, frames):
    """Per-conv input absmax for ``FusionEngine(act_absmax=...)`` over
    ``frames`` (uint8 [H, W, 3] arrays; the demo uses a recording's first
    eight), letterboxed exactly as the engine ingests them, on the float32
    BN-folded graph (``fold_s2d`` applied where the model has s2d stages),
    as one batch on the device of ``params``."""
    if len(frames) == 0:
        raise ValueError("int8_acts calibration needs at least one frame")
    dn = model.darknet
    dev = next(p["w"] for p in params["darknet"] if "w" in p).device
    images = torch.stack([
        lb.letterbox_image(torch.from_numpy(np.ascontiguousarray(f)).to(dev),
                           dn.img_size)[0] for f in frames])
    fp, fs = dn.fold_batchnorm(params["darknet"], state["darknet"])
    if dn.s2d_stages:
        fp = dn.fold_s2d(fp)
    return calibrate_act_scales(dn, fp, fs, [images])
