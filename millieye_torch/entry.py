"""The flagship forward as one callable (port of the JAX package's
``__graft_entry__.py:entry``).

``entry()`` returns ``(fn, example_args)``: ``fn(params, state, images,
radar_maps, radar_boxes, radar_mask) -> (boxes [1, 232, 7], valid
[1, 232])`` is the full fusion forward at batch 1 and 416 px (backbone ->
YOLO decode -> NMS -> score maps -> RoI crops -> refinement and ensemble
heads), float32, BN folded, NMS over the top 512 candidates through the
whole-matrix kernel K5 (``nms_use_blocked=False``), ``max_det`` 200 and 32
radar rows. Weights are arguments of ``fn``, as in the JAX package; they
come from the trained ``artifacts/stage3_final.npz`` (the JAX entry drew
random ones). The example inputs are that entry's: ``default_rng(0)``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from millieye_torch.cli._common import build_fusion
from millieye_torch.runtime.engine import fold_for_serving

CKPT = Path(__file__).resolve().parents[1] / "artifacts" / "stage3_final.npz"


def entry(device="cuda", img_size=416):
    """(fn, example_args) on ``device``, with the weights of the tracked
    stage-3 checkpoint."""
    s = img_size
    model, params, state = build_fusion(
        str(CKPT), "f32", img_size=s, device=device, max_det=200,
        max_radar=32, pre_nms_top_k=512, nms_use_blocked=False)
    params, state = fold_for_serving(model, params, state)

    @torch.no_grad()
    def fn(params, state, images, radar_maps, radar_boxes, radar_mask):
        out = model.apply(params, state, images, radar_maps, radar_boxes,
                          radar_mask, mode=0)
        return out["boxes"], out["valid"]

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(1, s, s, 3)).astype(np.float32)
    maps = rng.uniform(size=(1, s // 16, s // 16, 3)).astype(np.float32)
    rb = np.zeros((1, 32, 4), np.float32)
    rb[..., :2] = rng.uniform(0.1, 0.5, size=(1, 32, 2))
    rb[..., 2:] = rb[..., :2] + 0.2
    rmask = np.ones((1, 32), bool)
    dev = next(iter(params["ensemble"]["fc1"].values())).device
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (images, maps, rb, rmask))
    return fn, (params, state) + args
