"""Streaming demo CLI (port of ``millieye_tpu/cli/demo.py``).

  python -m millieye_torch.cli.demo --recording data/20200729-213410 \\
      --calib yaml/calib_FOV90.yaml --weights fusion.npz [--device cuda]

Replays a recorded session (video or frames + timestamps + pointcloud)
through the host radar tracker and the engine's step on the card,
printing per-stage FPS; ``--save_dir`` writes annotated frames (PIL).
``--weights`` takes the JAX package's ``.npz`` checkpoints. The other
weight formats (``.pt``, ``.pth``, darknet ``.weights``) and a random
initialisation without ``--weights`` are not ported yet, and ask for
them raises.

``calibrate`` computes the int8-activation scales the ``int8_acts``
preset needs, on frames already read (the demo reads a recording's first
eight).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from millieye_torch.cli._common import SERVING_PRESETS, build_fusion
from millieye_torch.collection.prepare import iter_frames
from millieye_torch.ops import letterbox as lb
from millieye_torch.ops.quantize import calibrate_act_scales
from millieye_torch.radar.pipeline import RadarParams
from millieye_torch.radar.projection import load_calib
from millieye_torch.radar.viz import draw_detections
from millieye_torch.runtime.engine import FusionEngine
from millieye_torch.runtime.stream import StreamingPipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--recording", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--weights", default=None,
                   help="a .npz checkpoint of the JAX package")
    p.add_argument("--mode", type=int, default=0)
    p.add_argument("--img_size", type=int, default=416)
    p.add_argument("--frame_w", type=int, default=640)
    p.add_argument("--frame_h", type=int, default=480)
    p.add_argument("--refine_threshold_radar", type=float, default=0.56,
                   help="the reference demo's setting")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--save_dir", default=None,
                   help="write annotated frames here")
    p.add_argument("--serving", default="f32",
                   choices=sorted(SERVING_PRESETS),
                   help="serving preset: compute dtype / space-to-depth "
                        "stem / int8 weights / int8 activations "
                        "(int8_acts calibrates on the recording's first "
                        "frames)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def _weights_path(path):
    """The checkpoint the port can read, or a clear error."""
    if path is None:
        raise NotImplementedError(
            "millieye_torch.cli.demo needs --weights: the port has no "
            "random initialisation (the JAX package's FusionNetwork.init) "
            "yet; pass a .npz checkpoint such as "
            "artifacts/stage3_final.npz")
    if os.path.splitext(path)[1] != ".npz":
        raise NotImplementedError(
            f"millieye_torch.cli.demo: cannot read {path!r} yet; the port "
            f"reads the JAX package's .npz checkpoints (the .pt, .pth and "
            f"darknet .weights readers are not ported)")
    return path


def main(argv=None):
    args = parse_args(argv)
    model, params, state = build_fusion(
        _weights_path(args.weights), args.serving, img_size=args.img_size,
        device=args.device,
        refine_threshold_radar=args.refine_threshold_radar)
    act_absmax = None
    if model.cfg.acts_int8:
        act_absmax = _calibrate(model, params, state, args)
    engine = FusionEngine(model, params, state,
                          frame_size=(args.frame_w, args.frame_h),
                          act_absmax=act_absmax, device=args.device)
    calib = load_calib(args.calib)
    pipe = StreamingPipeline(engine, args.recording, calib,
                             RadarParams(frame_size=(args.frame_w,
                                                     args.frame_h)),
                             mode=args.mode)

    on_result = None
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        on_result = _make_saver(args)

    n, report = pipe.run(on_result=on_result, max_frames=args.max_frames)
    print(f"frames: {n}  report: {report}")
    return dict(report, frames=n)


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


def _calibrate(model, params, state, args, n_frames=8):
    """Int8-activation calibration over the recording's first frames."""
    frames = []
    for _, frame in iter_frames(args.recording):
        frames.append(frame)
        if len(frames) >= n_frames:
            break
    if not frames:
        raise ValueError("int8_acts calibration needs at least one frame "
                         f"in {args.recording}")
    return calibrate(model, params, state, frames)


def _make_saver(args):
    from PIL import Image
    frames = {i: f for i, f in iter_frames(args.recording)}

    def save(idx, boxes, valid):
        frame = frames.get(idx)
        if frame is None:
            return
        out = draw_detections(frame, boxes, valid)
        Image.fromarray(out).save(
            os.path.join(args.save_dir, f"{idx:06d}.jpg"))

    return save


if __name__ == "__main__":
    main()
