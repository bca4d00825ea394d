"""Ahead-of-time serving-artifact export CLI (port of
``millieye_tpu/cli/export.py``).

  python -m millieye_torch.cli.export --out fusion_serving.pt2 \\
      --weights fusion.npz --serving pallas_max_s01 --batch 1 [--device cuda]

Builds the fusion model at the chosen serving preset, loads weights,
folds BN (and the space-to-depth stem where the preset has one), bakes
everything into one ``torch.export`` program with the port's kernels as
custom ops (``io/export.py``) and optionally round-trip-verifies it
against the live graph on random inputs. The deployment side needs only
torch, the op library and the blob
(``millieye_torch.io.export.load_serving``), on the device the artifact
was exported for.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from millieye_torch.cli._common import SERVING_PRESETS, build_fusion
from millieye_torch.device import resolve_device
from millieye_torch.models.fusion import _DTYPES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True, help="output blob path")
    p.add_argument("--weights", default=None,
                   help=".npz / .pt / .pth / darknet .weights; none: the "
                        "seed-0 init")
    p.add_argument("--serving", default="f32",
                   choices=sorted(SERVING_PRESETS))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--mode", type=int, default=0)
    p.add_argument("--img_size", type=int, default=416)
    p.add_argument("--device", default="cuda",
                   help="torch device the artifact runs on; 'cpu' "
                        "gives one that runs the kernels' plain versions")
    p.add_argument("--verify", action="store_true",
                   help="load the blob and compare it with the live "
                        "graph on random inputs before writing")
    return p.parse_args(argv)


def verify_inputs(model, batch, device, seed=0):
    """The ``--verify`` inputs: images, radar maps, radar boxes and mask
    from ``np.random.default_rng(seed)``, as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    s, r = model.darknet.img_size, model.cfg.max_radar
    imgs = rng.uniform(size=(batch, s, s, 3))
    maps = rng.uniform(size=(batch, s // 16, s // 16, 3))
    rb = np.zeros((batch, r, 4), np.float32)
    rb[..., :2] = rng.uniform(0.1, 0.5, size=(batch, r, 2))
    rb[..., 2:] = rb[..., :2] + 0.3
    return (torch.tensor(imgs, dtype=torch.float32, device=device),
            torch.tensor(maps, dtype=torch.float32, device=device),
            torch.tensor(rb, device=device),
            torch.ones((batch, r), dtype=torch.bool, device=device))


def main(argv=None):
    from millieye_torch.io.export import export_serving, load_serving

    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, params, state = build_fusion(args.weights, args.serving,
                                        img_size=args.img_size, device=dev)
    cd = _DTYPES[model.cfg.compute_dtype]
    fp, fs = model.darknet.fold_batchnorm(
        params["darknet"], state["darknet"],
        dtype=None if cd == torch.float32 else cd)
    if model.darknet.s2d_stages:
        fp = model.darknet.fold_s2d(fp)
    params = dict(params, darknet=fp)
    state = dict(state, darknet=fs)

    same = None
    t = time.perf_counter()
    blob = export_serving(model, params, state, batch_size=args.batch,
                          mode=args.mode, device=dev)
    export_s = time.perf_counter() - t

    if args.verify:
        ins = verify_inputs(model, args.batch, dev)
        with torch.no_grad():
            live = model.apply(params, state, *ins, mode=args.mode)
            art = load_serving(blob)(*ins)
        same = (torch.equal(art["boxes"], live["boxes"])
                and torch.equal(art["valid"], live["valid"]))
        gap = float((art["boxes"] - live["boxes"]).abs().max())
        # the JAX package's bounds (its artifact is compiled, the live
        # graph eager); the artifact here runs the live graph's kernels
        bf16 = model.cfg.compute_dtype != "float32"
        np.testing.assert_allclose(art["boxes"].cpu().numpy(),
                                   live["boxes"].cpu().numpy(),
                                   rtol=5e-2 if bf16 else 1e-5,
                                   atol=0.1 if bf16 else 1e-5)
        print("verify: artifact == live graph"
              + (" bit for bit" if same else f" (max box gap {gap:.3g})"))

    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob) / 1e6:.1f} MB, "
          f"serving={args.serving}, batch={args.batch}, "
          f"device={args.device}, export {export_s:.1f} s)")
    return {"bytes": len(blob), "export_s": export_s,
            "verify_bit_identical": same}


if __name__ == "__main__":
    main()
