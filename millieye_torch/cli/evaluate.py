"""Evaluation CLI (port of ``millieye_tpu/cli/evaluate.py``): the three
reference eval scripts in one entry point.

  python -m millieye_torch.cli.evaluate --what yolo   --train_list t.txt ...
      (module2_mixed/test_mixed.py — raw Darknet + NMS mAP)
  python -m millieye_torch.cli.evaluate --what refine ...
      (module2_mixed/test_module2.py — YOLO + refinement mAP)
  python -m millieye_torch.cli.evaluate --what fusion --data_root root \\
      --model_mode 0 --illumination L --test_list 0 [--device cuda]
      (module3_our_dataset/test_fusion.py — per-mode/illumination fusion
      mAP with 5-fold scene cross-validation)

The forwards run on ``--device`` (default the card) with the preset's
kernels; ``--device cpu`` runs their plain versions. ``--weights`` takes
every format ``cli/_common.py`` reads: for ``--what yolo`` a Darknet's
(a darknet ``.weights`` file too, whose header is dropped), for
``refine`` a RefineNetwork's or a fusion ``.npz`` (its Darknet and
score-map stack, with seed-0 heads: ``build_refine``), for ``fusion``
what ``load_fusion`` reads.

``--what fusion --data_parallel N`` (N > 1) evaluates over a mesh of N
ranks (``parallel/``): ``main`` launches a gloo world of N processes
itself, each builds the model and the loader as one process does and
evaluates its slice of every batch (``harness.evaluate_fusion(mesh=)``).
Where the JAX package refuses N above its visible devices, the port
places rank r on ``cuda:(r % device_count)``: ranks are processes, and
on one card they share it. The batch must divide by N.

``main(argv, probe=None, timeout=None)`` returns the mAP, under a mesh
too (every rank computes the same; rank 0 prints the table);
``timeout``: seconds the mesh's world may run (None, no limit).
``probe``: in each rank (one process: this one), ``with
probe.around():`` wraps the evaluation and ``probe.report()`` is read
after it; under a mesh the parent's ``probe.reports`` gets the ranks'
reports in rank order.
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from millieye_torch.cli._common import (SERVING_PRESETS, build_darknet,
                                        build_fusion, build_refine,
                                        load_weights_any)
from millieye_torch.data.datasets import (ExDarkDataset, ImageListDataset,
                                          RadarFusionDataset)
from millieye_torch.data.loader import DataLoader, PaddedCollate
from millieye_torch.device import resolve_device, set_numerics
from millieye_torch.eval import harness
from millieye_torch.io.checkpoint import to_device
from millieye_torch.parallel import make_mesh, world
from millieye_torch.train.recipes import fusion_device_batch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--what", choices=("yolo", "refine", "fusion"),
                   required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--model_def", default=None)
    p.add_argument("--img_size", type=int, default=416)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--conf_thresh", type=float, default=0.5)
    p.add_argument("--nms_thresh", type=float, default=0.5)
    p.add_argument("--class_names", default=None)
    p.add_argument("--train_list", default=None)
    p.add_argument("--exdark_root", default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--test_list", type=int, default=0)
    p.add_argument("--illumination", nargs="+", default=["L"])
    p.add_argument("--model_mode", type=int, default=0,
                   help="0 millieye / 1 yolo / 2 radar / 3 auto")
    p.add_argument("--plot", default=None,
                   help="write the global PR curve to this path "
                        "(test_fusion.py plot/pr_*.jpg equivalent)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="evaluate on N synthetic scenes (seed 777) "
                        "instead of a dataset root")
    p.add_argument("--serving", default="f32",
                   choices=sorted(SERVING_PRESETS),
                   help="fusion only: serving preset to evaluate the "
                        "accuracy of (cli._common.SERVING_PRESETS; "
                        "int8_acts calibrates on the first eval batches)")
    p.add_argument("--device_cache", action="store_true",
                   help="stage the whole eval set on the device once "
                        "(data/device_cache.py) instead of per-batch "
                        "transfers")
    p.add_argument("--data_parallel", type=int, default=0, metavar="N",
                   help="fusion only: shard eval batches over N ranks "
                        "(gloo processes, placed round-robin on the "
                        "visible cards); batch_size must be divisible by N")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def _make_loader(dataset, args, radar=False):
    kw = dict(max_targets=64)
    if radar:
        kw.update(max_radar=32, max_points=256)
    if args.device_cache:
        # tail batches are padded to the fixed shape and trimmed by the
        # harness via batch["_n"]: no divisibility requirement
        from millieye_torch.data.device_cache import DeviceCache
        cache = DeviceCache.build(dataset, PaddedCollate(args.img_size, **kw),
                                  device=args.device)
        return cache.loader(args.batch_size)
    return DataLoader(dataset, args.batch_size,
                      PaddedCollate(args.img_size, **kw))


def _batches(loader, img_size, device):
    for b in loader:
        yield fusion_device_batch(b, img_size, device)


def _rank_main(rank, dev, args, probe):
    mesh = make_mesh(args.data_parallel, model_axis=1,
                     devices=[str(world.rank_device(r, args.device))
                              for r in range(args.data_parallel)])
    with probe.around() if probe else contextlib.nullcontext():
        m_ap = _evaluate(args, dev, mesh, quiet=rank != 0)
    return {"mAP": m_ap, "report": probe.report() if probe else None}


def main(argv=None, probe=None, timeout=None):
    args = parse_args(argv)
    if args.what == "fusion" and args.data_parallel > 1:
        if args.batch_size % args.data_parallel:
            raise SystemExit("batch_size must be divisible by "
                             "--data_parallel")
        out = world.launch(_rank_main, args.data_parallel, args.device,
                           (args, probe), timeout=timeout)
        if probe is not None:
            probe.reports = [r["report"] for r in out]
        return out[0]["mAP"]
    dev = resolve_device(args.device)
    with probe.around() if probe else contextlib.nullcontext():
        m_ap = _evaluate(args, dev)
    if probe is not None:
        probe.reports = [probe.report()]
    return m_ap


def _evaluate(args, dev, mesh=None, quiet=False):
    set_numerics()
    names = None
    if args.class_names:
        from millieye_torch.io.config import load_classes
        names = load_classes(args.class_names)

    if args.what == "fusion":
        model, params, state = build_fusion(
            args.weights, args.serving, img_size=args.img_size, device=dev,
            model_def=args.model_def, conf_thresh=args.conf_thresh,
            nms_thresh=args.nms_thresh)
        if args.synthetic:
            from millieye_torch.data.synthetic import SyntheticScenes
            dataset = SyntheticScenes(args.synthetic, seed=777,
                                      illumination=tuple(args.illumination))
        else:
            dataset = RadarFusionDataset(args.data_root, "test",
                                         tuple(args.illumination),
                                         args.test_list)
        loader = _make_loader(dataset, args, radar=True)
        if args.serving != "f32":
            from millieye_torch.runtime.engine import fold_for_serving
            act_absmax = None
            if model.cfg.acts_int8:
                act_absmax = _calibrate_on_eval_set(model, params, state,
                                                    loader, dev)
            params, state = fold_for_serving(model, params, state,
                                             act_absmax)
        result = harness.evaluate_fusion(
            model, params, state, _batches(loader, args.img_size, dev),
            mode=args.model_mode, iou_thresh=args.iou_thresh, mesh=mesh)
    else:
        if args.synthetic:
            from millieye_torch.data.synthetic import SyntheticScenes
            dataset = SyntheticScenes(args.synthetic, seed=777,
                                      illumination=tuple(args.illumination),
                                      radar=False)
        elif args.exdark_root:
            dataset = ExDarkDataset(args.exdark_root, "test")
        else:
            dataset = ImageListDataset(args.train_list)
        loader = _make_loader(dataset, args)
        if args.what == "yolo":
            darknet = build_darknet(args.model_def, img_size=args.img_size)
            params, state = darknet.init(torch.Generator().manual_seed(0))
            # a darknet file gives (params, state, header)
            params, state = load_weights_any(darknet, params, state,
                                             args.weights)[:2]
            result = harness.evaluate_yolo(
                darknet, to_device(params, dev), to_device(state, dev),
                _batches(loader, args.img_size, dev),
                conf_thresh=args.conf_thresh, nms_thresh=args.nms_thresh,
                iou_thresh=args.iou_thresh)
        else:
            model, params, state = build_refine(
                args.weights, img_size=args.img_size, device=dev,
                model_def=args.model_def, conf_thresh=args.conf_thresh,
                nms_thresh=args.nms_thresh)
            result = harness.evaluate_refine(
                model, params, state, _batches(loader, args.img_size, dev),
                iou_thresh=args.iou_thresh)

    table, m_ap = harness.summarize(result, names)
    if quiet:
        return m_ap
    print(table)
    if args.plot:
        out = harness.save_pr_curve(result, args.plot,
                                    title=f"{args.what} iou={args.iou_thresh}")
        if out:
            print("pr-curve:", out)
    return m_ap


@torch.no_grad()
def _calibrate_on_eval_set(model, params, state, loader, device,
                           n_batches=4):
    """Int8-activation calibration over the first eval batches (folded
    graph, same transforms as serving)."""
    from millieye_torch.ops.quantize import calibrate_act_scales

    fp, fs = model.darknet.fold_batchnorm(params["darknet"],
                                          state["darknet"])
    if model.darknet.s2d_stages:
        fp = model.darknet.fold_s2d(fp)
    images = []
    for i, b in enumerate(loader):
        img = b["images"]
        images.append(img.to(device) if isinstance(img, torch.Tensor)
                      else torch.from_numpy(img).to(device))
        if i + 1 >= n_batches:
            break
    return calibrate_act_scales(model.darknet, fp, fs, images)


if __name__ == "__main__":
    main()
