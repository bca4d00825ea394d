"""Training CLI for all three stages (port of ``millieye_tpu/cli/train.py``):

  python -m millieye_torch.cli.train --stage yolo   --train_list paths.txt
  python -m millieye_torch.cli.train --stage refine --train_list paths.txt \\
      --pretrained yolo.weights
  python -m millieye_torch.cli.train --stage fusion --data_root our_dataset \\
      --pretrained_module2 module2.pth --test_list 0 --illumination H L \\
      [--fold_frozen] [--device cuda]

The steps run on ``--device`` (default the card); ``--device cpu`` runs
the kernels' plain versions. ``--fold_frozen`` (stage 3) builds the
Darknet as ``cli/_common.py:TRAIN_FOLD`` and folds its BN inside the
step, so the frozen forward runs the stem pair kernel K4 (and, at every
stage-2 and stage-3 step, the NMS kernel K1). ``--pretrained`` of stage 2
may also name a fusion ``.npz``: the Darknet and the score-map stack come
from it (``build_refine``), the heads from the seed-0 init.

``--data_parallel N --model_parallel M`` (N x M above 1) trains over a
("data", "model") mesh of N x M ranks: ``main`` launches a gloo world of
that many processes itself (``parallel/world.py``), each building the
same trainer with ``mesh=`` (``train/recipes.py``), so an in-process call
works as a one-process one does. Where the JAX package refuses a mesh
larger than its visible devices, the port places rank r on
``cuda:(r % device_count)``: ranks are processes, and the ranks of a
one-card machine share the card. The batch must divide by N, and
``--device_cache`` (one device's cache) is refused with a mesh. A rank
that fails ends the world with an error.

``main(argv, probe=None, timeout=None)`` returns the ``Trainer`` in one
process; under a mesh, a list with a dict for each rank: its ``rank``,
``data`` and ``model`` indices, the ``checkpoint`` path of the final
save (written by rank 0) and ``probe.report(trainer)`` as ``report``. ``probe`` (a
picklable object under a mesh) runs in each rank: ``probe.start(trainer)``
(where it has one) before the first step, ``probe(step_no, train_state,
metrics)`` after every step. ``timeout``: seconds the mesh's world may
run (``parallel/world.py:launch``; None, no limit).
"""
from __future__ import annotations

import argparse

import torch

from millieye_torch.cli._common import (TRAIN_FOLD, _fusion_npz,
                                        build_darknet, build_fusion,
                                        build_refine, load_weights_any)
from millieye_torch.data.datasets import (ExDarkDataset, ImageListDataset,
                                          RadarFusionDataset)
from millieye_torch.data.loader import DataLoader, PaddedCollate
from millieye_torch.device import resolve_device, set_numerics
from millieye_torch.io.checkpoint import to_device
from millieye_torch.parallel import make_mesh, world
from millieye_torch.train import recipes
from millieye_torch.train.steps import generator_draw


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stage", choices=("yolo", "refine", "fusion"),
                   required=True)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--img_size", type=int, default=416)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--grad_accum", type=int, default=2)
    p.add_argument("--model_def", default=None,
                   help="darknet .cfg (defaults to built-in tiny-yolov3-12)")
    p.add_argument("--pretrained", default=None,
                   help=".weights/.pt/.pth/.npz to initialize from")
    p.add_argument("--pretrained_module2", default=None,
                   help="stage 3: module2 checkpoint to load and freeze")
    p.add_argument("--checkpoint", default=None, help="resume .npz")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--train_list", default=None,
                   help="stage 1/2: image path list file")
    p.add_argument("--exdark_root", default=None,
                   help="stage 1/2: ExDark dataset root (alternative)")
    p.add_argument("--data_root", default=None,
                   help="stage 3: our_dataset root")
    p.add_argument("--test_list", type=int, default=0,
                   help="stage 3: held-out scene fold (0-4)")
    p.add_argument("--illumination", nargs="+", default=["H", "L"])
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N procedurally labeled synthetic scenes "
                        "instead of a dataset root (data.synthetic)")
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--fold_frozen", action="store_true",
                   help="stage 3: fold the frozen darknet's BN in the step "
                        "and run the stem pair kernel in the training "
                        "forward (exact for the eval-mode frozen base "
                        "detector)")
    p.add_argument("--device_cache", action="store_true",
                   help="put the whole padded dataset on the device once "
                        "and feed the step by an on-device gather "
                        "(data/device_cache.py); needs fixed shapes (no "
                        "--multiscale)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=0, metavar="N",
                   help="shard the batch over N ranks (gloo processes, "
                        "placed round-robin on the visible cards); "
                        "batch_size must be divisible by N")
    p.add_argument("--model_parallel", type=int, default=1, metavar="M",
                   help="additionally shard the wide 490/256-channel "
                        "layers over M ranks (N*M ranks in all)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def _world_size(args):
    """The mesh's rank count (1: no mesh), after the JAX package's
    refusals that still hold."""
    n = max(args.data_parallel, 1) * max(args.model_parallel, 1)
    if n == 1:
        return 1
    if args.batch_size % max(args.data_parallel, 1):
        raise SystemExit("batch_size must be divisible by --data_parallel")
    if args.device_cache:
        raise SystemExit("--device_cache caches on ONE device; drop it "
                         "when training over a mesh")
    return n


def _make_loader(dataset, args, device, max_targets=64, radar=False):
    kw = dict(max_targets=max_targets)
    if radar:
        kw.update(max_radar=32, max_points=256)
    if args.device_cache:
        if args.multiscale:
            raise SystemExit("--device_cache needs fixed shapes; "
                             "drop --multiscale")
        from millieye_torch.data.device_cache import DeviceCache
        cache = DeviceCache.build(dataset, PaddedCollate(args.img_size, **kw),
                                  device=device)
        return cache.loader(args.batch_size, shuffle=True, seed=args.seed)
    collate = PaddedCollate(args.img_size, multiscale=args.multiscale, **kw)
    return DataLoader(dataset, args.batch_size, collate, shuffle=True,
                      seed=args.seed)


def _fusion_stage(args, dev, mesh=None):
    model, params, state = build_fusion(
        None, TRAIN_FOLD if args.fold_frozen else "f32",
        img_size=args.img_size, device="cpu", model_def=args.model_def)
    if args.pretrained:
        params["darknet"], state["darknet"] = load_weights_any(
            model.darknet, params["darknet"], state["darknet"],
            args.pretrained)[:2]
    if args.pretrained_module2:
        from millieye_torch.io.torch_ckpt import (load_module2_pretrain,
                                                  read_state_dict)
        params, state, _ = load_module2_pretrain(
            params, state, read_state_dict(args.pretrained_module2))
    trainer = recipes.fusion_trainer(
        model, to_device(params, dev), to_device(state, dev),
        args.checkpoint_dir, lr=args.lr, every_k=args.grad_accum,
        fold_frozen=args.fold_frozen, mesh=mesh)
    if args.synthetic:
        from millieye_torch.data.synthetic import SyntheticScenes
        dataset = SyntheticScenes(args.synthetic, seed=args.seed,
                                  illumination=tuple(args.illumination))
    else:
        dataset = RadarFusionDataset(args.data_root, "train",
                                     tuple(args.illumination),
                                     args.test_list)
    return trainer, _make_loader(dataset, args, dev, radar=True)


def _image_stage(args, dev, mesh=None):
    if args.synthetic:
        from millieye_torch.data.synthetic import SyntheticScenes
        dataset = SyntheticScenes(args.synthetic, seed=args.seed,
                                  radar=False)
    elif args.exdark_root:
        dataset = ExDarkDataset(args.exdark_root, "train")
    else:
        dataset = ImageListDataset(args.train_list, augment=True)
    loader = _make_loader(dataset, args, dev)
    if args.stage == "yolo":
        darknet = build_darknet(args.model_def, img_size=args.img_size)
        params, state = darknet.init(torch.Generator().manual_seed(args.seed))
        if args.pretrained:
            params, state = load_weights_any(darknet, params, state,
                                             args.pretrained)[:2]
        trainer = recipes.yolo_trainer(
            darknet, to_device(params, dev), to_device(state, dev),
            args.checkpoint_dir, lr=args.lr, every_k=args.grad_accum,
            mesh=mesh)
        return trainer, loader
    fusion_file = bool(args.pretrained) and _fusion_npz(args.pretrained)
    model, params, state = build_refine(
        args.pretrained if fusion_file else None, img_size=args.img_size,
        device="cpu", model_def=args.model_def)
    if args.pretrained and not fusion_file:
        params["darknet"], state["darknet"] = load_weights_any(
            model.darknet, params["darknet"], state["darknet"],
            args.pretrained)[:2]
    trainer = recipes.refine_trainer(
        model, to_device(params, dev), to_device(state, dev),
        args.checkpoint_dir, lr=args.lr, every_k=args.grad_accum, mesh=mesh)
    return trainer, loader


def _train(args, dev, mesh=None, probe=None):
    set_numerics()
    if args.stage == "fusion":
        trainer, loader = _fusion_stage(args, dev, mesh)
    else:
        trainer, loader = _image_stage(args, dev, mesh)
    if args.checkpoint:
        trainer.resume(args.checkpoint)
    if hasattr(probe, "start"):
        probe.start(trainer)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    trainer.fit(loader, args.epochs, generator_draw(gen),
                lambda b: recipes.fusion_device_batch(b, args.img_size, dev),
                on_step=probe)
    path = trainer.save("final")
    if trainer.lead:
        print("done:", path)
    return trainer, path


def _rank_main(rank, dev, args, n, probe):
    mesh = make_mesh(n, model_axis=max(args.model_parallel, 1),
                     devices=[str(world.rank_device(r, args.device))
                              for r in range(n)])
    trainer, path = _train(args, dev, mesh, probe)
    return {"rank": rank, "data": mesh.index("data"),
            "model": mesh.index("model"), "checkpoint": path,
            "report": (probe.report(trainer)
                       if hasattr(probe, "report") else None)}


def main(argv=None, probe=None, timeout=None):
    args = parse_args(argv)
    n = _world_size(args)
    if n > 1:
        return world.launch(_rank_main, n, args.device, (args, n, probe),
                            timeout=timeout)
    trainer, _ = _train(args, resolve_device(args.device), probe=probe)
    return trainer


if __name__ == "__main__":
    main()
