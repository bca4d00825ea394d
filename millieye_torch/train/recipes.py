"""Epoch-level training recipes for the three stages (port of
``millieye_tpu/train/recipes.py``):

* stage 1  YOLO on image datasets (``yolo_trainer``);
* stage 2  frozen YOLO + refinement heads (``refine_trainer``);
* stage 3  frozen image branch + radar and ensemble heads on the
           radar/camera dataset (``fusion_trainer``).

``Trainer`` runs a step function over a loader for some epochs, logs
scalars every ``log_every`` steps (the only point where it waits for the
card), saves ``{name}_ckpt_{epoch}.npz`` after each epoch in the JAX
package's format (``io/checkpoint.py``) and resumes from such a file,
the JAX package's too. Radar heatmaps are rasterized on the device from
the padded point clouds, image by image (``fusion_device_batch``; the
JAX package ``vmap``s one image's function).

``Trainer(mesh=)`` (and ``mesh=`` of the three recipes) trains over a
mesh of ranks (``parallel/``): each rank of the world builds the same
trainer, which shards its train state (``parallel.shard_train_state``),
runs the step under ``parallel.sharded_step`` and gives it the rank's
slice of every batch (``parallel.shard_batch``). Rank 0 alone logs,
writes images and saves; ``save`` gathers the sharded leaves first (a
collective: every rank calls it), so the ``.npz`` has the one-process
file's keys and shapes; ``resume`` loads the whole file, then shards.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from millieye_torch import parallel
from millieye_torch.device import resolve_device
from millieye_torch.io.checkpoint import (load_checkpoint, save_checkpoint,
                                          to_device)
from millieye_torch.ops import letterbox as lb
from millieye_torch.ops.rasterize import radar_heatmap
from millieye_torch.parallel.mesh import gather_params, shard_params
from millieye_torch.runtime.profiler import trace_annotation
from millieye_torch.train.logging import MetricsLogger
from millieye_torch.train.optim import (STAGE2_FROZEN, STAGE3_FROZEN,
                                        frozen_adam, tree_leaves, tree_map)
from millieye_torch.train.steps import (init_train_state,
                                        make_fusion_train_step,
                                        make_refine_train_step,
                                        make_yolo_train_step)


def _map_ingest(points, pmask, frame_size, img_size):
    """points [B, P, 4], pmask [B, P] -> radar maps [B, S/16, S/16, 3]:
    each image's heatmap padded to a square and resized (bilinear,
    align_corners) to ``img_size // 16``."""
    maps = []
    for p, m in zip(points, pmask):
        heat = radar_heatmap(p, m, frame_size)
        heat, _ = lb.pad_to_square(heat, 0.0)
        maps.append(lb.resize_bilinear_align_corners(heat, img_size // 16))
    return torch.stack(maps)


_HOST_BATCH_KEYS = ("paths", "frame_size", "radar_points", "pmask",
                    "_n", "brightness", "host")
_HOST_COPY_KEYS = ("targets", "tmask")


def _to(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def fusion_device_batch(batch, img_size, device="cuda"):
    """Collated host batch (numpy, or a ``DeviceCache`` batch already on
    the device) -> a batch of tensors on ``device`` with rasterized radar
    maps. Host-side metadata (``_n``, ``brightness``)
    pass through unconverted, and ``batch["host"]`` keeps a numpy copy
    of ``targets`` and ``tmask``, so an evaluation never fetches them
    from the device."""
    with trace_annotation("millieye.ingest"):
        dev = resolve_device(device)
        out = {k: _to(v, dev) for k, v in batch.items()
               if k not in _HOST_BATCH_KEYS}
        for k in ("_n", "brightness"):
            if k in batch:
                out[k] = batch[k]
        out["host"] = batch.get("host") or {
            k: np.asarray(batch[k]) for k in _HOST_COPY_KEYS if k in batch}
        if "radar_points" in batch:
            w, h = batch.get("frame_size", (640, 480))
            out["radar_maps"] = _map_ingest(_to(batch["radar_points"], dev),
                                            _to(batch["pmask"], dev),
                                            (int(w), int(h)), img_size)
        return out


class Trainer:
    """The epoch loop: a step function, a loader, logging, checkpoints.
    The step returns a new train state (``self.ts``); seed a later stage
    from the state ``fit`` returns."""

    def __init__(self, step_fn, train_state, ckpt_dir, logdir=None,
                 log_every=10, name="stage", viz_fn=None, viz_every=50,
                 mesh=None):
        self.mesh = mesh
        self.step = step_fn
        if mesh is not None:
            train_state = parallel.shard_train_state(mesh, train_state)
            self.step = parallel.sharded_step(step_fn, mesh)
        self.lead = mesh is None or mesh.rank == 0
        self.ts = train_state
        self.ckpt_dir = ckpt_dir
        self.logger = (MetricsLogger(logdir or os.path.join(ckpt_dir, "logs"))
                       if self.lead else None)
        self.log_every = log_every
        self.name = name
        # image summaries: viz_fn(train_state, device_batch) -> {tag:
        # [N, H, W, C] float}
        self.viz_fn = viz_fn
        self.viz_every = viz_every
        if self.lead:
            os.makedirs(ckpt_dir, exist_ok=True)

    def full_params(self):
        """The parameters with every sharded leaf gathered (a collective
        under a mesh: every rank calls it)."""
        if self.mesh is None:
            return self.ts.params
        with torch.no_grad(), self.mesh.active():
            return gather_params(self.mesh, self.ts.params)

    def fit(self, loader, epochs, draw, batch_fn, on_epoch_end=None,
            on_step=None):
        """``draw(kind, shape)``: the steps' random numbers
        (``steps.generator_draw``; under a mesh every rank's draws the
        global batch's numbers, the same on every rank).
        ``on_step(step_no, train_state, metrics)`` runs after each
        step."""
        step_no = int(self.ts.step)
        for epoch in range(epochs):
            for batch in loader:
                device_batch = batch_fn(batch)
                if self.mesh is not None:
                    device_batch = parallel.shard_batch(self.mesh,
                                                        device_batch)
                self.ts, metrics = self.step(self.ts, device_batch, draw)
                step_no += 1
                if on_step:
                    on_step(step_no, self.ts, metrics)
                if self.lead and step_no % self.log_every == 0:
                    self.logger.scalars(
                        step_no, {k: v for k, v in metrics.items()
                                  if getattr(v, "dim", lambda: 0)() == 0})
                    # read at log points only: one wait for the card
                    nrev = int(metrics.get("nonfinite_reverted", 0))
                    if nrev:
                        print(f"WARNING [{self.name}] step {step_no}: "
                              f"{nrev} non-finite param/BN elements "
                              "reverted (NaN/inf batch): the loss may be "
                              "poisoned; consider grad_clip",
                              file=sys.stderr, flush=True)
                if self.viz_fn and step_no % self.viz_every == 0:
                    ts = self.ts._replace(params=self.full_params())
                    if self.lead:   # rank 0's slice of the batch
                        for tag, imgs in self.viz_fn(ts,
                                                     device_batch).items():
                            self.logger.image_grid(step_no, tag, imgs)
            self.save(epoch)
            if on_epoch_end:
                on_epoch_end(epoch, self.ts)
        return self.ts

    def save(self, epoch):
        """Write ``{name}_ckpt_{epoch}.npz`` (rank 0, the sharded leaves
        gathered); returns its path."""
        path = os.path.join(self.ckpt_dir, f"{self.name}_ckpt_{epoch}.npz")
        params = self.full_params()
        if self.lead:
            save_checkpoint(path, {"params": params, "state": self.ts.state})
        return path

    def resume(self, path):
        """Params and BN state from a ``.npz`` of this tree (the JAX
        package's or the port's), sharded under a mesh; the optimizer
        state stays."""
        restored = load_checkpoint(path, {"params": self.ts.params,
                                          "state": self.ts.state})
        dev = tree_leaves(self.ts.params)[0].device
        params = to_device(restored["params"], dev)
        if self.mesh is not None:
            params = shard_params(self.mesh, params)
        self.ts = self.ts._replace(params=params,
                                   state=to_device(restored["state"], dev))


def yolo_trainer(model, params, state, ckpt_dir, lr=1e-3, every_k=2,
                 log_every=10, grad_clip=None, mesh=None):
    tx = frozen_adam(params, lr=lr, every_k=every_k, grad_clip=grad_clip)
    return Trainer(make_yolo_train_step(model, tx),
                   init_train_state(params, state, tx), ckpt_dir,
                   name="yolo", log_every=log_every, mesh=mesh)


def refine_trainer(model, params, state, ckpt_dir, lr=5e-4, every_k=2,
                   log_every=10, grad_clip=None, mesh=None):
    tx = frozen_adam(params, lr=lr, frozen_prefixes=STAGE2_FROZEN,
                     every_k=every_k, grad_clip=grad_clip)
    return Trainer(make_refine_train_step(model, tx,
                                          frozen_prefixes=STAGE2_FROZEN),
                   init_train_state(params, state, tx), ckpt_dir,
                   name="module2", log_every=log_every, mesh=mesh)


def fusion_viz(model, mode=0):
    """Image-summary hook: the radar heatmaps and the learned radar
    attention (the reference's TensorBoard grids)."""

    def viz(ts, batch):
        with torch.no_grad():
            out = model.apply(ts.params, ts.state, batch["images"],
                              batch["radar_maps"], batch["radar_boxes"],
                              batch["rmask"], mode=mode)
        return {"radar/maps": batch["radar_maps"],
                "radar/attention": out["radar_attention"]}

    return viz


def fusion_trainer(model, params, state, ckpt_dir, lr=5e-4, every_k=2,
                   mode=0, freeze_module2=True, viz=False, log_every=10,
                   grad_clip=None, fold_frozen=False, mesh=None):
    """``fold_frozen``: fold the frozen Darknet's BN inside the step, so
    the model's stem kernels (``Darknet(stem_stages=...)``) run in the
    training forward; exact for the eval-mode frozen base detector."""
    frozen = STAGE3_FROZEN if freeze_module2 else (("darknet",),)
    tx = frozen_adam(params, lr=lr, grad_clip=grad_clip,
                     frozen_prefixes=frozen, every_k=every_k)
    return Trainer(make_fusion_train_step(model, tx, mode,
                                          frozen_prefixes=frozen,
                                          fold_frozen=fold_frozen),
                   init_train_state(params, state, tx), ckpt_dir,
                   name="module3", log_every=log_every,
                   viz_fn=fusion_viz(model, mode) if viz else None,
                   mesh=mesh)


def transfer_module2_to_fusion(refine_params, refine_state, fusion_params,
                               fusion_state):
    """The module2 -> module3 cross-load on the port's trees: the stage-2
    RefineNetwork's ``fcn`` stack into ``img_cnn`` and its refinement
    nets 0-2 into the fusion refinement head (``radar_net`` keeps its
    init). Pair with ``STAGE3_FROZEN`` so the transferred subtrees stay
    frozen. The tensors are shared, not copied (no step writes in
    place)."""
    fusion_params = dict(fusion_params)
    fusion_state = dict(fusion_state)
    fusion_params["img_cnn"] = tree_map(lambda x: x, refine_params["fcn"])
    fusion_state["img_cnn"] = tree_map(lambda x: x, refine_state["fcn"])
    refine = dict(fusion_params["refine"])
    for net in ("net0", "net1", "net2"):
        refine[net] = refine_params["refine"][net]
    fusion_params["refine"] = refine
    return fusion_params, fusion_state
