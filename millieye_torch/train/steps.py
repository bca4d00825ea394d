"""The train steps of the three stages (port of
``millieye_tpu/train/steps.py``).

Each ``make_*_train_step`` returns ``step(train_state, batch, draw) ->
(train_state, metrics)``: the forward in train mode, the gradients of the
loss with respect to the trainable leaves (``torch.autograd.grad``), the
optimizer, and a finite guard at the state boundary. ``draw(kind,
shape)`` gives the step's random numbers (``generator_draw`` from a
``torch.Generator``; stage 1 draws none). Metrics stay tensors on the
device: reading one waits for the card.

Frozen subtrees (``frozen_prefixes``, the optimizer's freeze set) enter
the step detached: no gradient is computed for them (the JAX package's
``stop_gradient`` at the leaves, which prunes the frozen Darknet's
backward) and their gradient is a zero tensor, which the masked optimizer
never reads. The fusion and refine networks run the frozen Darknet and its
NMS under ``torch.no_grad()``, so their kernels (the custom ops, which
register no autograd) never see a tensor that requires grad. BN: the base
detector keeps its running statistics in stages 2 and 3
(``state["darknet"]`` is carried over); stage 1 updates them.

Under an active mesh (``parallel.sharded_step``) a step is the global
step over the ranks' batch slices: the sharded leaves the model does not
run tensor-parallel (its ``TP_LEAVES``) are all-gathered where the step
starts (differentiably: each rank keeps its slice of the gradient), the
model reduces its batch statistics over "data", each rank's loss is its
partial sum, the trainable gradients are summed over "data" in one flat
buffer per dtype, the metrics are summed over "data", and the optimizer
steps each rank's shards.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from millieye_torch.io.checkpoint import leaf_items
from millieye_torch.models.yolo_head import yolo_loss
from millieye_torch.parallel import collectives as pc
from millieye_torch.parallel.mesh import gather_params, map_path
from millieye_torch.train.optim import label_tree, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    state: Any          # BN running statistics
    opt_state: Any
    step: int


def init_train_state(params, state, tx):
    return TrainState(params, state, tx.init(params), 0)


def generator_draw(gen):
    """``draw(kind, shape)`` from a ``torch.Generator`` (on the device the
    numbers are needed on): "negatives" uniform [0, 1) float32 keys,
    "dropout" a bool keep mask at p 0.5."""
    def draw(kind, shape):
        u = torch.rand(shape, generator=gen, device=gen.device)
        if kind == "negatives":
            return u
        if kind == "dropout":
            return u < 0.5
        raise ValueError(f"unknown draw {kind!r}")

    return draw


def _keep_finite(new, old):
    if not new.is_floating_point():
        return new          # counters cannot be non-finite
    return torch.where(torch.isfinite(new), new, old)


@torch.no_grad()
def _apply(tx, ts, grads, new_bn_state):
    """The optimizer, then the finite guard: a non-finite element of the
    parameters, the BN statistics (EMAs updated outside the optimizer) or
    the optimizer state reverts to its previous value, so one poisoned
    batch cannot corrupt the run. Returns (train state, the number of
    parameter and BN elements reverted, an int64 tensor; under a mesh
    the sharded leaves' counts summed over "model", the replicated ones
    counted once)."""
    updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
    params = tree_map(lambda p, u: (p + u).to(p.dtype), ts.params, updates)
    m = pc.mesh()
    if m is not None:   # replicated: "model" index 0's, as the gradients
        bn = []
        map_path(lambda _, x: bn.append(x), new_bn_state)
        bn = iter(pc.model_broadcast(bn))
        new_bn_state = tree_map(lambda _: next(bn), new_bn_state)
    sharded = m.sharded if m is not None else frozenset()

    def bad(x):
        return x.numel() - torch.isfinite(x).sum()

    items = leaf_items(params)
    reverted = sum(bad(x) for k, x in items if tuple(k.split("/"))
                   not in sharded) + sum(bad(x) for x in
                                         tree_leaves(new_bn_state))
    if sharded:
        reverted = reverted + pc.model_count(sum(
            bad(x) for k, x in items if tuple(k.split("/")) in sharded))
    params = tree_map(_keep_finite, params, ts.params)
    new_bn_state = tree_map(_keep_finite, new_bn_state, ts.state)
    opt_state = tree_map(_keep_finite, opt_state, ts.opt_state)
    return TrainState(params, new_bn_state, opt_state, ts.step + 1), reverted


def _frozen_mask(params, frozen_prefixes):
    """A tree of bools: True at the leaves under ``frozen_prefixes``."""
    if not frozen_prefixes:
        return tree_map(lambda _: False, params)
    return tree_map(lambda lab: lab == "freeze",
                    label_tree(params, frozen_prefixes))


def _leaves_for_grad(params, frozen):
    """(params with the trainable leaves as fresh leaves that require
    grad and the frozen ones detached, [the trainable leaves])."""
    live = []

    def prep(p, f):
        if f or not p.is_floating_point():
            return p.detach()
        q = p.detach().requires_grad_(True)
        live.append(q)
        return q

    return tree_map(prep, params, frozen), live


def _sum_over_data(tensors):
    """The tensors summed over the "data" ranks: one all-reduce of a flat
    buffer per dtype."""
    if pc.data_size() == 1:
        return tensors
    return pc.flat_apply(tensors, pc.data_count)


def _replicated(tensors, paths):
    """Under a mesh, the leaves outside ``mesh.sharded`` (``paths`` their
    key paths) taken from "model" index 0, so that what the "model"
    ranks compute redundantly stays bit-identical across them."""
    m = pc.mesh()
    if m is None or m.shape["model"] == 1:
        return tensors
    idx = [i for i, p in enumerate(paths) if p not in m.sharded]
    out = list(tensors)
    for i, t in zip(idx, pc.model_broadcast([tensors[i] for i in idx])):
        out[i] = t
    return out


def _grads(loss, live_params, live, frozen):
    """The gradient tree: d loss / d leaf at the trainable leaves (zero
    where the loss does not reach a leaf; under a mesh summed over
    "data", the replicated leaves' taken from "model" index 0), zeros at
    the frozen ones."""
    got = torch.autograd.grad(loss, live, allow_unused=True) if live else []
    got = _sum_over_data([torch.zeros_like(p) if g is None else g
                          for p, g in zip(live, got)])
    paths = []
    map_path(lambda path, x: paths.append(path) if x.requires_grad
             else None, live_params)
    got = iter(_replicated(got, paths))
    return tree_map(lambda p, f: torch.zeros_like(p)
                    if f or not p.requires_grad else next(got),
                    live_params, frozen)


def _mesh_params(model, params):
    """(the parameters the model runs on, the paths it runs
    tensor-parallel): outside a mesh ``params`` and none; under one, the
    sharded leaves outside the model's ``TP_LEAVES`` gathered."""
    m = pc.mesh()
    if m is None or not m.sharded:
        return params, frozenset()
    tp = m.sharded & getattr(model, "TP_LEAVES", frozenset())
    return gather_params(m, params, keep=tp), tp


def _tensor_parallel(tp):
    m = pc.mesh()
    return m.active(tp=tp) if m is not None else contextlib.nullcontext()


def _sum_metrics(metrics):
    """Each rank's partial metrics summed over "data" (the global
    ones)."""
    return {k: pc.data_count(v) for k, v in metrics.items()}


def make_yolo_train_step(model, tx):
    """Stage 1: YOLO training, every leaf trainable, BN in train mode."""

    def step(ts, batch, draw=None):
        images, targets, tmask = (batch["images"], batch["targets"],
                                  batch["tmask"])
        frozen = tree_map(lambda _: False, ts.params)
        live_params, live = _leaves_for_grad(ts.params, frozen)
        params, _ = _mesh_params(model, live_params)
        out = model.apply(params, ts.state, images, train=True)
        loss, per_scale = yolo_loss(out["preds"], model.anchors_per_scale,
                                    images.shape[1], targets, tmask)
        grads = _grads(loss, live_params, live, frozen)
        metrics = {"loss": loss.detach()}
        for i, m in enumerate(per_scale):
            metrics.update({f"scale{i}/{k}": v for k, v in m.items()})
        metrics = _sum_metrics(metrics)
        ts, reverted = _apply(tx, ts, grads, out["state"])
        metrics["nonfinite_reverted"] = reverted
        return ts, metrics

    return step


def make_refine_train_step(model, tx, frozen_prefixes=()):
    """Stage 2: frozen YOLO + refinement and ensemble heads.
    ``frozen_prefixes``: the optimizer's freeze set, detached here."""

    def step(ts, batch, draw):
        frozen = _frozen_mask(ts.params, frozen_prefixes)
        live_params, live = _leaves_for_grad(ts.params, frozen)
        params, tp = _mesh_params(model, live_params)
        with _tensor_parallel(tp):
            out = model.apply(params, ts.state, batch["images"], train=True,
                              targets=batch["targets"], tmask=batch["tmask"],
                              draw=draw)
            grads = _grads(out["loss"], live_params, live, frozen)
        # the base detector's BN statistics stay frozen
        bn_state = dict(out["state"], darknet=ts.state["darknet"])
        metrics = _sum_metrics(dict(out["metrics"],
                                    loss=out["loss"].detach()))
        ts, reverted = _apply(tx, ts, grads, bn_state)
        metrics["nonfinite_reverted"] = reverted
        return ts, metrics

    return step


def make_fusion_train_step(model, tx, mode=0, frozen_prefixes=(),
                           fold_frozen=False):
    """Stage 3: frozen YOLO and module2 branch, the radar branch and the
    ensemble trained. ``fold_frozen`` (the Darknet must be frozen): fold
    the frozen Darknet's BN into its convolutions inside the step (the
    base detector runs eval-mode BN, so this is the same function), which
    lets the model's stem kernels run in the training forward."""
    fold = bool(fold_frozen)
    if fold and ("darknet",) not in tuple(tuple(p) for p in frozen_prefixes):
        raise ValueError("fold_frozen requires the darknet to be frozen")

    def step(ts, batch, draw):
        frozen = _frozen_mask(ts.params, frozen_prefixes)
        live_params, live = _leaves_for_grad(ts.params, frozen)
        params, tp = _mesh_params(model, live_params)
        state = ts.state
        if fold:
            with torch.no_grad():
                fp, fs = model.darknet.fold_batchnorm(params["darknet"],
                                                      state["darknet"])
            params = dict(params, darknet=fp)
            state = dict(state, darknet=fs)
        with _tensor_parallel(tp):
            out = model.apply(params, state, batch["images"],
                              batch["radar_maps"], batch["radar_boxes"],
                              batch["rmask"], mode=mode, train=True,
                              targets=batch["targets"], tmask=batch["tmask"],
                              draw=draw)
            grads = _grads(out["loss"], live_params, live, frozen)
        bn_state = dict(out["state"], darknet=ts.state["darknet"])
        metrics = _sum_metrics(dict(out["metrics"],
                                    loss=out["loss"].detach()))
        ts, reverted = _apply(tx, ts, grads, bn_state)
        metrics["nonfinite_reverted"] = reverted
        return ts, metrics

    return step
