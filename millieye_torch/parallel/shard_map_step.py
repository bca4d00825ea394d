"""The explicit-collective twin of the sharded stage-3 step (port of
``millieye_tpu/parallel/shard_map_step.py``).

``parallel.sharded_step`` keeps the one-process step's numbers: batch
statistics, loss normalizers and the negative sampling run over the
global batch. This twin has per-shard semantics instead, as the JAX
package's ``shard_map`` step does: each rank runs the forward and the
backward on its slice alone and the collectives are placed by hand.

* gradients: the per-shard sums summed over "data" (the losses are sum
  reductions);
* balanced negative sampling runs per shard: the k = min(5 pos, neg)
  budget is local, and each shard draws its random numbers from a
  generator seeded from (seed, data index) (``shard_seed``), the JAX
  twin's ``fold_in`` of the axis index;
* BN batch statistics are local and the new BN state is averaged over
  "data"; the Darknet's state is kept as it was (frozen BN);
* metrics (and the loss) are summed over "data";
* the finite guard covers the parameters, the BN state and the
  optimizer state (``train/steps.py:_apply``).

Leaves sharded over "model" are gathered for the forward (the gradient
keeps each rank's slice), so the twin runs on any mesh; the JAX package
runs it data-parallel only.
"""
from __future__ import annotations

import torch

from millieye_torch.parallel import collectives as pc
from millieye_torch.parallel.mesh import gather_params, map_path
from millieye_torch.train.optim import tree_map
from millieye_torch.train.steps import (_apply, _leaves_for_grad,
                                        _replicated, _sum_over_data,
                                        generator_draw)


def shard_seed(seed, index):
    """The seed of data shard ``index``'s generator."""
    return int(seed) * 1_000_003 + int(index)


def make_shardmap_fusion_step(model, tx, mesh, mode=0):
    """Returns ``step(ts, batch, seed) -> (ts, metrics)``, run in every
    rank of ``mesh``'s world on the rank's slice of the batch
    (``parallel.shard_batch``); ``step.shard_grads(ts, batch, seed)``
    gives (the gradients summed over "data", the BN state averaged over
    "data", the metrics summed over "data")."""
    labels = tx.labels

    def frozen_mask(params):
        if labels is None:
            return tree_map(lambda _: False, params)
        return tree_map(lambda lab: lab == "freeze", labels)

    def shard_grads(ts, batch, seed):
        dev = batch["images"].device
        gen = torch.Generator(device=dev).manual_seed(
            shard_seed(seed, mesh.index("data")))
        frozen = frozen_mask(ts.params)
        live_params, live = _leaves_for_grad(ts.params, frozen)
        params = gather_params(mesh, live_params)
        out = model.apply(params, ts.state, batch["images"],
                          batch["radar_maps"], batch["radar_boxes"],
                          batch["rmask"], mode=mode, train=True,
                          targets=batch["targets"], tmask=batch["tmask"],
                          draw=generator_draw(gen))
        got = torch.autograd.grad(out["loss"], live, allow_unused=True)
        paths = []
        map_path(lambda path, x: paths.append(path) if x.requires_grad
                 else None, live_params)
        with mesh.active(tp=()):
            got = _sum_over_data([torch.zeros_like(p) if g is None else g
                                  for p, g in zip(live, got)])
            got = iter(_replicated(got, paths))
            grads = tree_map(lambda p, f: torch.zeros_like(p)
                             if f or not p.requires_grad else next(got),
                             live_params, frozen)
            metrics = dict(out["metrics"], loss=out["loss"].detach())
            metrics = {k: pc.data_count(v) for k, v in metrics.items()}
            d = mesh.shape["data"]
            new_bn = tree_map(lambda s: pc.data_count(s) / d
                              if s.is_floating_point() else s, out["state"])
        return grads, new_bn, metrics

    def step(ts, batch, seed):
        grads, new_bn, metrics = shard_grads(ts, batch, seed)
        new_bn = dict(new_bn, darknet=ts.state["darknet"])  # frozen BN
        with mesh.active(tp=()):
            ts, reverted = _apply(tx, ts, grads, new_bn)
        metrics["nonfinite_reverted"] = reverted
        return ts, metrics

    step.shard_grads = shard_grads
    return step
