"""Rank-side functions of the port's mesh tests (no tests here).

The ranks of a world (``millieye_torch/parallel/world.py``) unpickle the
function they run by module and name, so the functions the tests give
``world.launch`` live in this module, which imports torch, numpy and the
port only: a rank never imports JAX.
"""
import time

import torch

from millieye_torch import parallel
from millieye_torch.eval import harness
from millieye_torch.io.checkpoint import leaf_items
from millieye_torch.parallel import world
from millieye_torch.parallel.mesh import gather_params


def _mesh(n, model_axis, dev):
    return parallel.make_mesh(n, model_axis=model_axis, devices=[
        str(world.rank_device(r, dev.type)) for r in range(n)])


def eval_rank(rank, dev, n, payload):
    """``harness.evaluate_fusion(mesh=)`` over an n x 1 mesh on the
    batches of ``payload`` (a ``torch.save`` file of model, params,
    state, batches, mode); returns the result and this rank's rows of
    each batch (its slice, from the forward the harness runs)."""
    model, params, state, batches, mode = torch.load(payload,
                                                     weights_only=False)
    mesh = _mesh(n, 1, dev)
    rows = []
    real = harness._evaluate

    def evaluate(batches, forward, iou_thresh, mesh=None):
        def rec(batch):
            out = forward(batch)
            rows.append(tuple(t.cpu() for t in out))
            return out
        return real(batches, rec, iou_thresh, mesh)

    harness._evaluate = evaluate
    try:
        result = harness.evaluate_fusion(model, params, state, batches,
                                         mode=mode, mesh=mesh)
    finally:
        harness._evaluate = real
    return {"result": result, "rows": rows}


def shardmap_rank(rank, dev, n, payload):
    """One step of the shard_map twin over an n x 1 mesh; returns the
    rank's loss, step, Darknet leaves, the gradients summed over "data",
    the BN state and the metrics of ``step.shard_grads``."""
    from millieye_torch.parallel.shard_map_step import (
        make_shardmap_fusion_step)
    from millieye_torch.train.optim import STAGE3_FROZEN, frozen_adam
    from millieye_torch.train.steps import init_train_state
    model, params, state, batch, seed = torch.load(payload,
                                                   weights_only=False)
    mesh = _mesh(n, 1, dev)
    tx = frozen_adam(params, lr=1e-3, frozen_prefixes=STAGE3_FROZEN)
    ts = parallel.shard_train_state(mesh, init_train_state(params, state,
                                                           tx))
    step = make_shardmap_fusion_step(model, tx, mesh)
    local = parallel.shard_batch(mesh, batch)
    grads, bn, metrics = step.shard_grads(ts, local, seed)
    ts2, m2 = step(ts, local, seed)
    return {"loss": float(m2["loss"]), "step": int(ts2.step),
            "darknet": [x for _, x in leaf_items(ts2.params["darknet"])],
            "grads": dict(leaf_items(grads)), "bn": dict(leaf_items(bn)),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def raise_rank(rank, dev):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def hang_rank(rank, dev):
    if rank == 1:
        time.sleep(600)                 # never reaches the barrier
    torch.distributed.barrier()


class TrainProbe:
    """A train ``probe`` (``cli/train.py:main``): the loss of each step
    and, at the end, the full parameters and Adam's first moments (the
    sharded leaves gathered) of the rank's trainer."""

    def __init__(self):
        self.losses = []

    def __call__(self, step_no, ts, metrics):
        self.losses.append(float(metrics["loss"]))

    def report(self, trainer):
        opt = trainer.ts.opt_state
        mu = (opt.inner_opt_state if hasattr(opt, "inner_opt_state")
              else opt).mu
        params = trainer.full_params()
        if trainer.mesh is not None:
            with torch.no_grad(), trainer.mesh.active():
                mu = gather_params(trainer.mesh, mu)
        return {"losses": self.losses,
                "params": {k: v.cpu() for k, v in leaf_items(params)},
                "mu": {k: v.cpu() for k, v in leaf_items(mu)}}
