"""The ("data", "model") mesh over the ranks of a world (port of
``millieye_tpu/parallel/mesh.py``, with its names and errors).

The JAX package lays a train state and a batch on a mesh of devices and
lets GSPMD insert every collective: the sharded step is the same global
computation as the one-device step. Here a mesh position is a rank, one
process of a gloo world (``parallel/world.py``); rank ``r`` sits at data
index ``r // model`` and model index ``r % model``, the JAX package's
``reshape(n // model_axis, model_axis)``. The same global computation
is kept by hand:

* "data": each rank holds its slice of the batch (``shard_batch``); the
  batch statistics (train-mode BN, the YOLO loss's normalizers, the
  negative sampling's budget and keys, module2's dropout) are reduced
  over "data" inside the models (``parallel/collectives.py``), each
  rank's loss is its partial sum, and the train steps all-reduce the
  gradients over "data";
* "model": the shape rule of the JAX package shards axis 0 of an OIHW
  convolution with 490 or 256 outputs and of an ``[in, out]`` linear
  with 490 or 256 inputs. The score-map convolution (``img_cnn/0``,
  ``fcn/0``) runs column-parallel and the refinement head's ``net0``-
  ``net2`` row-parallel; any other sharded leaf (the Darknet's 256-wide
  convolutions) is gathered where it is used.

``make_mesh`` needs no world; the "data" and "model" subgroups are made
inside one, on first use, by every rank in the same order (a gloo rank
that makes only the groups it belongs to waits for the others forever).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from millieye_torch.parallel import collectives

# conv OIHW weights with 490/256 outputs and linear [in, out] weights with
# 490/256 inputs are worth sharding over "model"; everything else
# replicates
_TP_WIDTHS = (490, 256)


class Mesh:
    """``shape`` {"data": D, "model": M}; ``devices`` the device of each
    rank. Inside a world: ``rank``, ``index(axis)``, ``group(axis)`` and
    ``active()``. ``sharded`` holds the key paths (tuples of strings, as
    ``io/checkpoint.py:leaf_items`` spells them) of the parameters that
    ``shard_params`` sharded over "model", ``sharded_opt`` those of the
    optimizer slots that ``shard_train_state`` sliced like them."""

    def __init__(self, data, model, devices):
        self.shape = {"data": data, "model": model}
        self.devices = list(devices)
        self.sharded = frozenset()
        self.sharded_opt = frozenset()
        self.tp = frozenset()
        self._groups = None

    @property
    def size(self):
        return self.shape["data"] * self.shape["model"]

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']})")

    def __getstate__(self):
        return dict(self.__dict__, _groups=None)

    @property
    def rank(self):
        return dist.get_rank()

    def sliced(self):
        """The key paths of the leaves this rank holds as a slice of axis
        0 over "model": ``sharded``'s in a parameter tree, and in a train
        state (a ``TrainState`` or a dict of its fields) ``sharded``'s
        under "params" and ``sharded_opt``'s under "opt_state"."""
        return (self.sharded | {("params",) + p for p in self.sharded}
                | {("opt_state",) + p for p in self.sharded_opt})

    def index(self, axis):
        """This rank's index along "data" or "model"."""
        r, m = self.rank, self.shape["model"]
        return r // m if axis == "data" else r % m

    def group(self, axis):
        """This rank's process group along ``axis`` (every group of the
        mesh is made on the first call, by every rank, in one order)."""
        if self._groups is None:
            if not dist.is_initialized() or \
                    dist.get_world_size() != self.size:
                raise RuntimeError(
                    f"{self!r} needs a world of {self.size} ranks "
                    "(parallel.world.launch)")
            d, m, r = self.shape["data"], self.shape["model"], self.rank
            groups = {}
            for j in range(m):
                g = dist.new_group([i * m + j for i in range(d)])
                if r % m == j:
                    groups["data"] = g
            for i in range(d):
                g = dist.new_group([i * m + j for j in range(m)])
                if r // m == i:
                    groups["model"] = g
            self._groups = groups
        return self._groups[axis]

    @contextlib.contextmanager
    def active(self, tp=None):
        """The models' collectives reduce over this mesh inside the
        block; ``tp``: the paths whose layers run tensor-parallel."""
        self.group("data")
        prev_tp = self.tp
        if tp is not None:
            self.tp = frozenset(tp)
        prev = collectives._set_active(self)
        try:
            yield self
        finally:
            collectives._set_active(prev)
            self.tp = prev_tp


def make_mesh(n_devices=None, model_axis=1, devices=None):
    """Mesh of shape (n_devices // model_axis, model_axis). ``devices``
    (one a rank) defaults to ``cuda:(r % device_count)`` where CUDA is
    there, else the CPU."""
    if devices is None:
        count = torch.cuda.device_count()
        n = n_devices if n_devices is not None else max(count, 1)
        devices = [f"cuda:{r % count}" if count else "cpu"
                   for r in range(n)]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_axis={model_axis}")
    return Mesh(n // model_axis, model_axis, devices)


class Layout(NamedTuple):
    """A leaf's placement: ``spec`` names the mesh axis of each sharded
    tensor axis (JAX's ``PartitionSpec``); () replicates."""
    mesh: Mesh
    spec: tuple

    @property
    def axis(self):
        """The tensor axis sharded over "model", or None."""
        return self.spec.index("model") if "model" in self.spec else None


def batch_sharding(mesh):
    return Layout(mesh, ("data",))


def replicated(mesh):
    return Layout(mesh, ())


def _leaf_spec(leaf, tp_enabled):
    if not tp_enabled or not hasattr(leaf, "ndim"):
        return ()
    if leaf.ndim == 4 and leaf.shape[0] in _TP_WIDTHS:     # OIHW conv
        return ("model", None, None, None)
    if leaf.ndim == 2 and leaf.shape[0] in _TP_WIDTHS:     # linear in-dim
        return ("model", None)
    return ()


def map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and (named)
    tuples, in ``train/optim.py:tree_map``'s order; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_path(fn, getattr(tree, k), path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_sharding(mesh, params):
    """Layout tree for a parameter tree (TP on the wide axes when the
    mesh has a nontrivial "model" axis)."""
    tp = mesh.shape["model"] > 1
    return map_path(lambda _, leaf: Layout(mesh, _leaf_spec(leaf, tp)),
                    params)


def _shard(mesh, leaf, index=None):
    """The model shard of a full leaf, by the shape rule: this rank's, or
    that of model index ``index``."""
    if not _leaf_spec(leaf, mesh.shape["model"] > 1):
        return leaf
    n = leaf.shape[0] // mesh.shape["model"]
    i = mesh.index("model") if index is None else index
    return leaf.narrow(0, i * n, n).clone()


def shard_params(mesh, params):
    """This rank's shards of a full parameter tree; records the sharded
    paths on ``mesh.sharded``."""
    sharded = set()

    def put(path, leaf):
        if _leaf_spec(leaf, mesh.shape["model"] > 1):
            sharded.add(path)
        return _shard(mesh, leaf)

    out = map_path(put, params)
    mesh.sharded = frozenset(sharded)
    return out


def gather_params(mesh, params, keep=()):
    """The full tree from this rank's shards (a collective over "model";
    differentiable: the backward keeps this rank's slice). Leaves whose
    path is in ``keep`` stay sharded."""
    if not mesh.sharded:
        return params

    def get(path, leaf):
        if path not in mesh.sharded or path in keep:
            return leaf
        return collectives._AllGather.apply(
            leaf, mesh.group("model"), 0, mesh.index("model"))

    return map_path(get, params)


def _host(x):
    return isinstance(x, np.ndarray) and x.ndim >= 1


def shard_batch(mesh, batch):
    """This rank's slice of a batch, dim 0 sharded over "data". Host
    scalars (``_n``, ``brightness``) pass through unsharded; the numpy
    copy under ``batch["host"]`` is sliced alike."""
    d, i = mesh.shape["data"], mesh.index("data")

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.dim() >= 1 or _host(x):
            if x.shape[0] % d:
                raise ValueError(f"batch of {x.shape[0]} not divisible by "
                                 f"the data axis {d}")
            n = x.shape[0] // d
            return x[i * n:(i + 1) * n]
        return x

    return {k: v if k in ("_n", "brightness") else cut(v)
            for k, v in batch.items()}


def shard_train_state(mesh, ts):
    """This rank's part of a TrainState: params TP-or-replicated (their
    paths recorded on ``mesh.sharded``), BN state replicated, and every
    optimizer slot that mirrors a sharded parameter's shape sliced like
    it (their paths recorded on ``mesh.sharded_opt``)."""
    params = shard_params(mesh, ts.params)
    sliced = set()

    def put(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        if _leaf_spec(x, mesh.shape["model"] > 1):
            sliced.add(path)
        return _shard(mesh, x)

    opt_state = map_path(put, ts.opt_state)
    mesh.sharded_opt = frozenset(sliced)
    return type(ts)(params, ts.state, opt_state, ts.step)


def sharded_step(step_fn, mesh):
    """``step_fn`` run with the mesh active: the models reduce their batch
    statistics over "data" and the steps all-reduce the gradients."""
    def step(*args, **kwargs):
        with mesh.active():
            return step_fn(*args, **kwargs)

    return step
