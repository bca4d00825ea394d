"""The collectives of a sharded step and the mesh that is active.

A mesh is active inside ``Mesh.active()`` in a rank of a world
(``parallel/world.py``); outside one every function here is the identity
(or the plain local value), so the models call them unconditionally and
a one-process run is unchanged.

Two conventions fix the backward passes (the Megatron ones, made
explicit):

* over "data" each rank's loss is its PARTIAL sum of the global loss, so
  a sum all-reduce (``data_sum``) sends the sum of every rank's upstream
  gradient back to each rank's input: the cross-rank terms of a
  batch-global statistic (a BN mean, a loss normalizer);
* over "model" every rank of a group holds the same loss (the groups
  compute redundantly past a tensor-parallel layer), so a sum all-reduce
  (``model_sum``) passes its gradient through, an all-gather
  (``model_gather``) keeps its rank's slice of the gradient, and a slice
  (``model_split``) all-gathers it.

The collectives are ``torch.distributed``'s over gloo, on the tensors'
own device: gloo takes CUDA tensors for the all-reduce, the all-gather
and the broadcast (torch 2.11.0+cu128 on an H100). A build that refuses
one raises; nothing is moved to the host behind the caller's back.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_ACTIVE = None          # the active Mesh, or None


def mesh():
    """The active mesh, or None."""
    return _ACTIVE


def _set_active(m):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, m
    return prev


def all_reduce_(t, group):
    """Sum all-reduce of ``t`` over ``group``; returns the sum (``t``
    itself where it is contiguous)."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t, group, dim=0):
    """The group's tensors concatenated along ``dim``, in group rank
    order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def broadcast_(t, src, group):
    """``t`` from global rank ``src`` to every rank of ``group``; returns
    it (``t`` itself where it is contiguous)."""
    t = t.contiguous()
    dist.broadcast(t, src=src, group=group)
    return t


def flat_apply(tensors, fn):
    """``fn`` on one flat buffer per dtype of ``tensors`` (one collective
    a dtype, not one a tensor); returns the tensors it gives back, in
    their shapes."""
    out = list(tensors)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = fn(torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, backward_sum):
        ctx.group, ctx.backward_sum = group, backward_sum
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward_sum:
            g = all_reduce_(g.clone(), ctx.group)
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(),
                None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index, parts):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // parts
        return x.narrow(dim, index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None, None, None


def _data():
    m = _ACTIVE
    return m if m is not None and m.shape["data"] > 1 else None


def _model():
    m = _ACTIVE
    return m if m is not None and m.shape["model"] > 1 else None


def data_size():
    m = _data()
    return 1 if m is None else m.shape["data"]


def data_sum(x):
    """Differentiable sum over the "data" ranks (partial-sum losses: the
    backward sums every rank's gradient)."""
    m = _data()
    return x if m is None else _AllReduce.apply(x, m.group("data"), True)


@torch.no_grad()
def data_count(x):
    """The sum of ``x`` over the "data" ranks, without gradient (a count
    of masked elements, a metric)."""
    m = _data()
    return x if m is None else all_reduce_(x.detach().clone(),
                                           m.group("data"))


@torch.no_grad()
def data_gather(x, dim=0):
    """The "data" ranks' ``x`` concatenated along ``dim`` in global batch
    order, without gradient."""
    m = _data()
    return x if m is None else all_gather(x, m.group("data"), dim)


def data_slice(x, dim=0):
    """This rank's slice of a global batch axis (every "data" rank draws
    the same global random numbers and keeps its own)."""
    m = _data()
    if m is None:
        return x
    n = x.shape[dim] // m.shape["data"]
    return x.narrow(dim, m.index("data") * n, n)


@torch.no_grad()
def model_count(x):
    """The sum of ``x`` over the "model" ranks, without gradient."""
    m = _model()
    return x if m is None else all_reduce_(x.detach().clone(),
                                           m.group("model"))


@torch.no_grad()
def model_broadcast(tensors):
    """The tensors of "model" index 0, on every rank of its "model"
    group: the replicated values a group computes redundantly stay
    bit-identical where the card's kernels are not deterministic (an
    atomic sum in a backward)."""
    m = _model()
    if m is None or not tensors:
        return tensors
    src = m.rank - m.index("model")
    return flat_apply([t.detach() for t in tensors],
                      lambda flat: broadcast_(flat, src, m.group("model")))


def model_parallel(path):
    """True where the leaf at ``path`` (a tuple of keys of the train
    state's parameter tree) is sharded over "model" and the model runs
    its layer tensor-parallel."""
    m = _model()
    return m is not None and tuple(path) in m.tp


def model_gather(x, dim=0):
    """The "model" ranks' shards concatenated along ``dim``; the backward
    keeps this rank's slice of the (replicated) gradient."""
    m = _model()
    if m is None:
        return x
    return _AllGather.apply(x, m.group("model"), dim, m.index("model"))


def model_sum(x):
    """Sum over the "model" ranks of a row-parallel product's partial
    results; the gradient passes through (every rank holds it)."""
    m = _model()
    return x if m is None else _AllReduce.apply(x, m.group("model"), False)


def model_split(x, dim):
    """This rank's slice of a replicated activation along ``dim``; the
    backward all-gathers the slices' gradients."""
    m = _model()
    if m is None:
        return x
    return _Split.apply(x, m.group("model"), dim, m.index("model"),
                        m.shape["model"])
