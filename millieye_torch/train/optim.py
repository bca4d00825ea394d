"""Adam with frozen subtrees for the three training stages (port of
``millieye_tpu/train/optim.py``, whose optimizer is optax's).

The reference trains in three stages:

* stage 1: YOLO, everything trainable;
* stage 2: the base detector frozen, the refinement parts trained
  (``STAGE2_FROZEN``);
* stage 3: the base detector and the module2-pretrained image branch
  (``img_cnn`` and the refinement head's ``net0``-``net2``) frozen, the
  radar branch and the ensemble trained (``STAGE3_FROZEN``).

``frozen_adam`` is written by hand on tensors in optax's order of
operations, not through ``torch.optim.Adam``, whose rounding differs:

* ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): mu <- (1 - b1)
  g + b1 mu, nu <- (1 - b2) g*g + b2 nu, the count incremented before the
  bias corrections 1 - b**count (float32), update -lr * mu_hat /
  (sqrt(nu_hat + eps_root) + eps); ``optax.adamw`` adds weight_decay * p
  before the learning rate;
* ``optax.multi_transform`` with ``set_to_zero``: frozen leaves get zero
  updates and keep no moments (None in ``mu``/``nu``), and every inner
  transform sees the trainable leaves only (the clip's norm too);
* ``grad_clip``: zero_nans -> clip_by_global_norm -> zero_nans -> adam;
* ``optax.MultiSteps(every_k)``: the running mean acc + (g - acc) / (n +
  1) of the mini-steps' gradients, the inner update computed every
  mini-step and emitted (its state committed) only at the k-th, the
  updates emit * u (zero between boundaries), the accumulator reset to (1
  - emit) * acc.

Trees are nested dicts and lists of tensors (the port's parameter trees);
the optimizer state is made of named tuples, lists and dicts of tensors,
the counters int32 tensors on the parameters' device, so a step never
waits for the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from millieye_torch.io.checkpoint import leaf_items
from millieye_torch.parallel import collectives as pc

# stage-3 freeze set: the base detector and the module2-pretrained image
# branch; radar_net (new in module3) and the ensemble head train
STAGE3_FROZEN = (
    ("darknet",),
    ("img_cnn",),
    ("refine", "net0"),
    ("refine", "net1"),
    ("refine", "net2"),
)

# stage-2 freeze set: the base detector only
STAGE2_FROZEN = (("darknet",),)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples, named
    tuples; a None leaf stays None) and the same places of ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The non-None leaves of ``tree`` in JAX's order (dict keys sorted)."""
    return [leaf for _, leaf in leaf_items(tree)]


def label_tree(params, frozen_prefixes):
    """A tree of "train" / "freeze" labels matching ``params``: a leaf is
    frozen if its key path (dict keys, list indices) starts with one of
    ``frozen_prefixes``."""
    pres = tuple(tuple(p) for p in frozen_prefixes)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        return ("freeze" if any(path[:len(p)] == p for p in pres)
                else "train")

    return walk(params, ())


class AdamState(NamedTuple):
    count: Any          # int32 scalar tensor
    mu: Any             # first moments, None at frozen leaves
    nu: Any             # second moments, None at frozen leaves


class MultiStepsState(NamedTuple):
    mini_step: Any      # int32 scalar tensor
    gradient_step: Any  # int32 scalar tensor
    inner_opt_state: Any
    acc_grads: Any      # the running mean of the mini-steps' gradients


class FrozenAdam:
    """``init(params)`` -> state; ``update(grads, state, params)`` ->
    (updates, state), as an optax transformation. ``labels`` is a
    ``label_tree`` (None: every leaf trains)."""

    b1, b2, eps, eps_root = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, labels=None, lr=5e-4, every_k=1, weight_decay=0.0,
                 grad_clip=None):
        self.labels = labels
        self.lr = lr
        self.every_k = int(every_k)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def _trained(self, tree):
        """``tree`` with None at the frozen leaves."""
        if self.labels is None:
            return tree
        return tree_map(lambda x, lab: x if lab == "train" else None, tree,
                        self.labels)

    @staticmethod
    def _counter(params):
        dev = tree_leaves(params)[0].device
        return torch.zeros((), dtype=torch.int32, device=dev)

    def init(self, params):
        zeros = tree_map(torch.zeros_like, params)
        inner = AdamState(self._counter(params), self._trained(zeros),
                          self._trained(tree_map(torch.zeros_like, params)))
        if self.every_k <= 1:
            return inner
        return MultiStepsState(self._counter(params), self._counter(params),
                               inner, zeros)

    def update(self, grads, state, params):
        if self.every_k <= 1:
            return self._inner(grads, state, params)
        k = self.every_k
        n = state.mini_step
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads,
                       state.acc_grads)
        updates, new_inner = self._inner(acc, state.inner_opt_state, params)
        emit = n == k - 1
        inner = tree_map(lambda st, nst: torch.where(emit, nst, st),
                         state.inner_opt_state, new_inner)
        one = (~emit).to(torch.int32)
        new_state = MultiStepsState(
            mini_step=(n + 1) % k,
            gradient_step=(emit.to(torch.int32) * (state.gradient_step + 1)
                           + one * state.gradient_step),
            inner_opt_state=inner,
            acc_grads=tree_map(lambda a: one * a, acc))
        return tree_map(lambda u: emit * u, updates), new_state

    def _inner(self, grads, state, params):
        """multi_transform(train: [clip chain] adam, freeze: set_to_zero)."""
        g = self._trained(grads)
        if self.grad_clip:
            g = _zero_nans(g)
            g = _clip_by_global_norm(g, self.grad_clip)
            g = _zero_nans(g)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda x, m: (1 - b1) * x + b1 * m, g, state.mu)
        nu = tree_map(lambda x, v: (1 - b2) * (x * x) + b2 * v, g, state.nu)
        count = state.count + 1
        cf = count.to(torch.float32)

        def correction(b):
            return 1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                            device=cf.device), cf)

        bc1, bc2 = correction(b1), correction(b2)
        u = tree_map(lambda m, v: (m / bc1) / (
            torch.sqrt(v / bc2 + self.eps_root) + self.eps), mu, nu)
        if self.weight_decay:
            u = tree_map(lambda x, p: x + self.weight_decay * p, u,
                         self._trained(params))
        u = tree_map(lambda x: -self.lr * x, u)
        if self.labels is not None:
            u = tree_map(lambda z, lab, x: x if lab == "train"
                         else torch.zeros_like(z), grads, self.labels, u)
        return u, AdamState(count, mu, nu)


def _zero_nans(tree):
    return tree_map(lambda x: torch.where(torch.isnan(x),
                                          torch.zeros_like(x), x), tree)


def _clip_by_global_norm(tree, max_norm):
    """Under a mesh the squared norm of the leaves sharded over "model"
    is summed over its ranks; the replicated leaves count once."""
    m = pc.mesh()
    sharded = m.sharded if m is not None else frozenset()
    sq = [(tuple(k.split("/")) in sharded, (x * x).sum())
          for k, x in leaf_items(tree)]
    total = sum(v for s, v in sq if not s)
    if any(s for s, _ in sq):
        total = total + pc.model_count(sum(v for s, v in sq if s))
    g_norm = torch.sqrt(total)
    trigger = g_norm < max_norm
    return tree_map(lambda x: torch.where(trigger, x,
                                          (x / g_norm) * max_norm), tree)


def frozen_adam(params, lr=5e-4, frozen_prefixes=(), every_k=1,
                weight_decay=0.0, grad_clip=None):
    """Adam over the trainable subtree; frozen leaves get zero updates.

    lr defaults to the reference's stage-3 setting; ``every_k=2`` is its
    gradient-accumulation cadence (an optimizer step every 2 batches).
    ``grad_clip`` (a global-norm bound) chains zero_nans -> clip ->
    zero_nans before Adam: one exploding or NaN batch skews a step instead
    of poisoning the parameters; off by default, as in the reference."""
    labels = label_tree(params, frozen_prefixes) if frozen_prefixes else None
    return FrozenAdam(labels, lr=lr, every_k=every_k,
                      weight_decay=weight_decay, grad_clip=grad_clip)
