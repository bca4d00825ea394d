"""Weights in and out: the JAX package's checkpoints and parameter trees.

``save_checkpoint`` and ``load_checkpoint`` write and read the JAX
package's single-file ``.npz`` format (``millieye_tpu/io/checkpoint.py``;
its orbax pair has no counterpart here): one array per leaf under
``"{i:05d}|{key/path}"``, in the order of JAX's
``tree_util.tree_leaves_with_path`` (``leaf_items``), with 4-D leaves
HWIO; ``load_checkpoint`` is the port's one reader of such a file.
``convert`` is the one weight converter: it takes the JAX package's
``(params, state)`` as nested numpy arrays (a JAX tree mapped through
``np.asarray``) and returns the port's parameters,
float32 tensors with convolution kernels turned from HWIO to OIHW. It
walks any tree of the JAX package: ``FusionNetwork``'s (``darknet``,
``img_cnn``, ``radar_enc``, ``refine``, ``ensemble``) and
``RefineNetwork``'s (``darknet``, ``fcn``, ``refine``, ``ensemble``);
every 4-D leaf of either is a convolution kernel.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _to_tensor(a):
    # numpy leaves become tensors before any cast: numpy's promotion of
    # reduced-precision arrays with Python floats differs from torch's
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a, dtype=np.int8 if a.dtype == np.int8
                                  else np.float32))
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


def convert(params, state):
    """JAX ``(params, state)`` as nested numpy arrays -> the port's
    ``(params, state)``: the same nesting, float32 CPU tensors (int8
    leaves stay int8), every 4-D leaf turned HWIO -> OIHW, linear weights
    kept [in, out]. That also carries a serving tree: ``w2`` and the int8
    ``q``/``q2`` go OIHW, a per-channel ``scale`` [1, 1, 1, D] becomes
    [D, 1, 1, 1], ``wi`` stays [16C, 4D] and ``xs`` a scalar."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _to_tensor(node)

    return walk(params), walk(state)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def leaf_items(tree, prefix=()):
    """[(key path, leaf)] in the order of JAX's
    ``tree_util.tree_leaves_with_path``: dict keys sorted, sequence items
    in order, a named tuple's fields by name; empty containers and None
    give no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaf_items(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for k in tree._fields
                for item in leaf_items(getattr(tree, k), prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaf_items(v, prefix + (str(i),))]
    return [("/".join(prefix) or "_root", tree)]


def _to_file(leaf):
    """A leaf as the JAX package stores it: numpy, 4-D tensors OIHW ->
    HWIO (the inverse of ``convert``'s HWIO -> OIHW)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    return t.contiguous().numpy()


def save_checkpoint(path, tree):
    """Write ``tree`` (nested dicts, lists and tuples of tensors, e.g.
    ``{"params": ..., "state": ...}``) as the JAX package's ``.npz``,
    which its ``load_checkpoint`` reads. Dtypes are kept (int8 stays
    int8)."""
    flat = {f"{i:05d}|{key}": _to_file(leaf)
            for i, (key, leaf) in enumerate(leaf_items(tree))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def _fill(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        filled = {k: _fill(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_fill(getattr(like, k), leaves)
                            for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, leaves) for v in like)
    return next(leaves)


def load_checkpoint(path, like):
    """Read a ``.npz`` of the JAX package into the structure of ``like``
    (the same model built the same way). Leaf count and key paths must
    match; shapes and dtypes come from the file, 4-D leaves turned HWIO
    -> OIHW, as CPU tensors."""
    with np.load(path, allow_pickle=False) as z:
        entries = sorted(z.files, key=lambda k: int(k.split("|")[0]))
        arrays = [z[k] for k in entries]
    expect = leaf_items(like)
    if len(expect) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template has "
            f"{len(expect)}")
    for (key, _), entry in zip(expect, entries):
        if entry.split("|", 1)[1] != key:
            raise ValueError(
                f"checkpoint key {entry.split('|', 1)[1]!r} != template "
                f"key {key!r}")
    tensors = []
    for a in arrays:
        t = torch.from_numpy(np.array(a))
        tensors.append(t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4
                       else t)
    return _fill(like, iter(tensors))
