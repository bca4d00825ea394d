"""Weights in and out: the JAX package's checkpoints and parameter trees.

``save_checkpoint`` and ``load_checkpoint`` write and read the JAX
package's single-file ``.npz`` format (``millieye_tpu/io/checkpoint.py``):
one array per leaf under ``"{i:05d}|{key/path}"``, in the order of JAX's
``tree_util.tree_leaves_with_path`` (``leaf_items``), with 4-D leaves
HWIO; ``load_checkpoint`` is the port's one reader of such a file.

``save_sharded`` and ``load_sharded`` are the counterpart of the JAX
package's ``save_orbax`` and ``load_orbax``: a tree as a checkpoint
directory of ``torch.distributed.checkpoint`` (DCP), written from one
process or by every rank of a mesh (``parallel/mesh.py``), each rank
writing its own slices, and read back whole in one process with no
template. The containers come back as JAX's ``load_orbax`` gives them
without a template: dicts as dicts (keys sorted), lists and tuples as
lists, a named tuple as a dict of its fields, None as None, a Python
scalar (a step counter) as itself; tensors as CPU tensors of their dtype
and shape (4-D leaves OIHW, as written). A mesh's leaf sliced over
"model" is written as its M slices, slice ``j`` under its own key
``"{i:05d}|{key/path}|{j}"``: DCP keeps one copy of each key over all
ranks, so the replicated leaves and each slice (held by every rank of
"data") are written once, where slices under one key would be dropped
but one. (A ``DTensor`` over a ``DeviceMesh`` would carry the same
layout, but makes process groups of its own beside the mesh's.)

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

import json
import os
import shutil
import warnings

import numpy as np
import torch

_TREE = "_tree"         # the key of the tree's layout (JSON as uint8)


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


def _layout(tree, sliced, model, index, tensors):
    """``tree`` as JSON-able nodes: {"dict": {key: node}}, {"list":
    [node]}, None, {"value": scalar}, {"tensor": key[, "slices": M]};
    each tensor (this rank's slice where its path is in ``sliced``) goes
    into ``tensors`` under its key."""
    def node(x, path):
        if x is None:
            return None
        if isinstance(x, dict):
            return {"dict": {str(k): node(x[k], path + (str(k),))
                             for k in sorted(x)}}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return {"dict": {k: node(getattr(x, k), path + (k,))
                             for k in sorted(x._fields)}}
        if isinstance(x, (list, tuple)):
            return {"list": [node(v, path + (str(i),))
                             for i, v in enumerate(x)]}
        if isinstance(x, (bool, int, float)):
            return {"value": x}
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"save_sharded: leaf {'/'.join(path)!r} is a "
                            f"{type(x).__name__}")
        key = f"{len(keys):05d}|{'/'.join(path) or '_root'}"
        keys.append(key)
        t = x.detach().cpu().contiguous()
        if path in sliced:
            tensors[f"{key}|{index}"] = t
            return {"tensor": key, "slices": model}
        tensors[key] = t
        return {"tensor": key}

    keys = []
    return node(tree, ())


def save_sharded(path, tree, mesh=None):
    """Write ``tree`` (nested dicts, lists, tuples and named tuples of
    tensors and Python scalars) as a checkpoint directory,
    the port's ``save_orbax``; CUDA or CPU tensors. Raises ``ValueError``
    where ``path`` exists. ``mesh``: every rank of the mesh's world calls
    this with its own part of the tree (the leaves of ``mesh.sliced()``
    its slices); each slice and each replicated leaf is written once.
    The directory appears whole when every rank is done."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    group, lead, sliced, model, index = None, True, frozenset(), 1, 0
    if mesh is not None:
        if not dist.is_initialized() or dist.get_world_size() != mesh.size:
            raise RuntimeError(f"save_sharded: {mesh!r} needs a world of "
                               f"{mesh.size} ranks (parallel.world.launch)")
        group, lead = dist.group.WORLD, dist.get_rank() == 0
        sliced, model = mesh.sliced(), mesh.shape["model"]
        index = mesh.index("model")
    if os.path.exists(path):
        raise ValueError(f"Destination {path} already exists.")
    tensors = {}
    layout = json.dumps(_layout(tree, sliced, model, index, tensors))
    tensors[_TREE] = torch.frombuffer(bytearray(layout.encode()),
                                      dtype=torch.uint8)
    partial = path + ".partial"
    if lead:
        shutil.rmtree(partial, ignore_errors=True)
    if group is not None:           # every rank has checked ``path``
        dist.barrier(group)
    with warnings.catch_warnings():     # DCP's "a single process" note
        warnings.filterwarnings("ignore", message="torch.distributed is")
        dcp.save(tensors, storage_writer=dcp.FileSystemWriter(partial),
                 process_group=group, no_dist=group is None)
    if lead:
        os.rename(partial, path)
    if group is not None:
        dist.barrier(group)


def _build(node, tensors):
    if node is None:
        return None
    if "dict" in node:
        return {k: _build(v, tensors) for k, v in node["dict"].items()}
    if "list" in node:
        return [_build(v, tensors) for v in node["list"]]
    if "value" in node:
        return node["value"]
    key = node["tensor"]
    if "slices" in node:
        return torch.cat([tensors[f"{key}|{j}"]
                          for j in range(node["slices"])])
    return tensors[key]


def load_sharded(path):
    """The tree of a ``save_sharded`` directory, read whole in this
    process with no template (the port's ``load_orbax``): CPU tensors,
    containers as the module docstring says. Raises
    ``FileNotFoundError`` where ``path`` holds no checkpoint."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, ".metadata")):
        raise FileNotFoundError(f"Checkpoint at {path} not found.")
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    tensors = {k: torch.empty(m.size, dtype=m.properties.dtype)
               for k, m in meta.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is")
        dcp.load(tensors, storage_reader=dcp.FileSystemReader(path),
                 no_dist=True)
    layout = json.loads(tensors.pop(_TREE).numpy().tobytes().decode())
    return _build(layout, tensors)
