"""Weights in: the JAX package's checkpoints and parameter trees.

``read_npz`` reads the JAX package's single-file ``.npz`` checkpoints
(keys ``"00002|params/darknet/0/w"``: leaf index, then the key path)
into nested dicts and lists of numpy arrays, with numpy alone.
``convert`` is the one weight converter: it takes the JAX package's
``(params, state)`` as nested numpy arrays (from ``read_npz``, or a JAX
tree mapped through ``np.asarray``) and returns the port's parameters,
float32 tensors with convolution kernels turned from HWIO to OIHW.
"""
from __future__ import annotations

import numpy as np
import torch


def _listify(node):
    """Dicts whose keys are all digits become lists (missing slots, the
    weightless blocks the ``.npz`` leaves out, become empty dicts)."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        out = [{} for _ in range(max(int(k) for k in node) + 1)]
        for k, v in node.items():
            out[int(k)] = v
        return out
    return node


def read_npz(path):
    """A JAX-package ``.npz`` checkpoint -> (params, state) as nested
    numpy arrays."""
    tree = {}
    with np.load(path, allow_pickle=False) as z:
        for key in sorted(z.files, key=lambda k: int(k.split("|")[0])):
            parts = key.split("|", 1)[1].split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.array(z[key])
    tree = _listify(tree)
    return tree["params"], tree["state"]


def _to_tensor(a):
    # numpy leaves become tensors before any cast: numpy's promotion of
    # reduced-precision arrays with Python floats differs from torch's
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


def convert(params, state):
    """JAX ``(params, state)`` as nested numpy arrays -> the port's
    ``(params, state)``: the same nesting, float32 CPU tensors, conv
    kernels OIHW, linear weights kept [in, out]."""
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
