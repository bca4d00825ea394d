"""Binary darknet ``.weights`` I/O (port of
``millieye_tpu/io/darknet_weights.py``).

The format: a header of 5 little-endian int32 (major, minor, revision,
seen, _), then one float32 stream. For each convolutional block, in
graph order:

* with batch_normalize: BN bias (beta), BN weight (gamma), running mean,
  running var, each [C], then the conv weights;
* without: the conv bias [C], then the conv weights.

The conv weights are OIHW in the file and in the port, so they load and
save as they are (the JAX package transposes to and from HWIO), and the
port writes the JAX package's bytes for the same weights.

Backbone-only files keep their conventional cutoffs: a file whose name
holds ``darknet53.conv.74`` loads the first 75 blocks, one whose name
holds ``yolov3-tiny.conv.15`` the first 15; the other blocks keep the
values they had. Only the file's own name counts, not its directories
(the JAX package searches the whole path).
"""
from __future__ import annotations

import os

import numpy as np
import torch

# the backbone files' conventional names and the blocks each holds
BACKBONE_FILES = {"darknet53.conv.74": 75, "yolov3-tiny.conv.15": 15}


def cutoff_for(path):
    """The blocks a backbone file holds, by the conventional name in its
    file name, or None (the whole graph)."""
    name = os.path.basename(path)
    return next((n for k, n in BACKBONE_FILES.items() if k in name), None)


def load_darknet_weights(model, params, state, path):
    """Fill a ``models.darknet.Darknet``'s (params, state) from a
    ``.weights`` file. Returns (params, state, header): new lists of new
    dicts, float32 CPU tensors where the file had values, the template's
    own leaves elsewhere; the header as int32 numpy."""
    with open(path, "rb") as fh:
        header = np.fromfile(fh, dtype=np.int32, count=5)
        flat = np.fromfile(fh, dtype=np.float32)

    cutoff = cutoff_for(path)
    params = [dict(p) for p in params]
    state = [dict(s) for s in state]
    ptr = 0

    def take(*shape):
        nonlocal ptr
        n = int(np.prod(shape))
        chunk = flat[ptr:ptr + n].reshape(shape)
        ptr += n
        return torch.from_numpy(chunk.copy())

    for i, info in enumerate(model._plan):
        if cutoff is not None and i == cutoff:
            break
        if info["type"] != "convolutional":
            continue
        c = info["filters"]
        if info["bn"]:
            params[i]["beta"] = take(c)
            params[i]["gamma"] = take(c)
            state[i]["mean"] = take(c)
            state[i]["var"] = take(c)
        else:
            params[i]["b"] = take(c)
        k = info["size"]
        params[i]["w"] = take(c, info["in_ch"], k, k)
    if cutoff is None and ptr != flat.size:
        raise ValueError(
            f"weight file size mismatch: consumed {ptr} of {flat.size} floats"
        )
    return params, state, header


def _f32_bytes(t):
    return t.detach().cpu().float().contiguous().numpy().tobytes()


def save_darknet_weights(model, params, state, path, header=None, cutoff=-1):
    """Write (params, state) as a ``.weights`` file: every convolutional
    block before ``cutoff`` (all with -1), in the file's order."""
    if header is None:
        header = np.zeros(5, np.int32)
    chunks = [np.asarray(header, np.int32).tobytes()]
    plan = model._plan[:cutoff] if cutoff != -1 else model._plan
    for i, info in enumerate(plan):
        if info["type"] != "convolutional":
            continue
        p = params[i]
        if info["bn"]:
            s = state[i]
            for t in (p["beta"], p["gamma"], s["mean"], s["var"]):
                chunks.append(_f32_bytes(t))
        else:
            chunks.append(_f32_bytes(p["b"]))
        chunks.append(_f32_bytes(p["w"]))
    with open(path, "wb") as fh:
        fh.write(b"".join(chunks))
