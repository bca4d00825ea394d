"""The JAX package's checkpoint file read on its own terms: one array per
leaf under ``"{i:05d}|{params|state}/{key/path}"``, convolution kernels
HWIO. ``read_npz`` returns (params, state) as nested dicts keyed by the
path's parts (list indices as strings), float32 tensors on ``device``,
kernels turned OIHW."""
from __future__ import annotations

import numpy as np
import torch


def read_npz(path, device="cpu"):
    trees = {"params": {}, "state": {}}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            root, *parts = key.split("|", 1)[1].split("/")
            a = torch.from_numpy(np.asarray(z[key], np.float32))
            if a.dim() == 4:
                a = a.permute(3, 2, 0, 1)
            node = trees[root]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a.contiguous().to(device)
    return trees["params"], trees["state"]
