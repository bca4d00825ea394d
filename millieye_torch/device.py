"""Device selection and numerics for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point. The default is the card; a
    caller that wants the CPU (the tests) says so. There is no silent
    fallback: asking for CUDA on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "millieye_torch: CUDA was requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain versions on the"
            " CPU")
    return dev


def set_numerics():
    """Full float32 in convolutions and matrix products: cuDNN would run
    float32 convolutions in TF32 by default, which silently changes the
    float32 preset and the float32 stem stages."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
