"""Device selection and numerics for the port's entry points."""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes


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


@functools.lru_cache(maxsize=None)
def constant(values, device, dtype=torch.float32):
    """``torch.tensor(values)`` on ``device``, made once for each (values,
    device): inside a step, a copy from pageable host memory would make
    the host wait for the card's stream. It is made outside any active
    dispatch mode, so a first call under a tracer (``torch.export``'s fake
    tensors) caches a real tensor, which the trace takes as a constant;
    and outside inference mode, so a first call in an evaluation's step
    caches a tensor that a later training step can save for backward."""
    with _disable_current_modes(), torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def set_numerics():
    """Full float32 in convolutions and matrix products: cuDNN would run
    float32 convolutions in TF32 by default, which silently changes the
    float32 preset and the float32 stem stages."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
