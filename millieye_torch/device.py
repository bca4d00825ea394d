"""Device selection and numerics for the port's entry points."""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.weak import WeakIdKeyDictionary

# per_tensor's results: {tensor: {fn: (tensor's version, result)}}
_PER_TENSOR = WeakIdKeyDictionary()


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


def per_tensor(t, fn):
    """``fn(t)``, made once per tensor ``t`` and kept while ``t`` lives
    (made again after an in-place change to it): what an inference step
    would otherwise recompute from the same weights each call. It is
    made outside any active dispatch mode, so a first call under a tracer
    caches a real tensor, which the trace takes as a constant; and
    outside inference mode and without grad, so a result made in an
    evaluation step serves any later step. A tracer's fake tensor, an
    inference tensor (it has no version counter to tell a change by) and
    a tensor that wants a gradient here take ``fn(t)`` at each call."""
    if (isinstance(t, FakeTensor) or t.is_inference()
            or (t.requires_grad and torch.is_grad_enabled())):
        return fn(t)
    made = _PER_TENSOR.get(t)
    hit = None if made is None else made.get(fn)
    if hit is not None and hit[0] == t._version:
        return hit[1]
    with _disable_current_modes(), torch.inference_mode(False), \
            torch.no_grad():
        out = fn(t)
    if made is None:
        made = _PER_TENSOR[t] = {}
    made[fn] = (t._version, out)
    return out


def set_numerics():
    """Full float32 in convolutions and matrix products: cuDNN would run
    float32 convolutions in TF32 by default, which silently changes the
    float32 preset and the float32 stem stages."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
