"""Operand rounding: the reference computes in float32, and its control
rounds every product's operands to the precision one step below the one
the configuration states for that part (the rounding ladder: TF32 for
float32 with TF32 off, fp8 for bfloat16 and float16), then accumulates
in float32. The rounding is done here, elementwise, so the control
reads the same on every device."""
from __future__ import annotations

import torch

FP8_MAX = 448.0          # the largest float8_e4m3fn


def tf32(x):
    """Round float32 to TF32's 10 explicit mantissa bits, to nearest
    even, as a tensor core reads its operands."""
    x = x.float().contiguous()
    i = x.view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    out = ((i + bias) & ~0x1FFF).view(torch.float32)
    # inf and NaN pass through unchanged
    return torch.where(torch.isfinite(x), out, x)


def bf16(x):
    return x.to(torch.bfloat16).float()


def fp8(x):
    """float8_e4m3fn with one scale for the tensor (its absmax onto the
    format's largest value), as fp8 inference scales a tensor."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"float32": lambda x: x.float(), "tf32": tf32, "bfloat16": bf16,
         "fp8": fp8}

# one step down the ladder, for each precision a configuration states
BELOW = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}


class Precision:
    """Which rounding each part of a model's products takes: ``parts``
    maps a part's name ("backbone", "stem", "heads", "maps") to a key of
    ``ROUND``; parts not named stay float32."""

    def __init__(self, parts=None):
        self.parts = dict(parts or {})

    def __call__(self, x, part):
        return ROUND[self.parts.get(part, "float32")](x)

    @classmethod
    def control(cls, stated):
        """The control of a configuration whose parts compute in
        ``stated`` ({part: "float32" | "bfloat16" | ...})."""
        return cls({p: BELOW[d] for p, d in stated.items()})


REFERENCE = Precision()
