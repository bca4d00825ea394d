"""Fused stem pair: CUDA kernel K4 and its plain version (port of
``millieye_tpu/ops/stem_pallas.py:fused_stem2_phase`` as the
``pallas_max_s01`` preset runs it: bf16_only="s0s1",
precision="default", float16 output).

    out = maxpool2(leaky(conv3x3(maxpool2(leaky(conv3x3(x, w0) + b0)), w1)
                   + b1))

x [N, H, W, Cin] float32 NHWC -> [N, H/4, W/4, Cout] float16 NHWC, with
the port's OIHW weights w0 [Cmid, Cin, 3, 3], w1 [Cout, Cmid, 3, 3] and
float32 biases. Numerics: the input and w0 are rounded to bf16, products
accumulate in float32; the intermediate stays float32 and is rounded to
bf16 as stage 1's operand, with w1 in bf16; one float16 store at the end.
Source: ``millieye_torch/csrc/stem.cu``.

A CPU tensor takes ``fused_stem_pair_plain``; a CUDA tensor takes the
kernel or raises (outside ``cuda_lib.plain_versions()``).
``fused_stem_pair.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from millieye_torch.ops import cuda_lib


def _leaky(x):
    return torch.where(x > 0, x, 0.1 * x)


def _conv3x3_taps(x, w):
    """3x3 convolution with zero padding 1, summed as the kernel sums it:
    taps in (u, v, c) order, one add at a time into a float32 sum that
    starts at 0. x [N, C, H, W] and w [O, C, 3, 3] hold bf16 values, so
    every product is exact in float32 and the kernel's FMA rounds like
    this add."""
    n, c, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = x.new_zeros((n, w.shape[0], h, wd))
    for u in range(3):
        for v in range(3):
            for ci in range(c):
                acc = acc + (xp[:, ci:ci + 1, u:u + h, v:v + wd]
                             * w[:, ci, u, v][None, :, None, None])
    return acc


def fused_stem_pair_plain(x, w0, b0, w1, b1):
    """K4's arithmetic, operation for operation, in PyTorch: the kernel
    and this function give bit-equal outputs."""
    bf = torch.bfloat16
    y = _conv3x3_taps(x.permute(0, 3, 1, 2).to(bf).float(),
                      w0.to(bf).float()) + b0.float()[:, None, None]
    y = F.max_pool2d(_leaky(y), 2)
    y = _conv3x3_taps(y.to(bf).float(),
                      w1.to(bf).float()) + b1.float()[:, None, None]
    y = F.max_pool2d(_leaky(y), 2)
    return y.permute(0, 2, 3, 1).to(torch.float16).contiguous()


def _lib():
    lib = cuda_lib.library("stem")
    lib.millieye_stem_pair.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
    lib.millieye_stem_pair.restype = ctypes.c_int
    return lib


def fused_stem_pair(x, w0, b0, w1, b1):
    """[N, H, W, Cin] float32 -> [N, H/4, W/4, Cout] float16 (see module)."""
    if cuda_lib.takes_plain(x):
        return fused_stem_pair_plain(x, w0, b0, w1, b1)
    for t in (w0, b0, w1, b1):
        if t.device != x.device:
            raise ValueError(f"fused_stem_pair: x on {x.device}, a weight on "
                             f"{t.device}")
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"fused_stem_pair: want a float32 CUDA input, got "
                        f"{x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_stem_pair: want a contiguous NHWC input")
    n, h, w, cin = x.shape
    cmid, cout = w0.shape[0], w1.shape[0]
    if (w0.shape != (cmid, cin, 3, 3) or w1.shape != (cout, cmid, 3, 3)
            or b0.shape != (cmid,) or b1.shape != (cout,)):
        raise ValueError(f"fused_stem_pair: weights {tuple(w0.shape)}, "
                         f"{tuple(w1.shape)} for {cin} input channels")
    if h % 4 or w % 4 or cmid % 8 or cout % 8 or n == 0:
        raise ValueError(f"fused_stem_pair: need H, W % 4 == 0 and Cmid, "
                         f"Cout % 8 == 0, got {tuple(x.shape)}, {cmid}, "
                         f"{cout}")
    # kernel layouts: HWIO bf16 weights, float32 biases
    w0k = w0.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    w1k = w1.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    b0k, b1k = b0.float().contiguous(), b1.float().contiguous()
    out = torch.empty((n, h // 4, w // 4, cout), dtype=torch.float16,
                      device=x.device)
    lib = _lib()
    rc = lib.millieye_stem_pair(
        cuda_lib.ptr(x), cuda_lib.ptr(w0k), cuda_lib.ptr(b0k),
        cuda_lib.ptr(w1k), cuda_lib.ptr(b1k), cuda_lib.ptr(out),
        n, h, w, cin, cmid, cout, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(lib, rc, "fused_stem_pair")
    fused_stem_pair.launches += 1
    return out


fused_stem_pair.launches = 0
