"""Fused stem kernels: the two-stage pair K4 and the single stage K9,
each with its plain version.

K9 ``fused_stem_stage`` (port of
``millieye_tpu/ops/stem_pallas.py:fused_stem_planar``):

    out = maxpool2(leaky(conv3x3(x, w) + b))

x [N, H, W, Cin] float32 NHWC -> [N, H/2, W/2, Cout] NHWC in
``out_dtype`` (float32, bfloat16 or float16), w [Cout, Cin, 3, 3] OIHW.
``precision="default"`` rounds x and w to bf16 and accumulates the
products in float32; ``"highest"`` is float32 throughout; bias, leaky
and the pool follow in float32, then one rounding to ``out_dtype``.

K4 ``fused_stem_pair`` (port of
``millieye_tpu/ops/stem_pallas.py:fused_stem2_phase`` as the
``pallas_max_s01`` preset runs it: bf16_only="s0s1",
precision="default", float16 output; the variant ``phase`` with float32
scratches differs from it only in buffering on the TPU and is the same
function):

    out = maxpool2(leaky(conv3x3(maxpool2(leaky(conv3x3(x, w0) + b0)), w1)
                   + b1))

x [N, H, W, Cin] float32 NHWC -> [N, H/4, W/4, Cout] float16 NHWC, with
the port's OIHW weights w0 [Cmid, Cin, 3, 3], w1 [Cout, Cmid, 3, 3] and
float32 biases. Numerics: the input and w0 are rounded to bf16, products
accumulate in float32; the intermediate stays float32 and is rounded to
bf16 as stage 1's operand, with w1 in bf16; one float16 store at the end.
Source: ``millieye_torch/csrc/stem.cu``.

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
raises (outside ``cuda_lib.plain_versions()``). ``<wrapper>.launches``
counts kernel launches.
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


_STORE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_stem_stage_plain(x, w, b, precision="default",
                           out_dtype=torch.float32):
    """K9's arithmetic, operation for operation, in PyTorch: taps summed
    in (c, u, v) order, c slowest, one multiply and one add at a time
    into a float32 sum that starts at 0 (at "default" the operands hold
    bf16 values, so each product is exact and the kernel's FMA rounds
    like this add)."""
    xc, wc = x.permute(0, 3, 1, 2).float(), w.float()
    if precision == "default":
        xc, wc = xc.to(torch.bfloat16).float(), wc.to(torch.bfloat16).float()
    n, c, h, wd = xc.shape
    xp = F.pad(xc, (1, 1, 1, 1))
    acc = xc.new_zeros((n, w.shape[0], h, wd))
    for ci in range(c):
        for u in range(3):
            for v in range(3):
                acc = acc + (xp[:, ci:ci + 1, u:u + h, v:v + wd]
                             * wc[:, ci, u, v][None, :, None, None])
    y = F.max_pool2d(_leaky(acc + b.float()[:, None, None]), 2)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def _lib():
    lib = cuda_lib.library("stem")
    lib.millieye_stem_pair.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
    lib.millieye_stem_pair.restype = ctypes.c_int
    lib.millieye_stem_stage.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.millieye_stem_stage.restype = ctypes.c_int
    return lib


def fused_stem_stage(x, w, b, precision="default", out_dtype=torch.float32):
    """K9: [N, H, W, Cin] float32 -> [N, H/2, W/2, Cout] ``out_dtype``
    (see module)."""
    if precision not in ("default", "highest"):
        raise ValueError(f"fused_stem_stage: unknown precision {precision!r}")
    if out_dtype not in _STORE_CODES:
        raise TypeError(f"fused_stem_stage: cannot store {out_dtype}")
    if cuda_lib.takes_plain(x):
        return fused_stem_stage_plain(x, w, b, precision, out_dtype)
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"fused_stem_stage: x on {x.device}, weights on "
                         f"{w.device}, {b.device}")
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"fused_stem_stage: want a float32 CUDA input, got "
                        f"{x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_stem_stage: want a contiguous NHWC input")
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3) or b.shape != (cout,):
        raise ValueError(f"fused_stem_stage: weights {tuple(w.shape)}, "
                         f"{tuple(b.shape)} for {cin} input channels")
    if h % 2 or wd % 2 or cout % 8 or n == 0:
        raise ValueError(f"fused_stem_stage: need even H, W and Cout % 8 == "
                         f"0, got {tuple(x.shape)}, {cout}")
    # kernel layout: [cin, 3, 3, cout] float32; at "default" the kernel
    # rounds x and w to bf16 as it loads them
    wk = w.float().permute(1, 2, 3, 0).contiguous()
    bk = b.float().contiguous()
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=out_dtype,
                      device=x.device)
    lib = _lib()
    rc = lib.millieye_stem_stage(
        cuda_lib.ptr(x), cuda_lib.ptr(wk), cuda_lib.ptr(bk),
        cuda_lib.ptr(out), n, h, wd, cin, cout, int(precision == "highest"),
        _STORE_CODES[out_dtype], cuda_lib.stream_ptr(x.device))
    cuda_lib.check(lib, rc, "fused_stem_stage")
    fused_stem_stage.launches += 1
    return out


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
fused_stem_stage.launches = 0
