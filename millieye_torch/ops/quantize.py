"""Int8 serving quantization (port of ``millieye_tpu/ops/quantize.py``):
the deterministic per-channel weight quantizer, the int8 x int8 -> int32
convolution of the int8-activation path, calibration of the activation
scales, and the stochastic-rounding kernel K13.

* ``quantize_int8`` / ``dequantize``: per-output-channel absmax scaling
  with round-to-nearest-even, on OIHW weights (channel axis 0, scales
  ``[O, 1, 1, 1]``); ``quantize_darknet`` / ``dequantize_darknet`` apply
  it to the ``w`` and ``w2`` (space-to-depth) slots of a BN-folded
  Darknet, with an input scale ``xs`` per convolution when calibrated
  activation maxima are given.
* ``int8_conv2d``: the exact int32 convolution of int8 operands. The JAX
  package leaves it to XLA (``lax.conv_general_dilated`` with an int32
  result); here it is a patch matrix times the weight matrix through
  ``torch._int_mm`` (int8 tensor cores on the card). A float32
  convolution of the integer values would not be exact: a 3x3 conv over
  more than 115 input channels can sum past 2^24.
* K13 ``quantize_int8_stochastic`` (port of the Pallas kernel of the same
  name): a per-tensor absmax scale and unbiased stochastic rounding,
  ``q = clip(floor(w / scale + u), -127, 127)``, ``u`` uniform in [0, 1)
  from 24 random bits. The TPU drew the bits from its on-chip PRNG,
  seeded ``seed + tile`` per row tile; the card cannot give those bits,
  so kernel and plain version draw them from Philox4x32-10 keyed by
  ``(seed + tile, 0)``, one counter per four consecutive elements of the
  tile (``element index // 4``, word ``element index % 4``). The scale
  is the JAX wrapper's as XLA compiles it (``_INV_127``). On the card the
  whole function is hand-written: an absmax pass, then the scale and the
  rounding, two launches. Source: ``millieye_torch/csrc/quantize.cu``.

A CPU tensor takes K13's plain version; a CUDA tensor takes the kernel or
raises (outside ``cuda_lib.plain_versions()``).
``quantize_int8_stochastic.launches`` counts kernel launches; the
wrapper calls the custom op ``millieye::quantize_stochastic``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from millieye_torch.ops import cuda_lib

_MASK = 0xFFFFFFFF
# Philox4x32-10 (Salmon et al., SC'11; the Random123 constants)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def quantize_int8(w, axis=0):
    """w -> (int8 values, float32 scales broadcastable along ``axis``),
    scale = max(absmax, 1e-8) / 127 per slice of ``axis``."""
    dims = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    absmax = w.abs().amax(dim=dims, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q, scale, dtype=torch.float32):
    return q.to(dtype) * scale.to(dtype)


def quantize_darknet(folded_params, act_absmax=None, act_skip=()):
    """Post-training int8 for a BN-folded Darknet: each OIHW ``w`` (or
    space-to-depth ``w2``) becomes ``q`` (``q2``) with per-output-channel
    ``scale``; biases stay float. With ``act_absmax`` (from
    ``calibrate_act_scales``) every convolution not in ``act_skip`` also
    gets ``xs = max(absmax, 1e-8) / 127``, its input scale: ``Darknet.apply``
    then runs it as int8 x int8 -> int32."""
    out = []
    for i, p in enumerate(folded_params):
        key = next((k for k in ("w", "w2") if k in p and p[k].dim() == 4),
                   None)
        if key is None:
            out.append(p)
            continue
        q, scale = quantize_int8(p[key])
        d = {"q" if key == "w" else "q2": q, "scale": scale, "b": p["b"]}
        if act_absmax is not None and i not in act_skip:
            d["xs"] = torch.as_tensor(
                act_absmax[i], dtype=torch.float32,
                device=q.device).clamp_min(1e-8) / 127.0
        out.append(d)
    return out


def dequantize_darknet(qparams, dtype=torch.float32):
    out = []
    for p in qparams:
        key = next((k for k in ("q", "q2") if k in p), None)
        if key is None:
            out.append(p)
            continue
        out.append({"w" if key == "q" else "w2":
                    dequantize(p[key], p["scale"], dtype), "b": p["b"]})
    return out


@torch.no_grad()
def calibrate_act_scales(darknet, folded_params, folded_state, batches,
                         compute_dtype=torch.float32):
    """Per-conv input absmax over calibration batches: the elementwise
    maximum over ``batches`` of ``Darknet.apply(collect_act_stats=True)``,
    a float32 numpy array aligned with the block plan (feed it to
    ``quantize_darknet(act_absmax=...)``). Run it on the graph that will
    serve (``fold_s2d`` first where the model has s2d stages)."""
    mx = None
    for images in batches:
        s = darknet.apply(folded_params, folded_state, images,
                          compute_dtype=compute_dtype,
                          collect_act_stats=True)["act_absmax"]
        s = s.cpu().numpy()
        mx = s if mx is None else np.maximum(mx, s)
    return mx


# ------------------------------------------------- the int8 convolution
def _ceil_to(n, m):
    return -(-n // m) * m


def int8_conv2d(zq, q, stride=1, pad=0):
    """Exact int32 convolution of int8 operands: zq [N, C, H, W], q [O, C,
    k, k] -> [N, O, Ho, Wo] int32. The patch matrix is built from the k*k
    shifted slices of the zero-padded input, tap-major ((u, v), then c);
    K and O are padded with zeros to multiples of 8 and M to at least 17,
    as ``torch._int_mm`` on the card requires, and the weight matrix is
    handed over column-major."""
    if zq.dtype != torch.int8 or q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d: want int8 operands, got {zq.dtype}, "
                        f"{q.dtype}")
    n, c, h, w = zq.shape
    o, _, k, _ = q.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    xp = F.pad(zq, (pad, pad, pad, pad)).permute(0, 2, 3, 1)
    taps = [xp[:, u:u + stride * (ho - 1) + 1:stride,
               v:v + stride * (wo - 1) + 1:stride]
            for u in range(k) for v in range(k)]
    a = torch.cat(taps, -1).reshape(n * ho * wo, k * k * c)
    bt = q.permute(0, 2, 3, 1).reshape(o, k * k * c)      # [O, K]
    m, kk = a.shape
    mp, kp, op = max(m, 17), _ceil_to(kk, 8), _ceil_to(o, 8)
    if (mp, kp) != (m, kk):
        a = F.pad(a, (0, kp - kk, 0, mp - m))
    if (op, kp) != (o, kk):
        bt = F.pad(bt, (0, kp - kk, 0, op - o))
    y = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return y[:m, :o].reshape(n, ho, wo, o).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ K13
def _mulhilo(m, c):
    """(high, low) 32-bit words of the 64-bit product of the constant ``m``
    and the uint32 values ``c`` (int64), in 16-bit limbs so that no
    intermediate leaves int64."""
    a = m * (c & 0xFFFF)                   # < 2^48
    b = m * (c >> 16)                      # < 2^48
    lo = (a + ((b & 0xFFFF) << 16)) & _MASK
    hi = (((a >> 16) + b) >> 16) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on uint32 words held in int64 tensors (broadcasting);
    returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK
            k1 = (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def stochastic_bits(seed, tiles, tile_elems, device="cpu"):
    """The random words of K13: [tiles, tile_elems] uint32 values in int64,
    element j of tile t being word j % 4 of Philox4x32-10 at counter
    (j // 4, 0, 0, 0) under key ((seed + t) mod 2^32, 0)."""
    groups = -(-tile_elems // 4)
    ctr = torch.arange(groups, dtype=torch.int64, device=device)[None]
    key = (seed + torch.arange(tiles, dtype=torch.int64,
                               device=device)[:, None]) & _MASK
    zero = torch.zeros_like(ctr)
    words = philox4x32(ctr, zero, zero, zero, key, torch.zeros_like(key))
    bits = torch.stack(torch.broadcast_tensors(*words), -1)
    return bits.reshape(tiles, 4 * groups)[:, :tile_elems]


def stochastic_round(scaled, bits):
    """q = clip(floor(scaled + u), -127, 127) as int8, u = (bits >> 8) *
    2^-24 (exact in float32)."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.floor(scaled + u).clamp(-127, 127).to(torch.int8)


# the JAX wrapper's ``max(absmax, 1e-8) / 127.0`` as XLA compiles it: a
# product with the float32 reciprocal of 127 (an IEEE division differs by
# an ulp on about 4% of maxima, all-zero tensors among them)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _stochastic_scale(w2d):
    return w2d.abs().amax().clamp_min(1e-8) * _INV_127


def _check_stochastic(w2d, seed, row_tile):
    if w2d.dim() != 2 or w2d.shape[0] == 0 or w2d.shape[1] == 0:
        raise ValueError(f"quantize_int8_stochastic: want a non-empty 2-D "
                         f"tensor, got {tuple(w2d.shape)}")
    if row_tile < 1:
        raise ValueError(f"quantize_int8_stochastic: row_tile {row_tile}")
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"quantize_int8_stochastic: seed {seed} is not an "
                         f"int32")


def quantize_int8_stochastic_plain(w2d, seed, row_tile=512):
    """K13's arithmetic in PyTorch: the scale, then per row tile (the last
    padded with zero rows, as the JAX wrapper pads) ``w / scale``, its
    Philox words and the rounding; bit-equal to the kernel."""
    _check_stochastic(w2d, seed, row_tile)
    w2d = w2d.float()
    m, n = w2d.shape
    scale = _stochastic_scale(w2d)
    tile = min(row_tile, m)
    padded = F.pad(w2d, (0, 0, 0, (-m) % tile))
    tiles = padded.shape[0] // tile
    bits = stochastic_bits(seed, tiles, tile * n, w2d.device)
    q = stochastic_round(padded / scale, bits.reshape(padded.shape))
    return q[:m], scale


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.library("quantize")
        lib.millieye_quantize_stochastic.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.millieye_quantize_stochastic.restype = ctypes.c_int
        lib.millieye_quantize_parts.restype = ctypes.c_int
        _LIB = lib, lib.millieye_quantize_parts()
    return _LIB


def quantize_int8_stochastic(w2d, seed, row_tile=512):
    """K13: w2d [M, N] float -> (int8 values [M, N], float32 scale []) with
    a per-tensor scale and unbiased stochastic rounding (see module). On
    the card the scale and the rounding are two hand-written launches,
    counted as one; no PyTorch operation runs but the allocations (and a
    cast of a non-float32 or non-contiguous input)."""
    _check_stochastic(w2d, seed, row_tile)
    return _stochastic_op(w2d, int(seed), int(row_tile))


def _launch_stochastic(w2d, seed, row_tile):
    w2d = w2d.float().contiguous()
    m, n = w2d.shape
    lib, parts = _lib()
    dev = w2d.device
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(parts, dtype=torch.int32, device=dev)
    rc = lib.millieye_quantize_stochastic(
        cuda_lib.ptr(w2d), cuda_lib.ptr(scale), cuda_lib.ptr(out),
        cuda_lib.ptr(scratch), m, n, min(row_tile, m), seed,
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(lib, rc, "quantize_int8_stochastic")
    return out, scale


def _fake_stochastic(w2d, seed, row_tile):
    return (w2d.new_empty(w2d.shape, dtype=torch.int8),
            w2d.new_empty((), dtype=torch.float32))


quantize_int8_stochastic.launches = 0
_stochastic_op = cuda_lib.kernel_op(
    "quantize_stochastic", "(Tensor w2d, int seed, int row_tile) -> "
    "(Tensor, Tensor)", quantize_int8_stochastic_plain, _launch_stochastic,
    _fake_stochastic, quantize_int8_stochastic)
