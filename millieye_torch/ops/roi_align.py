"""Separable RoIAlign and position-sensitive RoIAlign (port of the
batched einsum path of ``millieye_tpu/ops/roi_align.py``).

Numerics are torchvision 0.6's, which the reference pins:

* ``roi_align``: aligned=False (no half-pixel offset), RoI size at
  least 1.0;
* ``ps_roi_align``: a -0.5 half-pixel offset, RoI size at least 0.1;
* adaptive sampling ``ceil(roi_size / bins)`` becomes a masked fixed grid
  of ``sampling_max`` points per axis; taps outside [-1, size) weigh 0
  but count in the average; borders clamp.

Bilinear weights factor into one hat function per axis, so each crop is
two contractions with per-RoI interpolation matrices ``by [B, N, P, H]``
and ``bx [B, N, Q, W]`` (``_batched_prep``); the RoI kernels
(``ops/roi_kernel.py``) take the same matrices.
"""
from __future__ import annotations

import torch


def _bin_samples(start, roi_size, bins, grid_n, smax):
    """Sample positions for one axis: start, roi_size, grid_n [K] ->
    (pos [K, bins, smax], valid [K, bins, smax])."""
    dev = start.device
    bin_sz = (roi_size / bins)[:, None, None]
    b = torch.arange(bins, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.arange(smax, dtype=torch.float32, device=dev)[None, None, :]
    pos = (start[:, None, None] + b * bin_sz
           + (s + 0.5) * bin_sz / grid_n[:, None, None])
    valid = s < grid_n[:, None, None]
    return pos, valid


def _grid_counts(roi_h, roi_w, ph, pw, sampling_ratio, smax):
    if sampling_ratio > 0:
        gh = torch.full_like(roi_h, float(sampling_ratio))
        gw = torch.full_like(roi_w, float(sampling_ratio))
    else:
        gh = torch.ceil(roi_h / ph)
        gw = torch.ceil(roi_w / pw)
    return gh.clamp(1, smax), gw.clamp(1, smax)


def _interp_matrix(start, roi_size, bins, grid_n, smax, size):
    """M [K, bins, size] with sum_h M[k, p, h] F[h] = the tap-averaged
    bilinear sample of bin p along this axis."""
    pos, valid = _bin_samples(start, roi_size, bins, grid_n, smax)
    inside = (pos > -1.0) & (pos < size)
    wv = (valid & inside).float()
    p = pos.clamp(0.0, size - 1)
    p0 = torch.floor(p)
    frac = p - p0
    p0i = p0.long()
    p1i = torch.clamp(p0i + 1, max=size - 1)
    hh = torch.arange(size, device=start.device)
    lo = (p0i[..., None] == hh) * ((1 - frac) * wv)[..., None]
    hi = (p1i[..., None] == hh) * (frac * wv)[..., None]
    return (lo + hi).sum(2) / grid_n[:, None, None]


def _batched_prep(boxes, h, w, bins, spatial_scale, offset, min_size,
                  sampling_ratio, smax):
    """boxes [B, N, 4] xyxy (image coordinates) -> float32 interpolation
    matrices (by [B, N, P, H], bx [B, N, Q, W])."""
    b, n, _ = boxes.shape
    flat = boxes.reshape(b * n, 4).float()
    start_x = flat[:, 0] * spatial_scale + offset
    start_y = flat[:, 1] * spatial_scale + offset
    roi_w = torch.clamp(flat[:, 2] * spatial_scale + offset - start_x,
                        min=min_size)
    roi_h = torch.clamp(flat[:, 3] * spatial_scale + offset - start_y,
                        min=min_size)
    gh, gw = _grid_counts(roi_h, roi_w, bins[0], bins[1], sampling_ratio,
                          smax)
    by = _interp_matrix(start_y, roi_h, bins[0], gh, smax, h)
    bx = _interp_matrix(start_x, roi_w, bins[1], gw, smax, w)
    return by.reshape(b, n, bins[0], h), bx.reshape(b, n, bins[1], w)


def roi_align_batched(features, boxes, output_size=(7, 7),
                      spatial_scale=1.0 / 16, sampling_ratio=-1,
                      sampling_max=4, compute_dtype=None):
    """features [B, H, W, C], boxes [B, N, 4] -> [B, N, ph, pw, C].
    ``compute_dtype`` rounds the operands and each contraction's result;
    products accumulate in float32."""
    _, h, w, _ = features.shape
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, 0.0,
                           1.0, sampling_ratio, sampling_max)
    cd = compute_dtype or features.dtype
    by, bx = by.to(cd).float(), bx.to(cd).float()
    t = torch.einsum("bnph,bhwc->bnpwc", by, features.to(cd).float())
    t = t.to(cd).float()
    return torch.einsum("bnqw,bnpwc->bnpqc", bx, t).to(cd)


def ps_roi_align_batched(features, boxes, output_size=(7, 7),
                         spatial_scale=1.0 / 16, sampling_ratio=-1,
                         sampling_max=4, compute_dtype=None):
    """Position-sensitive variant: features [B, H, W, C_out*ph*pw] in
    torch's C_out-major bin layout, boxes [B, N, 4] -> [B, N, ph, pw,
    C_out]."""
    b, h, w, c_in = features.shape
    ph, pw = output_size
    c_out = c_in // (ph * pw)
    if c_out * ph * pw != c_in:
        raise ValueError(f"{c_in} channels do not factor as C_out*{ph}*{pw}")
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, -0.5,
                           0.1, sampling_ratio, sampling_max)
    cd = compute_dtype or features.dtype
    by, bx = by.to(cd).float(), bx.to(cd).float()
    fv = features.to(cd).float().reshape(b, h, w, c_out, ph, pw)
    t = torch.einsum("bnph,bhwupq->bnpqwu", by, fv).to(cd).float()
    return torch.einsum("bnqw,bnpqwu->bnpqu", bx, t).to(cd)
