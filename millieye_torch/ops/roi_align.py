"""RoIAlign and position-sensitive RoIAlign (port of
``millieye_tpu/ops/roi_align.py``): the batched einsum path the networks
run, and the per-RoI API over ``rois [K, 5]`` rows of (batch index, x1,
y1, x2, y2) on NHWC features, as the separable einsum or the direct
bilinear-tap gather (the golden reference).

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


def _bilinear_terms(y, x, h, w):
    """Corner indices and weights of the bilinear taps at (y, x); a tap
    outside [-1, size) weighs 0."""
    inside = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y = y.clamp(0.0, h - 1)
    x = x.clamp(0.0, w - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly, lx = y - y0, x - x0
    weights = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx,
                           ly * (1 - lx), ly * lx], -1) * inside[..., None]
    ys = torch.stack([y0, y0, y1, y1], -1).long()
    xs = torch.stack([x0, x1, x0, x1], -1).long()
    return ys, xs, weights


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


def _per_image(batch, n, out_of):
    """Sum ``out_of(b)`` over the images b < n, each kept on the RoIs of
    image b only."""
    out = None
    for b in range(n):
        o = out_of(b)
        sel = (batch == b)[:, None, None, None]
        o = torch.where(sel, o, torch.zeros((), dtype=o.dtype,
                                            device=o.device))
        out = o if out is None else out + o
    return out


def _roi_geometry(xyxy, spatial_scale, offset, min_size):
    """(start_x, start_y, roi_w, roi_h) [K] of float32 boxes [K, 4] in
    image coordinates, on the feature map."""
    start_x = xyxy[:, 0] * spatial_scale + offset
    start_y = xyxy[:, 1] * spatial_scale + offset
    roi_w = torch.clamp(xyxy[:, 2] * spatial_scale + offset - start_x,
                        min=min_size)
    roi_h = torch.clamp(xyxy[:, 3] * spatial_scale + offset - start_y,
                        min=min_size)
    return start_x, start_y, roi_w, roi_h


def _roi_start(rois, spatial_scale, offset, min_size):
    """(batch [K], start_x, start_y, roi_w, roi_h) of ``rois [K, 5]``."""
    rois = rois.float()
    return (rois[:, 0].long(),
            *_roi_geometry(rois[:, 1:], spatial_scale, offset, min_size))


def roi_align(features, rois, output_size=(7, 7), spatial_scale=1.0 / 16,
              sampling_ratio=-1, sampling_max=4, method="einsum"):
    """features [N, H, W, C]; rois [K, 5] -> [K, ph, pw, C] float32.
    ``method="einsum"``: two contractions with the interpolation
    matrices; ``"gather"``: the bilinear taps gathered directly."""
    if method != "einsum":
        return _roi_align_gather(features, rois, output_size, spatial_scale,
                                 sampling_ratio, sampling_max)
    n, h, w, _ = features.shape
    ph, pw = output_size
    batch, start_x, start_y, roi_w, roi_h = _roi_start(rois, spatial_scale,
                                                       0.0, 1.0)
    gh, gw = _grid_counts(roi_h, roi_w, ph, pw, sampling_ratio, sampling_max)
    by = _interp_matrix(start_y, roi_h, ph, gh, sampling_max, h)
    bx = _interp_matrix(start_x, roi_w, pw, gw, sampling_max, w)
    f = features.float()

    def one(b):
        t = torch.einsum("kph,hwc->kpwc", by, f[b])
        return torch.einsum("kqw,kpwc->kpqc", bx, t)

    return _per_image(batch, n, one)


def _tap_lattice(start_y, start_x, roi_h, roi_w, ph, pw, sampling_ratio,
                 smax, h, w):
    """The bilinear taps of every (bin_y, bin_x, sample_y, sample_x):
    (ys, xs, weights [K, ph, pw, smax, smax, 4], samples per bin [K])."""
    k = start_y.shape[0]
    gh, gw = _grid_counts(roi_h, roi_w, ph, pw, sampling_ratio, smax)
    ypos, yval = _bin_samples(start_y, roi_h, ph, gh, smax)
    xpos, xval = _bin_samples(start_x, roi_w, pw, gw, smax)
    shape = (k, ph, pw, smax, smax)
    y = ypos[:, :, None, :, None].expand(shape)
    x = xpos[:, None, :, None, :].expand(shape)
    samp_valid = (yval[:, :, None, :, None]
                  & xval[:, None, :, None, :]).expand(shape)
    ys, xs, wts = _bilinear_terms(y, x, h, w)
    return ys, xs, wts * samp_valid[..., None], gh * gw


def _roi_align_gather(features, rois, output_size=(7, 7),
                      spatial_scale=1.0 / 16, sampling_ratio=-1,
                      sampling_max=4):
    """features [N, H, W, C]; rois [K, 5] -> [K, ph, pw, C]."""
    n, h, w, c = features.shape
    k = rois.shape[0]
    ph, pw = output_size
    batch, start_x, start_y, roi_w, roi_h = _roi_start(rois, spatial_scale,
                                                       0.0, 1.0)
    ys, xs, wts, count = _tap_lattice(start_y, start_x, roi_h, roi_w, ph, pw,
                                      sampling_ratio, sampling_max, h, w)
    flat = features.float().reshape(n * h * w, c)
    idx = batch.reshape(k, 1, 1, 1, 1, 1) * (h * w) + ys * w + xs
    vals = flat[idx.reshape(-1)].reshape(*idx.shape, c)
    acc = (vals * wts[..., None]).sum(dim=(-2, -3, -4))
    return acc / count[:, None, None, None]


def ps_roi_align(features, rois, output_size=(7, 7), spatial_scale=1.0 / 16,
                 sampling_ratio=-1, sampling_max=4, method="einsum"):
    """Position-sensitive RoIAlign: features [N, H, W, C_out*ph*pw] in
    torch's C_out-major bin layout ((c_out*ph + by)*pw + bx); rois [K, 5]
    -> [K, ph, pw, C_out] float32. ``method`` as in ``roi_align``."""
    if method == "einsum":
        return _ps_roi_align_einsum(features, rois, output_size,
                                    spatial_scale, sampling_ratio,
                                    sampling_max)
    return _ps_roi_align_gather(features, rois, output_size, spatial_scale,
                                sampling_ratio, sampling_max)


def _c_out(c_in, ph, pw):
    c_out = c_in // (ph * pw)
    if c_out * ph * pw != c_in:
        raise ValueError(f"{c_in} channels do not factor as C_out*{ph}*{pw}")
    return c_out


def _ps_roi_align_einsum(features, rois, output_size, spatial_scale,
                         sampling_ratio, sampling_max):
    n, h, w, c_in = features.shape
    ph, pw = output_size
    c_out = _c_out(c_in, ph, pw)
    batch, start_x, start_y, roi_w, roi_h = _roi_start(rois, spatial_scale,
                                                       -0.5, 0.1)
    gh, gw = _grid_counts(roi_h, roi_w, ph, pw, sampling_ratio, sampling_max)
    by = _interp_matrix(start_y, roi_h, ph, gh, sampling_max, h)
    bx = _interp_matrix(start_x, roi_w, pw, gw, sampling_max, w)
    fv = features.float().reshape(n, h, w, c_out, ph, pw)

    def one(b):
        # the bin indices p, q are shared: each bin reads its own block
        t = torch.einsum("kph,hwupq->kpqwu", by, fv[b])
        return torch.einsum("kqw,kpqwu->kpqu", bx, t)

    return _per_image(batch, n, one)


def _ps_roi_align_gather(features, rois, output_size=(7, 7),
                         spatial_scale=1.0 / 16, sampling_ratio=-1,
                         sampling_max=4):
    """The gather formulation of ``ps_roi_align``."""
    n, h, w, c_in = features.shape
    k = rois.shape[0]
    ph, pw = output_size
    bins = ph * pw
    c_out = _c_out(c_in, ph, pw)
    batch, start_x, start_y, roi_w, roi_h = _roi_start(rois, spatial_scale,
                                                       -0.5, 0.1)
    ys, xs, wts, count = _tap_lattice(start_y, start_x, roi_h, roi_w, ph, pw,
                                      sampling_ratio, sampling_max, h, w)
    # bins last: row ((b*H + y)*W + x)*bins + bin holds that tap's C_out
    fm = features.float().reshape(n, h, w, c_out, bins).permute(0, 1, 2, 4, 3)
    flat = fm.reshape(n * h * w * bins, c_out)
    dev = features.device
    bin_idx = (torch.arange(ph, device=dev)[:, None] * pw
               + torch.arange(pw, device=dev)[None, :])
    bin_idx = bin_idx[None, :, :, None, None, None].expand(ys.shape)
    idx = (((batch.reshape(k, 1, 1, 1, 1, 1) * h + ys) * w + xs) * bins
           + bin_idx)
    vals = flat[idx.reshape(-1)].reshape(*idx.shape, c_out)
    acc = (vals * wts[..., None]).sum(dim=(-2, -3, -4))
    return acc / count[:, None, None, None]


def _batched_prep(boxes, h, w, bins, spatial_scale, offset, min_size,
                  sampling_ratio, smax):
    """boxes [B, N, 4] xyxy (image coordinates) -> float32 interpolation
    matrices (by [B, N, P, H], bx [B, N, Q, W])."""
    b, n, _ = boxes.shape
    start_x, start_y, roi_w, roi_h = _roi_geometry(
        boxes.reshape(b * n, 4).float(), spatial_scale, offset, min_size)
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
    c_out = _c_out(c_in, ph, pw)
    by, bx = _batched_prep(boxes, h, w, output_size, spatial_scale, -0.5,
                           0.1, sampling_ratio, sampling_max)
    cd = compute_dtype or features.dtype
    by, bx = by.to(cd).float(), bx.to(cd).float()
    fv = features.to(cd).float().reshape(b, h, w, c_out, ph, pw)
    t = torch.einsum("bnph,bhwupq->bnpqwu", by, fv).to(cd).float()
    return torch.einsum("bnqw,bnpqwu->bnpqu", bx, t).to(cd)
