"""Plain milliEye fusion detector (module3) in float32, over every
candidate: the tiny-YOLOv3 Darknet and its decode (``darknet.py``), then
for each decoded anchor and each radar proposal the row the fusion heads
would give it if it were kept: the 490-channel score map, the radar
encoder, position-sensitive RoIAlign and RoIAlign (torchvision 0.6's
numerics, as the direct bilinear taps), the refinement head with the
radar confidence, the ensemble head and the box regression. Each of
those is a function of its own row alone, so the heads' row for a kept
detection is its anchor's row here whatever NMS keeps; ``fusion_scene``
also gives the rows the reference's own NMS (``nms.py``) keeps.

Also the radar heatmap from the raw points (``radar_maps``), and the
letterbox resize of the host collate (``resize_nearest``).

Parameters: the JAX package's ``.npz`` tree (``weights.read_npz``):
``darknet``, ``img_cnn``, ``radar_enc``, ``refine``, ``ensemble``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import darknet, nms
from perfbench.reference.precision import REFERENCE

BN_EPS = 1e-5
RANGES = ((0.0, 5.0), (12.0, 0.0), (0.0, 4.0))   # count, depth, |speed|


def resize_nearest(img, size):
    """[H, W, C] numpy -> [size, size, C]: source index floor(dst * in /
    out), as the collate resizes."""
    iy = (np.arange(size) * (img.shape[0] / size)).astype(int)
    ix = (np.arange(size) * (img.shape[1] / size)).astype(int)
    return img[np.ix_(iy, ix)]


def radar_maps(points, frame_size, img_size, prec=REFERENCE, map_size=32):
    """Raw points [P, 4] (u, v, z, V) of one frame (numpy) -> the radar
    heatmap [img_size/16, img_size/16, 3] on the frame's padded square:
    per bin the point count, mean depth (none or below 1 m -> 100) and
    |mean speed|, each scaled by ``RANGES`` into [0, 1]; the bins (image
    / (max side / 32)) padded to a square and resized bilinearly with
    aligned corners. Sums in float64."""
    w, h = frame_size
    scale = max(frame_size) / map_size
    bw, bh = int(round(w / scale)), int(round(h / scale))
    p = prec(torch.as_tensor(np.asarray(points), dtype=torch.float32)
             .reshape(-1, 4), "maps").double()
    u, v, z, vel = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    inside = (u >= 0) & (u <= w) & (v >= 0) & (v <= h)
    bx = (u / w * bw).long().clamp(0, bw - 1)
    by = (v / h * bh).long().clamp(0, bh - 1)
    idx = (by * bw + bx)[inside]
    sums = torch.zeros(3, bh * bw, dtype=torch.float64)
    vals = torch.stack([torch.ones_like(z), z, vel])[:, inside]
    sums.index_add_(1, idx, vals)
    cnt, zs, vs = sums.reshape(3, bh, bw)
    depth = zs / (cnt + 1e-6)
    depth = torch.where(depth < 1, torch.full_like(depth, 100.0), depth)
    maps = torch.stack([cnt, depth, (vs / (cnt + 1e-6)).abs()])
    lo = torch.tensor([r[0] for r in RANGES], dtype=torch.float64)
    hi = torch.tensor([r[1] for r in RANGES], dtype=torch.float64)
    maps = ((maps - lo[:, None, None]) / (hi - lo)[:, None, None]).clamp(0, 1)
    d = abs(bh - bw)
    pad = ((0, 0, d // 2, d - d // 2) if bh <= bw
           else (d // 2, d - d // 2, 0, 0))
    maps = F.pad(maps, pad)
    out = F.interpolate(maps[None], size=(img_size // 16,) * 2,
                        mode="bilinear", align_corners=True)[0]
    return prec(out.permute(1, 2, 0).float(), "maps")


def _bn(x, p, s):
    """Eval-mode batch norm over the last axis."""
    return (x - s["mean"]) / torch.sqrt(s["var"] + BN_EPS) * p["gamma"] \
        + p["beta"]


def _conv(x, w, padding, prec, part):
    """NHWC x, OIHW w -> NHWC."""
    y = F.conv2d(prec(x, part).permute(0, 3, 1, 2), prec(w, part),
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def _linear(x, p, prec, part):
    return prec(x, part) @ prec(p["w"], part) + p["b"]


def score_map(P, S, feature, prec):
    """The 1x1 conv + BN + leaky stack on the stride-16 feature map."""
    x = feature
    for key in sorted(P["img_cnn"], key=int):
        p, s = P["img_cnn"][key], S["img_cnn"][key]
        x = darknet.leaky(_bn(_conv(x, p["w"], 0, prec, "heads") + p["b"],
                              p["bn"], s))
    return x


def radar_score_map(P, S, maps, prec):
    """Three 3x3 conv + BN + leaky stages, a 1x1 conv, sigmoid."""
    keys = sorted(P["radar_enc"], key=int)
    x = maps
    for key in keys[:-1]:
        p, s = P["radar_enc"][key], S["radar_enc"][key]
        x = darknet.leaky(_bn(_conv(x, p["w"], 1, prec, "heads") + p["b"],
                              p["bn"], s))
    p = P["radar_enc"][keys[-1]]
    return torch.sigmoid(_conv(x, p["w"], 0, prec, "heads") + p["b"])


def _taps(xyxy, h, w, offset, min_size, smax, bins=7):
    """torchvision 0.6's RoIAlign sampling on one map [H, W]: for RoIs
    [R, 4] (feature-map coordinates before ``offset``), the bilinear taps
    of every (bin_y, bin_x, sample_y, sample_x): flat indices and weights
    [R, 7, 7, smax, smax, 4], and the samples a bin averages [R]."""
    x0 = xyxy[:, 0] + offset
    y0 = xyxy[:, 1] + offset
    rw = (xyxy[:, 2] + offset - x0).clamp(min=min_size)
    rh = (xyxy[:, 3] + offset - y0).clamp(min=min_size)
    gh = torch.ceil(rh / bins).clamp(1, smax)
    gw = torch.ceil(rw / bins).clamp(1, smax)
    ar_b = torch.arange(bins, dtype=torch.float32, device=xyxy.device)
    ar_s = torch.arange(smax, dtype=torch.float32, device=xyxy.device)

    def axis(start, size, grid):
        pos = (start[:, None, None] + ar_b[None, :, None]
               * (size / bins)[:, None, None]
               + (ar_s[None, None, :] + 0.5) * (size / bins)[:, None, None]
               / grid[:, None, None])
        return pos, ar_s[None, None, :] < grid[:, None, None]

    py, vy = axis(y0, rh, gh)                     # [R, 7, smax]
    px, vx = axis(x0, rw, gw)
    y = py[:, :, None, :, None]
    x = px[:, None, :, None, :]
    ok = (vy[:, :, None, :, None] & vx[:, None, :, None, :]
          & (y > -1) & (y < h) & (x > -1) & (x < w))
    y, x = y.clamp(0, h - 1), x.clamp(0, w - 1)
    ya, xa = torch.floor(y), torch.floor(x)
    yb, xb = (ya + 1).clamp(max=h - 1), (xa + 1).clamp(max=w - 1)
    ly, lx = y - ya, x - xa
    wts = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx),
                       ly * lx], -1) * ok[..., None]
    idx = torch.stack([ya * w + xa, ya * w + xb, yb * w + xa, yb * w + xb],
                      -1).long()
    return idx, wts, gh * gw


def roi_align(fmap, xyxy, scale, smax):
    """fmap [H, W, C], RoIs [R, 4] in image pixels -> [R, 7, 7, C]
    (aligned=False, RoI size at least 1)."""
    h, w, c = fmap.shape
    idx, wts, cnt = _taps(xyxy * scale, h, w, 0.0, 1.0, smax)
    vals = fmap.reshape(h * w, c)[idx]                # [R,7,7,s,s,4,C]
    return (vals * wts[..., None]).sum((3, 4, 5)) / cnt[:, None, None, None]


def ps_roi_align(fmap, xyxy, scale, smax, bins=7):
    """Position-sensitive: fmap [H, W, C_out*7*7] in torch's C_out-major
    bin layout, RoIs [R, 4] -> [R, 7, 7, C_out] (a -0.5 offset, RoI size
    at least 0.1); bin (i, j) reads its own channel block."""
    h, w, c = fmap.shape
    c_out = c // (bins * bins)
    idx, wts, cnt = _taps(xyxy * scale, h, w, -0.5, 0.1, smax)
    fm = fmap.reshape(h * w, c_out, bins, bins)
    bi = torch.arange(bins, device=fmap.device)
    vals = fm[idx, :, bi[None, :, None, None, None, None],
              bi[None, None, :, None, None, None]]    # [R,7,7,s,s,4,C_out]
    return (vals * wts[..., None]).sum((3, 4, 5)) / cnt[:, None, None, None]


def heads(P, S, img_crop, radar_crop, prec, class_num=1):
    """Crops [R, 7, 7, 10] -> (regression [R, 4], refinement vector
    [R, 1 + class_num]): module3's refinement head with its radar
    confidence."""
    flat = img_crop.permute(0, 3, 1, 2).reshape(img_crop.shape[0], -1)
    R = P["refine"]
    t = darknet.leaky(_linear(flat, R["net0"], prec, "heads"))
    reg = _linear(t, R["net1"], prec, "heads")
    cls = torch.sigmoid(_linear(t, R["net2"], prec, "heads"))
    rn = R["radar_net"]
    r = _conv(radar_crop, rn["conv7"]["w"], 0, prec, "heads") \
        + rn["conv7"]["b"]
    r = darknet.leaky(_bn(r, rn["bn"], S["refine"]["radar_net"]))
    r = _conv(r, rn["conv1"]["w"], 0, prec, "heads") + rn["conv1"]["b"]
    conf = torch.sigmoid(torch.sigmoid(r.reshape(-1, 1)) + cls[:, :1])
    return reg, torch.cat([conf, cls[:, 1:1 + class_num]], -1)


def ensemble(P, refinement, yolo, prec):
    """[R, c+1] x2 -> [R, 2] softmax (module3: no leaky after fc2)."""
    E = P["ensemble"]
    x = torch.stack([refinement, yolo], -1)
    x = darknet.leaky(_linear(x, E["fc1"], prec, "heads"))
    x = _linear(x.reshape(x.shape[0], -1), E["fc2"], prec, "heads")
    return torch.softmax(x, -1)


def box_regress(d, xyxy):
    w, h = xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]
    cx, cy = xyxy[:, 0] + w / 2, xyxy[:, 1] + h / 2
    cx, cy = d[:, 0] * w + cx, d[:, 1] * h + cy
    w = torch.exp(d[:, 2].clamp(-20, 20)) * w
    h = torch.exp(d[:, 3].clamp(-20, 20)) * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xywh_to_xyxy(b):
    return torch.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                        b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], -1)


def detector_rows(det):
    """Decoded [A, 5+C] -> rows [A, 6] of (x1, y1, x2, y2, objectness,
    best class score) and the best class [A]."""
    cls = det[:, 5:]
    return (torch.cat([xywh_to_xyxy(det[:, :4]), det[:, 4:5],
                       cls.amax(-1, keepdim=True)], -1), cls.argmax(-1))


class Scene:
    """The reference's view of one frame: ``rows`` [R, 6] of (x1, y1,
    x2, y2, score, class score), one for every candidate the frame's
    answer could hold, and ``kept``, the rows of its own answer."""

    def __init__(self, rows, kept):
        self.rows, self.kept = rows, kept


def fusion_scene(P, S, layers, image, maps, radar_boxes, cfg, mode,
                 prec=REFERENCE, part=lambda i: "backbone"):
    """One frame: image [S, S, 3], radar maps [S/16, S/16, 3] and radar
    proposals [R, 4] (normalized xyxy, the valid ones) -> ``Scene`` at
    ``mode`` (0 fusion, 1 the detector alone). ``cfg``: conf_thresh,
    nms_thresh, max_det, pre_nms_top_k, class_idx."""
    img_size = image.shape[0]
    det, feat = darknet.forward(layers, P["darknet"], S["darknet"],
                                image.permute(2, 0, 1)[None], tap=8,
                                prec=prec, part=part)
    rows, cls = detector_rows(det[0])
    keep = nms.keep_indices(rows[:, :4], rows[:, 4], cls, cfg["conf_thresh"],
                            cfg["nms_thresh"], cfg["max_det"],
                            cfg["pre_nms_top_k"])
    keep = keep[cls[keep] == cfg["class_idx"]]
    if mode == 1:
        return Scene(rows, rows[keep])
    smax = max(4, math.ceil(img_size / 16 / 7))
    smap = score_map(P, S, feat.permute(0, 2, 3, 1), prec)[0]
    rmap = radar_score_map(P, S, maps[None], prec)[0]
    rxyxy = radar_boxes * img_size
    rois = torch.cat([rows[:, :4], rxyxy])
    reg, vec = [], []
    for lo in range(0, len(rois), 512):
        r = rois[lo:lo + 512]
        g, v = heads(P, S, ps_roi_align(smap, r, 1 / 16, smax),
                     roi_align(rmap, r, 1 / 16, smax), prec)
        reg.append(g)
        vec.append(v)
    reg, vec = torch.cat(reg), torch.cat(vec)
    n_img = len(rows)
    yolo = torch.cat([det[0, :, 4:5], det[0, :, 5:6]], -1)
    fg_img = ensemble(P, vec[:n_img], yolo, prec)[:, 0]
    out = box_regress(reg, rois)
    img_rows = torch.cat([out[:n_img], fg_img[:, None], rows[:, 5:6]], -1)
    radar_rows = torch.cat([out[n_img:], vec[n_img:, :1], vec[n_img:, 1:2]],
                           -1)
    all_rows = torch.cat([img_rows, radar_rows])
    kept = torch.cat([img_rows[keep], radar_rows])
    return Scene(all_rows, kept)


def yolo_scene(P, S, layers, image, cfg, prec=REFERENCE,
               part=lambda i: "backbone"):
    """One frame through the Darknet, decode and NMS (every class):
    ``Scene`` of its decoded rows and its kept rows."""
    det, _ = darknet.forward(layers, P, S, image.permute(2, 0, 1)[None],
                             prec=prec, part=part)
    rows, cls = detector_rows(det[0])
    keep = nms.keep_indices(rows[:, :4], rows[:, 4], cls, cfg["conf_thresh"],
                            cfg["nms_thresh"], cfg["max_det"],
                            cfg["pre_nms_top_k"])
    return Scene(rows, rows[keep])
