"""Plain YOLOv4 (AlexeyAB's ``yolov4.cfg``: CSPDarknet53, SPP, PAN and three
YOLO heads) from a darknet block list, in float32 with TF32 off:
convolution, eval-mode batch norm on its running statistics (not
folded), the block's activation (Mish as ``x * tanh(softplus(x))``,
LeakyReLU(0.1), or none), max pools (a stride-1 pool of odd size k on
-inf padding of k // 2 a side, which keeps the size: the SPP), nearest
upsampling, routes, shortcuts and the YOLO decode with ``scale_x_y``.
Parameters as ``darknet.py`` keeps them: one dict a block, keyed by the
block's index as a string.

``plan`` reads the blocks; ``forward`` runs them on NCHW float32 images;
``seeded_weights`` makes the weights on the device from a seed
(``darknet.seeded_weights``' draws), and ``calibrate_bn`` sets their
running statistics from images through this file's forward, Mish
included; ``yolo_scene`` gives one frame's ``fusion.Scene``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import darknet, nms
from perfbench.reference.fusion import Scene, detector_rows
from perfbench.reference.precision import REFERENCE

ACTIVATIONS = ("linear", "leaky", "mish")


def plan(blocks):
    """``darknet.plan``'s layout, with each convolution's ``act`` (one of
    ``ACTIVATIONS``; another raises) and each YOLO block's ``scale``
    (``scale_x_y``, default 1)."""
    layers = darknet.plan(blocks)
    for info, b in zip(layers, blocks[1:]):
        if info["type"] == "convolutional":
            info["act"] = b.get("activation", "linear")
            if info["act"] not in ACTIVATIONS:
                raise ValueError(f"unknown activation {info['act']!r}")
        elif info["type"] == "yolo":
            info["scale"] = float(b.get("scale_x_y", 1))
    return layers


def mish(x):
    return x * torch.tanh(F.softplus(x))


ACT = {"linear": lambda x: x, "leaky": darknet.leaky, "mish": mish}


def maxpool(x, k, stride):
    """A darknet max pool: stride 1 and odd k on -inf padding of k // 2 a
    side (darknet's ``maxpool_layer``); size 2 at stride 1 on a zero row
    and column at the right and bottom (the reference's ``nn.ZeroPad2d``);
    else unpadded."""
    if stride == 1 and k % 2:
        p = k // 2
        x = F.pad(x, (p, p, p, p), value=float("-inf"))
        return F.max_pool2d(x, k, 1)
    if stride == 1:
        x = F.pad(x, (0, 1, 0, 1))
    return F.max_pool2d(x, k, stride)


def decode(raw, anchors, classes, img_dim, scale):
    """``darknet.decode`` with the grid sensitivity of ``yolov4.cfg``: the
    centre is ``(sigmoid(t) * scale - (scale - 1) / 2 + cell) * stride``."""
    n, _, g, _ = raw.shape
    a, f = len(anchors), 5 + classes
    p = raw.float().reshape(n, a, f, g, g).permute(0, 1, 3, 4, 2)
    stride = img_dim / g
    ar = torch.arange(g, dtype=torch.float32, device=raw.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    anc = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    sx = torch.sigmoid(p[..., 0]) * scale - (scale - 1) / 2
    sy = torch.sigmoid(p[..., 1]) * scale - (scale - 1) / 2
    cx = (sx + gx) * stride
    cy = (sy + gy) * stride
    w = torch.exp(p[..., 2].clamp(-20.0, 20.0)) * anc[:, 0, None, None]
    h = torch.exp(p[..., 3].clamp(-20.0, 20.0)) * anc[:, 1, None, None]
    rest = torch.sigmoid(p[..., 4:])
    det = torch.cat([torch.stack([cx, cy, w, h], -1), rest], -1)
    return det.reshape(n, a * g * g, f)


def forward(layers, params, state, x, prec=REFERENCE,
            part=lambda i: "backbone", stats=None, outputs=False):
    """x [N, 3, S, S] float32 -> (detections [N, sum A*G*G, 5+C], every
    block's output NCHW with ``outputs``, else None). ``prec`` and
    ``stats`` as in ``darknet.forward``."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs, dets = [], []
        for i, info in enumerate(layers):
            def rnd(t, where=part(i)):
                return prec(t, where)
            out, det = block(i, info, outs, x, params, state, rnd, stats)
            outs.append(out)
            if det is not None:
                dets.append(det)
        return torch.cat(dets, 1), (outs if outputs else None)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def block(i, info, outs, x, params, state, rnd=lambda t: t, stats=None):
    """Block ``i`` (``info``) on the outputs of the blocks before it
    (``outs``; ``x``, the images, before the first): (its output, its
    detections or None). ``rnd`` rounds a product's operands."""
    t = info["type"]
    prev = outs[-1] if outs else x
    key = str(i)
    if t == "convolutional":
        p = params[key]
        y = F.conv2d(rnd(prev), rnd(p["w"]), stride=info["stride"],
                     padding=(info["k"] - 1) // 2)
        if info["bn"]:
            if stats is not None:
                var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
                stats[key] = {"mean": mean, "var": var}
                state[key] = stats[key]
            y = darknet._bn(y, p, state[key])
        else:
            y = y + p["b"][:, None, None]
        return ACT[info["act"]](y), None
    if t == "maxpool":
        return maxpool(prev, info["k"], info["stride"]), None
    if t == "upsample":
        return F.interpolate(prev, scale_factor=info["factor"],
                             mode="nearest"), None
    if t == "route":
        return torch.cat([outs[l] for l in info["layers"]], 1), None
    if t == "shortcut":
        return prev + outs[info["frm"]], None
    return prev, decode(prev, info["anchors"], info["classes"], x.shape[-1],
                        info["scale"])


seeded_weights = darknet.seeded_weights


@torch.no_grad()
def calibrate_bn(layers, params, state, images):
    """``darknet.calibrate_bn`` through this file's forward: each batch
    norm's running statistics those of its input on ``images``, block by
    block, with cuDNN's deterministic algorithms."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        forward(layers, params, state, images, stats={})
    finally:
        torch.backends.cudnn.deterministic = prev
    return state


def yolo_scene(P, S, layers, image, cfg, prec=REFERENCE,
               part=lambda i: "backbone"):
    """One frame [S, S, 3] through the network, decode and NMS (every
    class): ``Scene`` of its decoded rows and its kept rows."""
    det, _ = forward(layers, P, S, image.permute(2, 0, 1)[None], prec=prec,
                     part=part)
    rows, cls = detector_rows(det[0])
    keep = nms.keep_indices(rows[:, :4], rows[:, 4], cls, cfg["conf_thresh"],
                            cfg["nms_thresh"], cfg["max_det"],
                            cfg["pre_nms_top_k"])
    return Scene(rows, rows[keep])
