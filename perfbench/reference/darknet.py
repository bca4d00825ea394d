"""Plain Darknet (tiny-YOLOv3, YOLOv3 on Darknet-53) from a darknet block
list, in float32: convolution, eval-mode batch norm on its running
statistics (not folded), LeakyReLU(0.1), max pools (the stride-1 pool
pads right and bottom with zeros, as the reference's ``nn.ZeroPad2d``),
nearest upsampling, routes, shortcuts and the YOLO decode. Parameters:
one dict a block, keyed by the block's index as a string: ``w`` (OIHW)
with ``gamma``, ``beta`` and state ``mean``, ``var`` where the block has
batch norm, else ``w`` and ``b``.

``plan`` reads the blocks; ``forward`` runs them on NCHW float32
images; ``seeded_weights`` makes a Darknet's weights on the device from
a seed, and ``calibrate_bn`` sets their running statistics from images.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.precision import REFERENCE

BN_EPS = 1e-5


def plan(blocks):
    """Per-block layout from darknet blocks ([net, block, ...] as a .cfg
    parses): type, channels in and out, sizes, route sources, anchors."""
    net, body = blocks[0], blocks[1:]
    chans = [int(net.get("channels", 3))]
    out = []
    for i, b in enumerate(body):
        t = b["type"]
        info = {"type": t}
        if t == "convolutional":
            info.update(cin=chans[-1], cout=int(b["filters"]),
                        k=int(b["size"]), stride=int(b["stride"]),
                        bn=b.get("batch_normalize", "0") == "1",
                        leaky=b.get("activation", "linear") == "leaky")
            c = info["cout"]
        elif t == "maxpool":
            info.update(k=int(b["size"]), stride=int(b["stride"]))
            c = chans[-1]
        elif t == "upsample":
            info.update(factor=int(b["stride"]))
            c = chans[-1]
        elif t == "route":
            ls = [int(v) for v in b["layers"].split(",")]
            info["layers"] = [l if l >= 0 else i + l for l in ls]
            c = sum(chans[1 + l] for l in info["layers"])
        elif t == "shortcut":
            f = int(b["from"])
            info["frm"] = i + f if f < 0 else f
            c = chans[-1]
        elif t == "yolo":
            flat = [int(v) for v in b["anchors"].split(",")]
            pairs = list(zip(flat[::2], flat[1::2]))
            info.update(anchors=[pairs[int(m)] for m in b["mask"].split(",")],
                        classes=int(b["classes"]))
            c = chans[-1]
        else:
            raise ValueError(f"unknown block type {t!r}")
        out.append(info)
        chans.append(c)
    return out


def leaky(x):
    return torch.where(x > 0, x, 0.1 * x)


def decode(raw, anchors, classes, img_dim):
    """raw [N, A*(5+C), G, G] -> [N, A*G*G, 5+C] rows of (cx, cy, w, h,
    objectness, class scores) in pixels, anchor-major then row then
    column."""
    n, _, g, _ = raw.shape
    a, f = len(anchors), 5 + classes
    p = raw.float().reshape(n, a, f, g, g).permute(0, 1, 3, 4, 2)
    stride = img_dim / g
    ar = torch.arange(g, dtype=torch.float32, device=raw.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    anc = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    cx = (torch.sigmoid(p[..., 0]) + gx) * stride
    cy = (torch.sigmoid(p[..., 1]) + gy) * stride
    w = torch.exp(p[..., 2].clamp(-20.0, 20.0)) * anc[:, 0, None, None]
    h = torch.exp(p[..., 3].clamp(-20.0, 20.0)) * anc[:, 1, None, None]
    rest = torch.sigmoid(p[..., 4:])
    det = torch.cat([torch.stack([cx, cy, w, h], -1), rest], -1)
    return det.reshape(n, a * g * g, f)


def _bn(x, p, s):
    scale = p["gamma"] / torch.sqrt(s["var"] + BN_EPS)
    return ((x - s["mean"][:, None, None]) * scale[:, None, None]
            + p["beta"][:, None, None])


def forward(layers, params, state, x, tap=None, prec=REFERENCE,
            part=lambda i: "backbone", stats=None):
    """x [N, 3, S, S] float32 -> (detections [N, sum A*G*G, 5+C], the
    output of block ``tap`` as NCHW or None). ``prec(t, part(i))`` rounds
    block i's product operands (the control); ``stats``, a dict, makes
    each batch-norm block take its running statistics from this batch
    first (``calibrate_bn``)."""
    outs, dets = [], []
    img_dim = x.shape[-1]
    for i, info in enumerate(layers):
        t = info["type"]
        prev = outs[-1] if outs else x
        key = str(i)
        if t == "convolutional":
            p = params[key]
            y = F.conv2d(prec(prev, part(i)), prec(p["w"], part(i)),
                         stride=info["stride"], padding=(info["k"] - 1) // 2)
            if info["bn"]:
                if stats is not None:
                    var, mean = torch.var_mean(y, dim=(0, 2, 3),
                                               unbiased=False)
                    stats[key] = {"mean": mean, "var": var}
                    state[key] = stats[key]
                y = _bn(y, p, state[key])
            else:
                y = y + p["b"][:, None, None]
            out = leaky(y) if info["leaky"] else y
        elif t == "maxpool":
            z = prev
            if info["k"] == 2 and info["stride"] == 1:
                z = F.pad(z, (0, 1, 0, 1))
            out = F.max_pool2d(z, info["k"], info["stride"])
        elif t == "upsample":
            out = F.interpolate(prev, scale_factor=info["factor"],
                                mode="nearest")
        elif t == "route":
            out = torch.cat([outs[l] for l in info["layers"]], 1)
        elif t == "shortcut":
            out = prev + outs[info["frm"]]
        else:   # yolo
            dets.append(decode(prev, info["anchors"], info["classes"],
                               img_dim))
            out = prev
        outs.append(out)
    return torch.cat(dets, 1), (outs[tap] if tap is not None else None)


def seeded_weights(layers, seed, device):
    """A Darknet's weights from ``seed``, made on ``device`` by one
    ``torch.Generator`` there in two draws: convolution weights N(0,
    1/fan_in), batch-norm gamma 1 + N(0, 0.1^2) and beta N(0, 0.1^2),
    zero biases, running mean 0 and variance 1 (``calibrate_bn`` sets
    them). Returns (params, state)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    convs = [(str(i), info) for i, info in enumerate(layers)
             if info["type"] == "convolutional"]
    sizes = [info["cout"] * info["cin"] * info["k"] ** 2 for _, info in convs]
    wflat = torch.randn(sum(sizes), generator=gen, device=device)
    nbn = sum(info["cout"] for _, info in convs if info["bn"])
    bnflat = torch.randn(2 * nbn, generator=gen, device=device) * 0.1
    params, state = {}, {}
    wo = bo = 0
    for (key, info), size in zip(convs, sizes):
        c = info["cout"]
        fan_in = info["cin"] * info["k"] ** 2
        w = wflat[wo:wo + size].view(c, info["cin"], info["k"], info["k"])
        wo += size
        w = w * fan_in ** -0.5
        if info["bn"]:
            params[key] = {"w": w, "gamma": 1.0 + bnflat[bo:bo + c],
                           "beta": bnflat[nbn + bo:nbn + bo + c]}
            bo += c
            state[key] = {"mean": torch.zeros(c, device=device),
                          "var": torch.ones(c, device=device)}
        else:
            params[key] = {"w": w, "b": torch.zeros(c, device=device)}
    return params, state


@torch.no_grad()
def calibrate_bn(layers, params, state, images):
    """Set every batch-norm block's running statistics to those of its
    input on ``images`` [N, 3, S, S] (block by block, so each block sees
    its inputs normalized by the statistics already set): the state a
    trained network's batch norm holds, which keeps activations at unit
    scale through the depth where N(0, 1/fan_in) weights alone would not.
    Runs with cuDNN's deterministic algorithms, so one seed gives one
    state."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        forward(layers, params, state, images, stats={})
    finally:
        torch.backends.cudnn.deterministic = prev
    return state
