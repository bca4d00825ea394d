"""cfg-driven Darknet (tiny-YOLOv3 family), inference only (port of
``millieye_tpu/models/darknet.py``).

Parameters are explicit: ``params`` / ``state`` are lists with one dict
of tensors per block (empty for blocks without weights), convolution
weights OIHW. ``apply`` takes and returns the JAX package's layouts
(NHWC images and feature map, [N, A, 5+C] detections) and runs
channels_last NCHW inside.

Precision ladder (``hi_prec_stages`` / ``hi_prec_store``): under a
low-precision ``compute_dtype`` the listed convolutions run in float32
and store their output as ``hi_prec_store`` (float16 in the serving
presets). ``stem_pair`` = lo fuses stages lo and lo+2 (conv3x3 + pool
each) into kernel K4 (``ops/stem.py``) at inference on folded weights;
blocks lo+1..lo+3 then pass its output through.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from millieye_torch.ops.stem import fused_stem_pair

_BN_EPS = 1e-5


def leaky(x):
    """LeakyReLU(0.1) with the slope in x's dtype, as JAX's weakly typed
    ``0.1 * x`` rounds it (bf16(0.1) != float32(0.1))."""
    return torch.where(x > 0, x, x * torch.full((), 0.1, dtype=x.dtype,
                                                device=x.device))


def _maxpool(x, size, stride):
    if size == 2 and stride == 1:
        # the reference pads right/bottom with ZEROS (nn.ZeroPad2d), not
        # -inf: where every border activation is negative the max is 0
        x = F.pad(x, (0, 1, 0, 1))
    return F.max_pool2d(x, size, stride)


def decode_yolo(raw, anchors, num_classes, img_dim):
    """One YOLO scale: raw [N, A*(5+C), G, G] conv output (any dtype) ->
    detections [N, A*G*G, 5+C] float32 in image scale, anchor-major then
    row then column."""
    n, g = raw.shape[0], raw.shape[2]
    a = len(anchors)
    f = 5 + num_classes
    raw = raw.permute(0, 2, 3, 1).reshape(n, g, g, a, f).permute(0, 3, 1, 2, 4)
    raw = raw.float()
    stride = img_dim / g
    anc = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    xy = torch.sigmoid(raw[..., 0:2])
    twh = raw[..., 2:4]
    conf = torch.sigmoid(raw[..., 4:5])
    cls = torch.sigmoid(raw[..., 5:])
    ar = torch.arange(g, dtype=torch.float32, device=raw.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    grid = torch.stack([gx, gy], -1)[None, None]
    bxy = (xy + grid) * stride
    bwh = torch.exp(twh.clamp(-20.0, 20.0)) * anc[None, :, None, None, :]
    return torch.cat([bxy, bwh, conf, cls], -1).reshape(n, a * g * g, f)


class Darknet:
    """Layer plan + inference forward over explicit parameters."""

    def __init__(self, config, img_size=416, feature_tap=8,
                 hi_prec_stages=(), hi_prec_store=None, stem_pair=None):
        self.hyperparams = config[0]
        self.block_defs = list(config[1:])
        self.img_size = img_size
        self.feature_tap = feature_tap
        self.hi_prec_stages = tuple(hi_prec_stages)
        self.hi_prec_store = hi_prec_store
        self.stem_pair = stem_pair
        self._plan = self._build_plan()
        if stem_pair is not None:
            self._validate_stem_pair(stem_pair)

    def _build_plan(self):
        """Per-block channel counts and anchor sets."""
        plan = []
        channels = [int(self.hyperparams.get("channels", 3))]
        for block in self.block_defs:
            t = block["type"]
            info = {"type": t}
            if t == "convolutional":
                info.update(in_ch=channels[-1], filters=int(block["filters"]),
                            size=int(block["size"]),
                            stride=int(block["stride"]),
                            bn=int(block.get("batch_normalize", 0)) == 1,
                            act=block.get("activation", "linear"))
                out = info["filters"]
            elif t == "maxpool":
                info.update(size=int(block["size"]),
                            stride=int(block["stride"]))
                out = channels[-1]
            elif t == "upsample":
                info.update(factor=int(block["stride"]))
                out = channels[-1]
            elif t == "route":
                layers = [int(v) for v in block["layers"].split(",")]
                info.update(layers=[l if l >= 0 else len(plan) + l
                                    for l in layers])
                out = sum(channels[1:][l] for l in info["layers"])
            elif t == "shortcut":
                frm = int(block["from"])
                info.update(frm=len(plan) + frm if frm < 0 else frm)
                out = channels[1:][info["frm"]]
            elif t == "yolo":
                mask = [int(v) for v in block["mask"].split(",")]
                flat = [int(v) for v in block["anchors"].split(",")]
                pairs = list(zip(flat[::2], flat[1::2]))
                info.update(anchors=tuple(pairs[m] for m in mask),
                            classes=int(block["classes"]))
                out = channels[-1]
            else:
                raise ValueError(f"unknown block type {t!r}")
            plan.append(info)
            channels.append(out)
        return plan

    def _validate_stem_pair(self, lo):
        """Stages lo and lo+2 must each be a leaky conv3x3s1 followed by
        a maxpool2s2, and nothing may read blocks lo..lo+3 but the next
        block (their slots hold the pair's output)."""
        referenced = {self.feature_tap}
        for info in self._plan:
            referenced.update(info.get("layers", ()))
            if "frm" in info:
                referenced.add(info["frm"])
        for i in (lo, lo + 2):
            if not 0 <= i < len(self._plan) - 1:
                raise ValueError(f"stem stage {i} out of range")
            info, nxt = self._plan[i], self._plan[i + 1]
            if not (info["type"] == "convolutional" and info["size"] == 3
                    and info["stride"] == 1 and info["act"] == "leaky"
                    and nxt["type"] == "maxpool" and nxt["size"] == 2
                    and nxt["stride"] == 2):
                raise ValueError(f"block {i} is not a leaky conv3x3s1 + "
                                 "maxpool2s2 stage")
        for j in range(lo, lo + 4):
            if j in referenced:
                raise ValueError(f"block {j} is route/tap-referenced; cannot "
                                 "fuse the stem pair")

    def _store_dtype(self, i, compute_dtype):
        if i in self.hi_prec_stages:
            return self.hi_prec_store or torch.float32
        return compute_dtype

    def apply(self, params, state, images, compute_dtype=torch.float32):
        """images [N, H, W, 3] -> {"feature_map": [N, H/16, W/16, 256]
        NHWC in the compute dtype, "detections": [N, sum(A*G*G), 5+C]
        float32}."""
        img_dim = images.shape[1]
        x_in = images.permute(0, 3, 1, 2)
        outputs, dets = [], []
        feature_map = None
        lo = self.stem_pair
        fuse = (lo is not None and "w" in params[lo]
                and "gamma" not in params[lo] and "gamma" not in params[lo + 2])
        for i, info in enumerate(self._plan):
            t = info["type"]
            p = params[i] if i < len(params) else {}
            s = state[i] if i < len(state) else {}
            prev = outputs[-1] if outputs else x_in
            if fuse and lo < i <= lo + 3:
                x = prev              # consumed by the fused pair
            elif fuse and i == lo:
                if self._store_dtype(lo + 2, compute_dtype) != torch.float16:
                    raise ValueError("the fused stem pair stores float16: "
                                     "stage lo+2 needs hi_prec_store float16")
                p2 = params[lo + 2]
                y = fused_stem_pair(
                    prev.permute(0, 2, 3, 1).float().contiguous(),
                    p["w"].float(), p["b"].float(), p2["w"].float(),
                    p2["b"].float())
                x = y.permute(0, 3, 1, 2)
            elif t == "convolutional":
                dt = (torch.float32 if i in self.hi_prec_stages
                      else compute_dtype)
                x = F.conv2d(prev.to(dt), p["w"].to(dt), stride=info["stride"],
                             padding=(info["size"] - 1) // 2)
                if "gamma" in p:      # BN not folded away (eval mode)
                    x = (x - s["mean"][:, None, None]) * torch.rsqrt(
                        s["var"][:, None, None] + _BN_EPS)
                    x = (x * p["gamma"][:, None, None]
                         + p["beta"][:, None, None])
                else:
                    x = x + p["b"][:, None, None]
                if info["act"] == "leaky":
                    x = leaky(x)
                if self.hi_prec_store is not None and i in self.hi_prec_stages:
                    x = x.to(self.hi_prec_store)
            elif t == "maxpool":
                x = _maxpool(prev, info["size"], info["stride"])
            elif t == "upsample":
                f = info["factor"]
                x = prev.repeat_interleave(f, 2).repeat_interleave(f, 3)
            elif t == "route":
                x = torch.cat([outputs[l] for l in info["layers"]], 1)
            elif t == "shortcut":
                x = prev + outputs[info["frm"]]
            elif t == "yolo":
                x = decode_yolo(prev, info["anchors"], info["classes"],
                                img_dim)
                dets.append(x)
            outputs.append(x)
            if i == self.feature_tap:
                feature_map = x.permute(0, 2, 3, 1)
        return {"feature_map": feature_map,
                "detections": torch.cat(dets, 1) if dets else outputs[-1]}

    def fold_batchnorm(self, params, state, dtype=None):
        """Bake eval-mode BN into conv weight + bias. ``dtype`` casts the
        folded weights and biases, except the hi-prec stages, which keep
        float32."""
        folded_p, folded_s = [], []
        for i, info in enumerate(self._plan):
            p = params[i] if i < len(params) else {}
            s = state[i] if i < len(state) else {}
            if info["type"] != "convolutional":
                folded_p.append(p)
                folded_s.append(s)
                continue
            if info["bn"]:
                scale = p["gamma"] * torch.rsqrt(s["var"] + _BN_EPS)
                fp = {"w": p["w"] * scale[:, None, None, None],
                      "b": p["beta"] - s["mean"] * scale}
                folded_s.append({})
            else:
                fp = dict(p)
                folded_s.append(s)
            if dtype is not None and i not in self.hi_prec_stages:
                fp = {k: v.to(dtype) for k, v in fp.items()}
            folded_p.append(fp)
        return folded_p, folded_s
