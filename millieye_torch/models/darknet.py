"""cfg-driven Darknet (tiny-YOLOv3, YOLOv3 on Darknet-53) (port of
``millieye_tpu/models/darknet.py``).

The graph comes from a list of block dicts (``models/zoo.py``) or a
darknet ``.cfg`` path. Parameters are explicit: ``params`` / ``state``
are lists with one dict of tensors per block (empty for blocks without
weights), convolution weights OIHW; ``init`` draws them from a
``torch.Generator``. ``apply`` takes and returns the JAX package's layouts
(NHWC images and feature map, [N, A, 5+C] detections) and runs
channels_last NCHW inside.

Precision ladder (``hi_prec_stages`` / ``hi_prec_store``): under a
low-precision ``compute_dtype`` the listed convolutions run in float32
and store their output as ``hi_prec_store`` (float16 in the serving
presets). ``stem_stages`` lists the conv3x3 + pool stages that run
fused at inference on folded weights: each as one launch of kernel K9
(``ops/stem.py:fused_stem_stage``, at ``stem_precision``), its pool
block passing the result through. With ``stem_pair`` the two lowest
stages lo and lo+2 run together as one pair kernel, chosen by
``stem_pair_variant`` (``PAIR_KERNELS``), and blocks lo+1..lo+3 pass its
output through; ``stem_pairs="all"`` also pairs the later consecutive
stages (4+6, the deep pair), for the s2d variants only, as the JAX
package does. A pair stores its output in its second stage's store type.

Stem transforms of a conv3x3 + maxpool2 stage on folded weights, exact
in real arithmetic: ``s2d_stages`` run it as one convolution over the
space-to-depth input with the phase-decomposed ``w2`` (``fold_s2d``),
then the max over the four output phases; ``im2col_stages`` as one
product of 16 stride-2 input slices with ``wi`` (``fold_im2col``). Int8
serving (``ops/quantize.py``): ``q``/``q2`` slots with per-channel
``scale`` dequantize in the graph; with an input scale ``xs`` the
convolution runs int8 x int8 -> int32 (``int8_conv2d``).
``collect_act_stats`` returns each convolution's input absmax
(``act_absmax``) for calibrating ``xs``; it runs the stem pairs as
single stages, as the JAX package does.

Training (``apply(train=True)``): BN normalizes with the batch statistics
and updates the running ones with momentum 0.9 (the reference's
``BatchNorm2d(momentum=0.9)``: running <- 0.1 running + 0.9 batch, the
variance unbiased over N*H*W); the output also holds ``preds``, each YOLO
scale's [N, A, G, G, 5+C] (sigmoid x, y, raw w, h, sigmoid conf and
classes) for the loss, and the new ``state``. No kernel runs in train
mode: the stem kernels need folded weights and ``not train``, as in the
JAX package, and the custom ops have no backward. ``feature_map`` and
``detections`` never carry a gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from millieye_torch.device import constant
from millieye_torch.io.checkpoint import to_device
from millieye_torch.io.config import parse_model_config
from millieye_torch.ops.quantize import int8_conv2d
from millieye_torch.ops.stem import (fused_stem_pair, fused_stem_pair_packed,
                                     fused_stem_pair_s2d,
                                     fused_stem_pair_select, fused_stem_stage)
from millieye_torch.parallel import collectives as pc

_BN_EPS = 1e-5
# torch BatchNorm2d(momentum=0.9): running <- 0.1 running + 0.9 batch
_BN_MOMENTUM = 0.9

# The JAX package's pair variants (``pallas_stem_pair_variant``) -> the
# kernel wrapper and its keyword arguments. The four "phase" spellings
# differ only in how the TPU buffers VMEM: kernel K4. A "_bf16s" suffix
# (bf16 scratches, buffering too) is allowed where the JAX package allows
# it and needs precision "default".
PAIR_KERNELS = {
    "select": (fused_stem_pair_select, {}),
    "phase": (fused_stem_pair, {}),
    "phase_s01": (fused_stem_pair, {}),
    "phase_vmem": (fused_stem_pair, {}),
    "phase_vmem_s01": (fused_stem_pair, {}),
    "packed": (fused_stem_pair_packed, {}),
    "s2d": (fused_stem_pair_s2d, {"groups0": 4}),
    "s2d8": (fused_stem_pair_s2d, {"groups0": 8}),
}
_NO_BF16S = ("select", "phase_s01", "phase_vmem_s01")
_DEEP_PAIR_VARIANTS = ("s2d", "s2d8")   # the only ones that pair stages 4+6


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


def space_to_depth(x):
    """[N, C, H, W] -> [N, 4C, H/2, W/2], phase-major channels
    (dy*2 + dx)*C + c."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, 4 * c, h // 2, w // 2)


def s2d_conv_weight(w):
    """[D, C, 3, 3] OIHW -> [4D, 4C, 3, 3]: ``maxpool2(conv3x3(x))`` as a
    stride-1 conv over ``space_to_depth(x)``. Output phase (a, b) of the
    full-size conv at block (i, j) reads input pixels (2i+a+u-1,
    2j+b+v-1): each tap lands at its (block offset, input phase) slot, the
    rest are structural zeros. The four output-phase channel groups are
    the pool window."""
    d, c, k, _ = w.shape
    if k != 3:
        raise ValueError("s2d_conv_weight expects 3x3 kernels")
    wp = w.new_zeros((4 * d, 4 * c, 3, 3))
    for ph_out in range(4):
        a, b = divmod(ph_out, 2)
        for u in range(3):
            for v in range(3):
                by, py = divmod(a + u + 1, 2)
                bx, px = divmod(b + v + 1, 2)
                ph_in = py * 2 + px
                wp[ph_out * d:(ph_out + 1) * d, ph_in * c:(ph_in + 1) * c,
                   by, bx] = w[:, :, u, v]
    return wp


def im2col_stem_weight(w):
    """[D, C, 3, 3] OIHW -> [16C, 4D] ([in, out]): ``maxpool2(conv3x3(x))``
    as one product over 4x4 stride-2 patches. Pooled output (i, j) needs
    the conv outputs at (2i+a, 2j+b), whose taps lie in the 4x4 window
    at (2i-1, 2j-1); rows are (dy*4 + dx)-major then input channel,
    columns (a*2 + b)-major then output channel."""
    d, c, k, _ = w.shape
    if k != 3:
        raise ValueError("im2col_stem_weight expects 3x3 kernels")
    wm = w.new_zeros((16 * c, 4 * d))
    for p in range(4):
        a, b = divmod(p, 2)
        for u in range(3):
            for v in range(3):
                t = (a + u) * 4 + (b + v)
                wm[t * c:(t + 1) * c, p * d:(p + 1) * d] = w[:, :, u, v].T
    return wm


def decode_yolo(raw, anchors, num_classes, img_dim, with_pred=False):
    """One YOLO scale: raw [N, A*(5+C), G, G] conv output (any dtype) ->
    detections [N, A*G*G, 5+C] float32 (float64 from float64) in image
    scale, anchor-major then
    row then column; ``with_pred`` also returns pred [N, A, G, G, 5+C]
    (sigmoid x, y, raw w, h, sigmoid conf and classes), what the loss
    reads."""
    n, g = raw.shape[0], raw.shape[2]
    a = len(anchors)
    f = 5 + num_classes
    raw = raw.permute(0, 2, 3, 1).reshape(n, g, g, a, f).permute(0, 3, 1, 2, 4)
    raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
    stride = img_dim / g
    anc = constant(tuple(map(tuple, anchors)), raw.device)
    xy = torch.sigmoid(raw[..., 0:2])
    twh = raw[..., 2:4]
    conf = torch.sigmoid(raw[..., 4:5])
    cls = torch.sigmoid(raw[..., 5:])
    ar = torch.arange(g, dtype=torch.float32, device=raw.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    grid = torch.stack([gx, gy], -1)[None, None]
    bxy = (xy + grid) * stride
    bwh = torch.exp(twh.clamp(-20.0, 20.0)) * anc[None, :, None, None, :]
    det = torch.cat([bxy, bwh, conf, cls], -1).reshape(n, a * g * g, f)
    if with_pred:
        return det, torch.cat([xy, twh, conf, cls], -1)
    return det


def _train_bn(x, p, s):
    """Train-mode BN of an NCHW conv output: the batch statistics
    normalize (biased variance); returns (y, the running statistics
    updated with the unbiased one, detached). Under an active mesh the
    statistics are the global batch's (sums over every "data" rank)."""
    cnt = x.shape[0] * x.shape[2] * x.shape[3]
    if pc.data_size() == 1:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    else:
        cnt *= pc.data_size()
        mean = pc.data_sum(x.sum((0, 2, 3))) / cnt
        var = pc.data_sum(((x - mean[:, None, None]) ** 2).sum((0, 2, 3))) \
            / cnt
    var_u = var * (cnt / max(cnt - 1, 1))
    m = _BN_MOMENTUM
    new_s = {"mean": (1 - m) * s["mean"] + m * mean.detach(),
             "var": (1 - m) * s["var"] + m * var_u.detach()}
    y = (x - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + _BN_EPS)
    return y * p["gamma"][:, None, None] + p["beta"][:, None, None], new_s


class Darknet:
    """Layer plan + forward (eval or train) over explicit parameters."""

    def __init__(self, config, img_size=416, feature_tap=8,
                 hi_prec_stages=(), hi_prec_store=None, stem_stages=(),
                 stem_pair=False, stem_precision="highest",
                 stem_pair_variant="select", stem_pairs="first",
                 s2d_stages=(), im2col_stages=()):
        if isinstance(config, str):
            config = parse_model_config(config)
        self.hyperparams = config[0]
        self.block_defs = list(config[1:])
        self.img_size = img_size
        self.feature_tap = feature_tap
        self.hi_prec_stages = tuple(hi_prec_stages)
        self.hi_prec_store = hi_prec_store
        self.stem_stages = tuple(sorted(stem_stages))
        self.s2d_stages = tuple(s2d_stages)
        self.im2col_stages = tuple(im2col_stages)
        s2d, im2col, stem = map(set, (self.s2d_stages, self.im2col_stages,
                                      self.stem_stages))
        overlap = s2d & im2col | s2d & stem | im2col & stem
        if overlap:
            raise ValueError(f"stages {sorted(overlap)} assigned to more "
                             "than one stem transform")
        self.stem_pair = bool(stem_pair)
        if stem_precision not in ("highest", "default"):
            raise ValueError(f"unknown stem_precision {stem_precision!r}")
        self.stem_precision = stem_precision
        bf16s = stem_pair_variant.endswith("_bf16s")
        base = stem_pair_variant[:-6] if bf16s else stem_pair_variant
        if base not in PAIR_KERNELS or (bf16s and base in _NO_BF16S):
            raise ValueError(f"unknown stem_pair_variant "
                             f"{stem_pair_variant!r} (have "
                             f"{sorted(PAIR_KERNELS)}, '_bf16s' on all but "
                             f"{_NO_BF16S})")
        if bf16s and stem_precision != "default":
            raise ValueError(f"{stem_pair_variant!r}: bf16 scratches need "
                             "stem_precision 'default'")
        self.stem_pair_variant = stem_pair_variant
        fn, kw = PAIR_KERNELS[base]
        self._pair_kernel = (fn, dict(kw, scratch_dtype=torch.bfloat16)
                             if bf16s else kw)
        if stem_pairs not in ("first", "all"):
            raise ValueError(f"unknown stem_pairs {stem_pairs!r}")
        self.stem_pairs = stem_pairs
        self._deep_pairs = (stem_pairs == "all"
                            and base in _DEEP_PAIR_VARIANTS)
        self._plan = self._build_plan()
        self._validate_stem_stages()
        if self.stem_pair:
            lo = self.stem_stages[0] if self.stem_stages else 0
            if (lo, lo + 2) != self.stem_stages[:2]:
                raise ValueError("stem_pair needs two consecutive fused "
                                 "stages (lo, lo+2) in stem_stages, got "
                                 f"{self.stem_stages}")
            for lo in self._pair_candidates():
                self._validate_stem_pair(lo)

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

    def _referenced(self):
        referenced = {self.feature_tap}
        for info in self._plan:
            referenced.update(info.get("layers", ()))
            if "frm" in info:
                referenced.add(info["frm"])
        return referenced

    def _validate_stem_stages(self):
        """Each fused stage (stem kernel, s2d or im2col) must be a
        conv3x3s1 followed by a maxpool2s2, leaky where a kernel bakes the
        activation, and nothing but the pool may read the conv's slot (it
        holds the pooled result)."""
        referenced = self._referenced()
        for i in self.stem_stages + self.s2d_stages + self.im2col_stages:
            if not 0 <= i < len(self._plan) - 1:
                raise ValueError(f"stem stage {i} out of range")
            info, nxt = self._plan[i], self._plan[i + 1]
            leaky_needed = i in self.stem_stages
            if not (info["type"] == "convolutional" and info["size"] == 3
                    and info["stride"] == 1
                    and (info["act"] == "leaky" or not leaky_needed)
                    and nxt["type"] == "maxpool" and nxt["size"] == 2
                    and nxt["stride"] == 2):
                raise ValueError(f"block {i} is not a "
                                 f"{'leaky ' if leaky_needed else ''}"
                                 "conv3x3s1 + maxpool2s2 stage")
            if i in referenced:
                raise ValueError(f"block {i} is route/tap-referenced; stem "
                                 "fusion would change its resolution")

    def _validate_stem_pair(self, lo):
        """Nothing may read blocks lo+1..lo+3 but the next block: their
        slots hold the pair's output, not the real intermediates."""
        referenced = self._referenced()
        for j in range(lo + 1, lo + 4):
            if j in referenced:
                raise ValueError(f"block {j} is route/tap-referenced; cannot "
                                 "fuse the stem pair")

    def _pair_candidates(self):
        """The lowest stage of each pair the kernels may run: the first
        pair, and with ``stem_pairs="all"`` every later (lo, lo+2) of
        ``stem_stages`` for an s2d variant."""
        if not self.stem_pair or not self.stem_stages:
            return ()
        los, taken = [], set()
        for lo in self.stem_stages[:None if self._deep_pairs else 1]:
            if lo not in taken and lo + 2 in self.stem_stages:
                los.append(lo)
                taken.update(range(lo, lo + 4))
        return tuple(los)

    def _run_pair(self, lo, params, x, compute_dtype):
        """Stages lo and lo+2 as one pair kernel: NCHW in, NCHW out."""
        fn, kw = self._pair_kernel
        kw = dict(kw)
        p, p2 = params[lo], params[lo + 2]
        if lo != self.stem_stages[0]:
            # the deep pair: the JAX package's MXU tiling for its Cmid
            # (stem_pallas_rejected.py:fused_stem2_s2d), checked, unused
            kw["groups0"] = max(2, min(8, 128 // max(p["w"].shape[0], 1)))
        y = fn(x.permute(0, 2, 3, 1).float().contiguous(), p["w"].float(),
               p["b"].float(), p2["w"].float(), p2["b"].float(),
               precision=self.stem_precision,
               out_dtype=self._store_dtype(lo + 2, compute_dtype), **kw)
        return y.permute(0, 3, 1, 2)

    def _store_dtype(self, i, compute_dtype):
        if i in self.hi_prec_stages:
            return self.hi_prec_store or torch.float32
        return compute_dtype

    def init(self, gen, device="cpu"):
        """(params, state) from an explicit ``torch.Generator``, the JAX
        package's ``weights_init_normal`` layout: conv weights (OIHW) ~
        N(0, 0.02); with BN gamma ~ 1 + N(0, 0.02), beta 0, running mean
        0 and var 1, else a zero bias; ``{}`` for weightless blocks.
        Drawn on the CPU in block order (weights, then gamma), then moved
        to ``device``: one seed gives the same tree on every device."""
        params, state = [], []
        for info in self._plan:
            if info["type"] != "convolutional":
                params.append({})
                state.append({})
                continue
            c, k = info["filters"], info["size"]
            w = 0.02 * torch.randn((c, info["in_ch"], k, k), generator=gen)
            if info["bn"]:
                params.append({"w": w,
                               "gamma": 1.0 + 0.02 * torch.randn(
                                   c, generator=gen),
                               "beta": torch.zeros(c)})
                state.append({"mean": torch.zeros(c), "var": torch.ones(c)})
            else:
                params.append({"w": w, "b": torch.zeros(c)})
                state.append({})
        return to_device(params, device), to_device(state, device)

    def apply(self, params, state, images, compute_dtype=torch.float32,
              collect_act_stats=False, collect_outputs=False, train=False):
        """images [N, H, W, 3] -> {"feature_map": [N, H/16, W/16, 256]
        NHWC in the compute dtype, "detections": [N, sum(A*G*G), 5+C]
        float32}; with ``collect_act_stats`` also "act_absmax" [n_blocks]
        float32, each convolution's input absmax (0 elsewhere); with
        ``collect_outputs`` also "outputs", each block's output (NCHW; the
        blocks a fused pair or stage covers repeat its output); with
        ``train`` also "preds" (per YOLO scale) and "state" (the updated
        BN statistics)."""
        img_dim = images.shape[1]
        x_in = images.permute(0, 3, 1, 2)
        outputs, dets, preds = [], [], []
        new_state = list(state)
        feature_map = None
        act_absmax = [torch.zeros((), device=images.device)] * len(self._plan)

        def fused(j):
            # the kernels bake bias + leaky + pool: folded weights only,
            # and never in training (the custom ops have no backward)
            return (j in self.stem_stages and not train and "w" in params[j]
                    and "gamma" not in params[j])

        def transformed(j):
            # s2d / im2col stages on their folded slots
            return (j in self.s2d_stages and ("w2" in params[j]
                                              or "q2" in params[j])
                    or j in self.im2col_stages and "wi" in params[j])

        def record(i, z):
            if collect_act_stats:
                act_absmax[i] = z.abs().amax().float()

        def weight(p, key):
            # int8 slots dequantize in the graph
            if key in p:
                return p[key]
            q = p["q" if key == "w" else "q2"]
            return q.to(compute_dtype) * p["scale"].to(compute_dtype)

        def conv(i, p, z, key, stride, pad):
            record(i, z)
            qk = "q" if key == "w" else "q2"
            if qk in p and "xs" in p:
                # int8 activations: the input quantized with its calibrated
                # scale, an exact int32 convolution, dequantized by
                # xs * the per-channel weight scale
                zq = torch.round(z.float() / p["xs"]).clamp(-127, 127).to(
                    torch.int8)
                y = int8_conv2d(zq, p[qk], stride, pad)
                sc = (p["xs"] * p["scale"]).to(compute_dtype)
                return y.to(compute_dtype) * sc.view(1, -1, 1, 1)
            dt = (torch.float32 if i in self.hi_prec_stages
                  else compute_dtype)
            return F.conv2d(z.to(dt), weight(p, key).to(dt), stride=stride,
                            padding=pad)

        def phase_max(y, p, info):
            # the four output phases are the pool window; then bias, act
            n, _, h, w = y.shape
            y = y.reshape(n, 4, info["filters"], h, w).amax(1)
            y = y + p["b"][:, None, None]
            return leaky(y) if info["act"] == "leaky" else y

        pair_los = () if collect_act_stats else tuple(
            lo for lo in self._pair_candidates() if fused(lo) and fused(lo + 2))
        for i, info in enumerate(self._plan):
            t = info["type"]
            p = params[i] if i < len(params) else {}
            s = state[i] if i < len(state) else {}
            prev = outputs[-1] if outputs else x_in
            if any(lo < i <= lo + 3 for lo in pair_los):
                x = prev              # consumed by the fused pair
            elif i in pair_los:
                x = self._run_pair(i, params, prev, compute_dtype)
            elif t == "convolutional" and fused(i):
                record(i, prev)
                y = fused_stem_stage(
                    prev.permute(0, 2, 3, 1).float().contiguous(),
                    p["w"].float(), p["b"].float(),
                    precision=self.stem_precision,
                    out_dtype=self._store_dtype(i, compute_dtype))
                x = y.permute(0, 3, 1, 2)
            elif t == "convolutional" and "wi" in p:
                # im2col: 16 stride-2 slices of the padded input, one product
                record(i, prev)
                dt = (torch.float32 if i in self.hi_prec_stages
                      else compute_dtype)
                h, w = prev.shape[2:]
                xp = F.pad(prev, (1, 1, 1, 1))
                z = torch.cat([xp[:, :, dy:dy + h:2, dx:dx + w:2]
                               for dy in range(4) for dx in range(4)], 1)
                x = phase_max(torch.einsum("nkhw,kd->ndhw", z.to(dt),
                                           p["wi"].to(dt)), p, info)
            elif t == "convolutional" and ("w2" in p or "q2" in p):
                x = phase_max(conv(i, p, space_to_depth(prev), "w2", 1, 1), p,
                              info)
            elif t == "maxpool" and (fused(i - 1) or transformed(i - 1)):
                x = prev              # the pool ran inside the fused stage
            elif t == "convolutional":
                x = conv(i, p, prev, "w", info["stride"],
                         (info["size"] - 1) // 2)
                if "gamma" in p and train:
                    x, new_state[i] = _train_bn(x, p, s)
                elif "gamma" in p:    # BN not folded away (eval mode)
                    x = (x - s["mean"][:, None, None]) * torch.rsqrt(
                        s["var"][:, None, None] + _BN_EPS)
                    x = (x * p["gamma"][:, None, None]
                         + p["beta"][:, None, None])
                else:
                    x = x + p["b"][:, None, None]
                if info["act"] == "leaky":
                    x = leaky(x)
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
                                img_dim, with_pred=train)
                if train:
                    x, pred = x
                    preds.append(pred)
                dets.append(x)
            if (t == "convolutional" and self.hi_prec_store is not None
                    and i in self.hi_prec_stages and not train
                    and i not in pair_los):
                # float32 arithmetic, compact storage (a pair's output is
                # already in its second stage's store type)
                x = x.to(self.hi_prec_store)
            outputs.append(x)
            if i == self.feature_tap:
                feature_map = x.permute(0, 2, 3, 1)
        # a truncated config (no yolo block) returns its last map, NHWC
        out = {"feature_map": feature_map,
               "detections": (torch.cat(dets, 1) if dets
                              else outputs[-1].permute(0, 2, 3, 1))}
        if train:
            # the feature tap and the decode carry no gradient (the
            # reference's .detach() of the tap)
            out.update(feature_map=feature_map.detach(),
                       detections=out["detections"].detach(), preds=preds,
                       state=new_state)
        if collect_act_stats:
            out["act_absmax"] = torch.stack(act_absmax)
        if collect_outputs:
            out["outputs"] = outputs
        return out

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

    def fold_s2d(self, folded_params):
        """The ``s2d_stages`` of a BN-folded parameter list in their
        space-to-depth form ({"w2", "b"}, see ``s2d_conv_weight``)."""
        out = list(folded_params)
        for i in self.s2d_stages:
            p = folded_params[i]
            if "w2" in p:
                continue
            if "b" not in p:
                raise ValueError("fold_batchnorm must run before fold_s2d")
            out[i] = {"w2": s2d_conv_weight(p["w"]), "b": p["b"]}
        return out

    def fold_im2col(self, folded_params):
        """The ``im2col_stages`` of a BN-folded parameter list in
        patch-product form ({"wi", "b"}, see ``im2col_stem_weight``)."""
        out = list(folded_params)
        for i in self.im2col_stages:
            p = folded_params[i]
            if "wi" in p:
                continue
            if "b" not in p:
                raise ValueError("fold_batchnorm must run before "
                                 "fold_im2col")
            out[i] = {"wi": im2col_stem_weight(p["w"]), "b": p["b"]}
        return out

    @property
    def anchors_per_scale(self):
        """Each YOLO block's anchors in pixels, in block order."""
        return [info["anchors"] for info in self._plan
                if info["type"] == "yolo"]

    @property
    def act_int8_skip(self):
        """Convolutions kept in float activations under int8 serving: the
        linear YOLO head convs, whose raw outputs feed the decode."""
        return tuple(i for i, info in enumerate(self._plan)
                     if info["type"] == "convolutional"
                     and info["act"] != "leaky")
