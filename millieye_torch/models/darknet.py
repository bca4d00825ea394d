"""cfg-driven Darknet (tiny-YOLOv3, YOLOv3 on Darknet-53, YOLOv4 on
CSPDarknet53) (port of ``millieye_tpu/models/darknet.py``, which runs the
first two).

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

A convolution's activation is ``linear``, ``leaky`` or ``mish``
(``ops/epilogue.py:ACTS``); another raises. A stride-1 max pool of odd
size k pads k // 2 on every side with -inf and keeps the size (darknet's
``maxpool_layer``: YOLOv4's SPP); the size-2 one pads right and bottom
with zeros, as the reference does. A ``yolo`` block's ``scale_x_y`` s
(default 1) maps the centre's sigmoid to ``sigmoid * s - (s - 1) / 2``.

The config settles, once when the model is built, each block's kind (a
plain convolution, a stem stage's form and its pool, or its type), the
stem pairs and whether K15 takes each convolution's shapes
(``ops/conv.py:takes_form``); a call asks the rest once (``_call_kinds``:
a stage's slots, ``train``, ``collect_act_stats``). A plain convolution
block (``_conv_block``) on the card's kernels (``on_card``) runs a
float32 convolution K15 takes as ``conv2d_nhwc`` and its tail (batch
norm's affine step with the running statistics or the folded bias, then
the activation) as K14, ``conv_epilogue``; elsewhere ``F.conv2d`` and
``epilogue_eager``, the same bits. Inside a profiler session the
backbone counts ``darknet.convs`` (the plain convolution blocks an
``apply`` runs), ``darknet.conv_kernel`` (those whose convolution
launched K15) and ``darknet.epilogue`` (those whose tail launched K14),
and a model with Mish ``darknet.mish`` and ``darknet.epilogue_mish``
(the same two of its Mish blocks); the span ``millieye.spp`` holds an
SPP's pools and their route.

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

import contextlib

import torch
import torch.nn.functional as F

from millieye_torch.device import constant, per_tensor
from millieye_torch.io.checkpoint import to_device
from millieye_torch.io.config import parse_model_config
from millieye_torch.ops import conv as kconv
from millieye_torch.ops import epilogue as epi
from millieye_torch.ops.quantize import int8_conv2d
from millieye_torch.ops.stem import (fused_stem_pair, fused_stem_pair_packed,
                                     fused_stem_pair_s2d,
                                     fused_stem_pair_select, fused_stem_stage)
from millieye_torch.parallel import collectives as pc
from millieye_torch.runtime.profiler import count, trace_annotation

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


def _maxpool(x, size, stride):
    if size == 2 and stride == 1:
        # the reference pads right/bottom with ZEROS (nn.ZeroPad2d), not
        # -inf: where every border activation is negative the max is 0
        x = F.pad(x, (0, 1, 0, 1))
    elif stride == 1 and size % 2:
        # darknet's maxpool_layer: size // 2 on every side, -inf
        return F.max_pool2d(x, size, 1, padding=size // 2)
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


def decode_yolo(raw, anchors, num_classes, img_dim, with_pred=False,
                scale_x_y=1.0):
    """One YOLO scale: raw [N, A*(5+C), G, G] conv output (any dtype) ->
    detections [N, A*G*G, 5+C] float32 (float64 from float64) in image
    scale, anchor-major then row then column; ``with_pred`` also returns
    pred [N, A, G, G, 5+C] (sigmoid x, y, raw w, h, sigmoid conf and
    classes), what the loss reads. ``scale_x_y`` s (YOLOv4) takes the
    centre's sigmoid to ``sigmoid * s - (s - 1) / 2`` before the grid
    offset, in pred too; at 1 nothing is computed for it."""
    n, g = raw.shape[0], raw.shape[2]
    a = len(anchors)
    f = 5 + num_classes
    raw = raw.permute(0, 2, 3, 1).reshape(n, g, g, a, f).permute(0, 3, 1, 2, 4)
    raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
    stride = img_dim / g
    anc = constant(tuple(map(tuple, anchors)), raw.device)
    xy = torch.sigmoid(raw[..., 0:2])
    if scale_x_y != 1:
        xy = xy * scale_x_y - (scale_x_y - 1) / 2
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


def _bn_inv(var):
    """``rsqrt(var + eps)`` of a running variance, as eval-mode batch norm
    scales by it: made once per variance tensor (``device.per_tensor``),
    so that an inference step launches nothing for it."""
    return per_tensor(var, _rsqrt_eps)


def _rsqrt_eps(var):
    return torch.rsqrt(var + _BN_EPS)


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


def on_card(x, p, s):
    """Whether a plain convolution block on input ``x`` with parameters
    ``p`` and state ``s`` runs on the card's kernels, K15 where its form
    holds and K14: ``x`` on the card, and no gradient wanted from it or
    its slots (the ops have no backward). The one question the block
    asks of its tensors."""
    return x.is_cuda and not (torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for d in (p, s)
                               for t in d.values())))


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
        self._spp = self._spp_blocks()
        self._mish = any(info.get("act") == "mish" for info in self._plan)
        self._validate_stem_stages()
        if self.stem_pair:
            lo = self.stem_stages[0] if self.stem_stages else 0
            if (lo, lo + 2) != self.stem_stages[:2]:
                raise ValueError("stem_pair needs two consecutive fused "
                                 "stages (lo, lo+2) in stem_stages, got "
                                 f"{self.stem_stages}")
        self._pairs = self._pair_candidates()
        for lo in self._pairs:
            self._validate_stem_pair(lo)
        # each block's kind: its type, or a stage's form and "pass" for
        # its pool, which runs inside the stage (``_call_kinds``)
        self._kinds = [info["type"] for info in self._plan]
        for kind, stages in (("stem", self.stem_stages),
                             ("s2d", self.s2d_stages),
                             ("im2col", self.im2col_stages)):
            for i in stages:
                self._kinds[i:i + 2] = kind, "pass"
        self._k15 = [info["type"] == "convolutional" and kconv.takes_form(
            info["in_ch"], info["size"], info["size"], info["stride"],
            (info["size"] - 1) // 2) for info in self._plan]

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
                if info["act"] not in epi.ACTS:
                    raise ValueError(f"block {len(plan)}: unknown activation "
                                     f"{info['act']!r} (have "
                                     f"{', '.join(epi.ACTS)})")
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
                if "scale_x_y" in block:
                    info["scale_x_y"] = float(block["scale_x_y"])
                out = channels[-1]
            else:
                raise ValueError(f"unknown block type {t!r}")
            plan.append(info)
            channels.append(out)
        return plan

    def _spp_blocks(self):
        """{first block: last block} of each SPP: from a stride-1 max pool
        of odd size above 1 to the first route that reads it."""
        spans, i = {}, 0
        while i < len(self._plan):
            info = self._plan[i]
            if (info["type"] == "maxpool" and info["stride"] == 1
                    and info["size"] % 2 and info["size"] > 1):
                end = next((j for j in range(i + 1, len(self._plan))
                            if i in self._plan[j].get("layers", ())), i)
                spans[i] = end
                i = end
            i += 1
        return spans

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

    def _call_kinds(self, params, train, collect_act_stats):
        """Each block's kind in this call: a stage runs its form where its
        parameters carry the form's slots (a fused stage's folded ``w``,
        only at inference: the kernels have no backward; ``w2`` or ``q2``;
        ``wi``), else as a plain convolution and its pool; two fused
        stages of a pair run as one kernel, except while collecting
        activation statistics."""
        kinds = list(self._kinds)
        for i in self.stem_stages + self.s2d_stages + self.im2col_stages:
            p = params[i]
            if not (kinds[i] == "stem" and not train and "w" in p
                    and "gamma" not in p
                    or kinds[i] == "s2d" and ("w2" in p or "q2" in p)
                    or kinds[i] == "im2col" and "wi" in p):
                kinds[i:i + 2] = "convolutional", "maxpool"
        if not collect_act_stats:
            for lo in self._pairs:
                if kinds[lo] == kinds[lo + 2] == "stem":
                    kinds[lo:lo + 4] = "pair", "pass", "pass", "pass"
        return kinds

    def _stem_stage(self, i, p, x, compute_dtype):
        """Fused stem stage i as one launch of kernel K9."""
        y = fused_stem_stage(x.permute(0, 2, 3, 1).float().contiguous(),
                             p["w"].float(), p["b"].float(),
                             precision=self.stem_precision,
                             out_dtype=self._store_dtype(i, compute_dtype))
        return y.permute(0, 3, 1, 2)

    def _im2col_stage(self, i, p, x, compute_dtype):
        """im2col stage i: 16 stride-2 slices of the padded input, one
        product with ``wi``."""
        dt = torch.float32 if i in self.hi_prec_stages else compute_dtype
        h, w = x.shape[2:]
        xp = F.pad(x, (1, 1, 1, 1))
        z = torch.cat([xp[:, :, dy:dy + h:2, dx:dx + w:2]
                       for dy in range(4) for dx in range(4)], 1)
        return self._phase_max(i, p, torch.einsum(
            "nkhw,kd->ndhw", z.to(dt), p["wi"].to(dt)))

    def _phase_max(self, i, p, y):
        """The max over stage i's four output phases (the pool window),
        then its bias and activation."""
        n, _, h, w = y.shape
        y = y.reshape(n, 4, self._plan[i]["filters"], h, w).amax(1)
        return epi.epilogue_eager(y, p["b"], act=self._plan[i]["act"])

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
        act_absmax = ([torch.zeros((), device=images.device)] * len(self._plan)
                      if collect_act_stats else None)
        kinds = self._call_kinds(params, train, collect_act_stats)
        convs, launches = 0, epi.conv_epilogue.launches
        conv_launches = kconv.conv2d_nhwc.launches
        mish, mish_launches = 0, 0
        spp_end = None
        with trace_annotation("millieye.backbone"), \
                contextlib.ExitStack() as spp:
            for i, (info, kind) in enumerate(zip(self._plan, kinds)):
                if i in self._spp:
                    spp.enter_context(trace_annotation("millieye.spp"))
                    spp_end = self._spp[i]
                p = params[i] if i < len(params) else {}
                prev = outputs[-1] if outputs else x_in
                if collect_act_stats and info["type"] == "convolutional":
                    act_absmax[i] = prev.abs().amax().float()
                if kind == "convolutional":
                    before = epi.conv_epilogue.launches
                    x = self._conv_block(i, prev, p, new_state,
                                         compute_dtype, train)
                    convs += 1
                    if info["act"] == "mish":
                        mish += 1
                        mish_launches += epi.conv_epilogue.launches - before
                elif kind == "pass":
                    x = prev          # a fused pair or stage ran this block
                elif kind == "pair":
                    x = self._run_pair(i, params, prev, compute_dtype)
                elif kind == "stem":
                    x = self._stem_stage(i, p, prev, compute_dtype)
                elif kind == "s2d":
                    x = self._phase_max(i, p, self._conv(
                        i, p, space_to_depth(prev), "w2", 1, 1, compute_dtype))
                elif kind == "im2col":
                    x = self._im2col_stage(i, p, prev, compute_dtype)
                elif kind == "maxpool":
                    x = _maxpool(prev, info["size"], info["stride"])
                elif kind == "upsample":
                    f = info["factor"]
                    x = prev.repeat_interleave(f, 2).repeat_interleave(f, 3)
                elif kind == "route":
                    x = torch.cat([outputs[l] for l in info["layers"]], 1)
                elif kind == "shortcut":
                    x = prev + outputs[info["frm"]]
                elif kind == "yolo":
                    x = decode_yolo(prev, info["anchors"], info["classes"],
                                    img_dim, with_pred=train,
                                    scale_x_y=info.get("scale_x_y", 1.0))
                    if train:
                        x, pred = x
                        preds.append(pred)
                    dets.append(x)
                if (info["type"] == "convolutional"
                        and self.hi_prec_store is not None
                        and i in self.hi_prec_stages and not train
                        and kind != "pair"):
                    # float32 arithmetic, compact storage (a pair's output is
                    # already in its second stage's store type)
                    x = x.to(self.hi_prec_store)
                outputs.append(x)
                if i == self.feature_tap:
                    feature_map = x.permute(0, 2, 3, 1)
                if i == spp_end:
                    spp.close()
            # the plain convolution blocks, those that ran K15 and those
            # whose tail ran K14
            count("darknet.convs", convs)
            count("darknet.epilogue", epi.conv_epilogue.launches - launches)
            count("darknet.conv_kernel",
                  kconv.conv2d_nhwc.launches - conv_launches)
            if self._mish:
                count("darknet.mish", mish)
                count("darknet.epilogue_mish", mish_launches)
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

    def _conv_block(self, i, x, p, state, compute_dtype, train):
        """Plain convolution block i on ``x``: ``_conv``, then the tail:
        batch norm on the batch's statistics (``state[i]`` takes the new
        running ones) or the bias in training, batch norm's affine step
        with the running statistics or the folded bias at inference, then
        the activation. ``on_card`` decides whether K15 and K14 run."""
        s = state[i] if i < len(state) else {}
        card = not train and on_card(x, p, s)
        info = self._plan[i]
        y = self._conv(i, p, x, "w", info["stride"], (info["size"] - 1) // 2,
                       compute_dtype, card and self._k15[i])
        if train and "gamma" in p:
            y, state[i] = _train_bn(y, p, s)
            return epi.activate(y, info["act"])
        vecs = ((p["beta"], s["mean"], _bn_inv(s["var"]), p["gamma"])
                if "gamma" in p else (p["b"],))
        if card:
            return epi.conv_epilogue(y, *vecs, act=info["act"])
        return epi.epilogue_eager(y, *vecs, act=info["act"])

    def _conv(self, i, p, z, key, stride, pad, compute_dtype, k15=False):
        """Block i's convolution of ``z`` with the slot ``key`` ("w", or
        an s2d stage's "w2"): int8 x int8 -> int32 on an int8 slot with an
        input scale ``xs``, dequantized; else in the block's dtype on the
        weights (an int8 slot dequantized), as K15 where ``k15`` holds for
        float32 and float weights."""
        qk = "q" if key == "w" else "q2"
        if qk in p and "xs" in p:
            zq = torch.round(z.float() / p["xs"]).clamp(-127, 127).to(
                torch.int8)
            y = int8_conv2d(zq, p[qk], stride, pad)
            sc = (p["xs"] * p["scale"]).to(compute_dtype)
            return y.to(compute_dtype) * sc.view(1, -1, 1, 1)
        dt = torch.float32 if i in self.hi_prec_stages else compute_dtype
        w = (p[key] if key in p
             else p[qk].to(compute_dtype) * p["scale"].to(compute_dtype))
        z, w = z.to(dt), w.to(dt)
        if k15 and key in p and dt == torch.float32:
            return kconv.conv2d_nhwc(z, w, stride, pad)
        return F.conv2d(z, w, stride=stride, padding=pad)

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
                     and info["act"] == "linear")
