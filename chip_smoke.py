#!/usr/bin/env python3
"""Check the PyTorch port on one CUDA card: build the kernels, hold each
against its plain version, and serve requests end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and the result lines are
printed only when every phase passed:
  1. the card's name and power limit; TF32 off;
  2. build the CUDA kernels from ``millieye_torch/csrc`` (one nvcc each,
     all at once);
  3. each kernel (K1 NMS, K2 PS-RoIAlign, K3 RoIAlign, K4 stem pair)
     against its plain version on the card, at the serving shapes (batch
     1) and at batch 32: bit-equal (each plain version repeats its
     kernel's operations in the kernel's order); kernel, plain and
     library times (K2/K3: one bf16 einsum; K4: cuDNN), and the bound;
  4. ``FusionEngine`` at ``pallas_max_s01`` on
     ``artifacts/stage3_final.npz``: 16 requests (640x480 uint8 frames,
     radar points and proposals from a fixed seed); every kernel must
     have launched; the answers must be finite and bit-identical to the
     same engine's inside ``cuda_lib.plain_versions()``; p50 latency and
     frames/s; a
     ``torch.profiler`` pass over 4 more requests for the device time
     per request, its share of the wall time, and the top kernels;
  5. a ``kernels`` JSON line, then the contract line
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

CKPT = "artifacts/stage3_final.npz"
FRAME = (640, 480)
N_REQUESTS = 16
N_WARM = 4
HBM_BYTES_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_S = 989e12           # dense bf16 tensor cores
F32_FLOP_S = 67e12             # float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters):
    """Mean ms per call over ``iters`` calls between CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, flop_rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nms_inputs(rng, b, k):
    """Score-sorted boxes with clusters, exact duplicates and pairs whose
    float32 IoU sits on the other side of 0.5 than the exact IoU."""
    c = rng.uniform(0, 120, (b, k, 2))
    wh = rng.uniform(8, 60, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    m = 20000
    xy = rng.uniform(0, 5000, (m, 2))
    a = np.concatenate([xy, xy + rng.uniform(5, 30, (m, 2))], -1).astype(
        np.float32)
    d = (a[:, 2] - a[:, 0]) / 3 * (1 + rng.normal(0, 3e-7, m))
    bb = (a + np.stack([d, 0 * d, d, 0 * d], -1)).astype(np.float32)

    def iou(p, q, dt):
        p, q = p.astype(dt), q.astype(dt)
        inter = (np.maximum(np.minimum(p[:, 2], q[:, 2])
                            - np.maximum(p[:, 0], q[:, 0]), dt(0))
                 * np.maximum(np.minimum(p[:, 3], q[:, 3])
                              - np.maximum(p[:, 1], q[:, 1]), dt(0)))
        ua = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])
        ub = (q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1])
        return inter / (ua + ub - inter + dt(1e-16))

    edge = (iou(a, bb, np.float32) > 0.5) != (iou(a, bb, np.float64) > 0.5)
    a, bb = a[edge], bb[edge]
    n = min(k // 8, len(a) // b)
    for i in range(b):
        boxes[i, 0:2 * n:2] = a[i * n:(i + 1) * n]
        boxes[i, 1:2 * n:2] = bb[i * n:(i + 1) * n]
    dup = rng.choice(np.arange(k // 2, k), k // 8, replace=False)
    boxes[:, dup] = boxes[:, dup - 1]
    return boxes, rng.random((b, k)) < 0.9


def check_kernels(torch, engine_params, rng):
    """Phase 3: every kernel against its plain version at batch 1 and 32.
    Returns {name: record} for the kernels line."""
    from millieye_torch.ops import nms_kernel, roi_kernel, stem
    from millieye_torch.ops.roi_align import _batched_prep
    import torch.nn.functional as F

    dev = torch.device("cuda")
    bf = torch.bfloat16
    rec = {}

    def put(name, batch, **kw):
        rec.setdefault(name, {})[batch] = kw

    for b in (1, 32):
        # K1: NMS keep mask over the top-128 candidates
        boxes, valid = nms_inputs(rng, b, 128)
        tb = torch.tensor(boxes, device=dev)
        tv = torch.tensor(valid, device=dev)
        got = nms_kernel.nms_keep_mask_blocked(tb, tv, 0.5)
        want = nms_kernel.nms_keep_mask_blocked_plain(tb, tv, 0.5)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 NMS b{b}: keep bits differ in "
                                 f"{int((got != want).sum())} places")
        # IoUs the greedy pass needs: each kept row against the live rows
        # after it; ~14 float32 operations each
        keep = want.cpu().numpy()
        pairs = sum(int(valid[i, j + 1:].sum()) for i in range(b)
                    for j in np.flatnonzero(keep[i]))
        put("nms", b, err=0.0,
            ms=cuda_ms(torch, lambda: nms_kernel.nms_keep_mask_blocked(
                tb, tv, 0.5), 50),
            plain_ms=cuda_ms(torch, lambda: nms_kernel
                             .nms_keep_mask_blocked_plain(tb, tv, 0.5), 5),
            bound=bound_ms(b * 128 * (16 + 2), 14 * pairs, F32_FLOP_S),
            library_ms=None, library=None)

        # K2 / K3: RoI crops over 26x26 maps, 64 NMS + 32 radar rows. The
        # library yardstick is one einsum by.F.bx on the same bf16
        # operands (cuBLAS, float32 accumulation); it rounds t and its
        # output to bf16, so it is held to the plain version within 2% of
        # the output's largest magnitude.
        n, hw, ph, pw, c_out = 96, 26, 7, 7, 10
        xy = rng.uniform(-10, 380, (b, n, 2))
        rois = torch.tensor(np.concatenate(
            [xy, xy + rng.uniform(4, 300, (b, n, 2))], -1),
            dtype=torch.float32, device=dev)
        for name, c, ps in (("ps_roi_align", ph * 128, True),
                            ("roi_align", c_out, False)):
            feats = torch.tensor(rng.standard_normal((b, hw, hw, c)),
                                 dtype=bf, device=dev)
            by, bx = _batched_prep(rois, hw, hw, (ph, pw), 1 / 16,
                                   -0.5 if ps else 0.0, 0.1 if ps else 1.0,
                                   -1, 4)
            by, bx = by.to(bf).contiguous(), bx.to(bf).contiguous()
            if ps:
                kern = lambda: roi_kernel.ps_roi_align_padded_kernel(
                    feats, by, bx, c_out)
                plain = lambda: roi_kernel.ps_roi_align_padded_plain(
                    feats, by, bx, c_out)
                # the c_out*pw live lanes of each 128-lane block, as
                # [B, H, W, ph, c_out, pw]: all the kernel reads
                live = feats.view(b, hw, hw, ph, 128)[..., :c_out * pw] \
                    .unflatten(-1, (c_out, pw))
                library = lambda: torch.einsum("bnph,bhwpuq,bnqw->bnpqu",
                                               by, live, bx)
                used = b * hw * hw * ph * c_out * pw
                flops = 2 * b * n * ph * (hw * hw + hw) * c_out * pw
            else:
                kern = lambda: roi_kernel.roi_align_kernel(feats, by, bx)
                plain = lambda: roi_kernel.roi_align_plain(feats, by, bx)
                library = lambda: torch.einsum("bnph,bhwc,bnqw->bnpqc",
                                               by, feats, bx)
                used = feats.numel()
                flops = 2 * b * n * ph * (hw * hw + pw * hw) * c
            got, want = kern(), plain()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name} b{b}: not bit-equal to the "
                                     f"plain version (max error {err})")
            lib_err = float((library().float() - want).abs().max())
            if not lib_err <= 0.02 * float(want.abs().max()):
                raise AssertionError(f"{name} b{b}: the einsum yardstick "
                                     f"is off by {lib_err}")
            nbytes = (used + by.numel() + bx.numel()) * 2 + want.numel() * 4
            put(name, b, err=err, ms=cuda_ms(torch, kern, 50),
                plain_ms=cuda_ms(torch, plain, 10),
                bound=bound_ms(nbytes, flops, BF16_FLOP_S),
                library_ms=cuda_ms(torch, library, 50),
                library=f"one torch.einsum by.F.bx, bf16 (max error "
                        f"{lib_err:.3g} against the plain version)")

        # K4: the stem pair on 416 px frames, with the served weights
        p0, p2 = engine_params["darknet"][0], engine_params["darknet"][2]
        w0, b0, w1, b1 = p0["w"], p0["b"], p2["w"], p2["b"]
        x = torch.tensor(rng.uniform(0, 1, (b, 416, 416, 3)),
                         dtype=torch.float32, device=dev)
        got = stem.fused_stem_pair(x, w0, b0, w1, b1)
        want = stem.fused_stem_pair_plain(x, w0, b0, w1, b1)
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K4 stem b{b}: not bit-equal to the plain "
                                 f"version (max error {err})")
        wl0, wl1 = w0.to(bf), w1.to(bf)
        bl0, bl1 = b0.to(bf), b1.to(bf)
        xl = x.permute(0, 3, 1, 2).to(bf).contiguous(
            memory_format=torch.channels_last)

        def cudnn():
            y = F.max_pool2d(F.leaky_relu(F.conv2d(xl, wl0, bl0, padding=1),
                                          0.1), 2)
            return F.max_pool2d(F.leaky_relu(F.conv2d(y, wl1, bl1,
                                                      padding=1), 0.1), 2)

        flops = 2 * b * (416 * 416 * 16 * 27 + 208 * 208 * 32 * 144)
        nbytes = x.numel() * 4 + want.numel() * 2 + (w0.numel()
                                                     + w1.numel()) * 2
        put("stem_pair", b, err=err,
            ms=cuda_ms(torch, lambda: stem.fused_stem_pair(x, w0, b0, w1,
                                                           b1), 20),
            plain_ms=cuda_ms(torch, lambda: stem.fused_stem_pair_plain(
                x, w0, b0, w1, b1), 5),
            bound=bound_ms(nbytes, flops, BF16_FLOP_S),
            library_ms=cuda_ms(torch, cudnn, 20),
            library="cuDNN conv2d+bias+leaky+max_pool2d twice, bf16")
    return rec


def requests(rng, n):
    out = []
    for _ in range(n):
        frame = (rng.uniform(0, 1, (FRAME[1], FRAME[0], 3)) * 255).astype(
            np.uint8)
        pts = np.stack([rng.uniform(0, FRAME[0], 64),
                        rng.uniform(0, FRAME[1], 64), rng.uniform(1, 15, 64),
                        rng.uniform(-3, 3, 64)], -1)
        c = rng.uniform(60, 580, (6, 2))
        wh = rng.uniform(40, 200, (6, 2))
        out.append((frame, pts, np.concatenate([c - wh / 2, c + wh / 2], -1)))
    return out


def profile_requests(torch, engine, reqs):
    """Device time per request from a torch.profiler trace of ``reqs``:
    kernel time summed over the CUDA events, against the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for frame, pts, props in reqs:
            engine.infer(frame, pts, props)
        wall = (time.perf_counter() - t) * 1e3 / len(reqs)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kern) / 1e3 / len(reqs)
    n_launch = sum(e.count for e in kern) / len(reqs)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    log(f"profile over {len(reqs)} requests: device busy {dev:.3f} ms of "
        f"{wall:.2f} ms wall per request ({100 * dev / wall:.1f}%), "
        f"{n_launch:.0f} device activities per request (profiled wall "
        f"includes the profiler's overhead)")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / len(reqs):8.4f} ms/request"
            f"  x{e.count / len(reqs):g}  {e.key[:90]}")
    return {"device_ms_per_request": dev, "wall_ms_per_request": wall,
            "device_activities_per_request": n_launch}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from millieye_torch.cli._common import build_fusion
    from millieye_torch.device import set_numerics
    from millieye_torch.ops import cuda_lib, nms_kernel, roi_kernel, stem
    from millieye_torch.runtime.engine import FusionEngine

    t_start = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    set_numerics()
    log(card)

    t = time.time()
    logs = cuda_lib.build()
    log(f"build: {time.time() - t:.1f} s")
    for name, out in logs.items():
        for ln in out.splitlines():
            if "Used" in ln or "Compiling entry" in ln:
                log(f"  {name}: {ln.strip()}")

    kernels = {  # name -> (wrapper, source, the TPU kernel it replaces)
        "nms": (nms_kernel.nms_keep_mask_blocked, "millieye_torch/csrc/nms.cu",
                "millieye_tpu/ops/nms_pallas.py:229"),
        "ps_roi_align": (roi_kernel.ps_roi_align_padded_kernel,
                         "millieye_torch/csrc/roi_align.cu",
                         "millieye_tpu/ops/roi_pallas.py:439"),
        "roi_align": (roi_kernel.roi_align_kernel,
                      "millieye_torch/csrc/roi_align.cu",
                      "millieye_tpu/ops/roi_pallas.py:237"),
        "stem_pair": (stem.fused_stem_pair, "millieye_torch/csrc/stem.cu",
                      "millieye_tpu/ops/stem_pallas.py:941"),
    }

    model, params, state = build_fusion(CKPT, "pallas_max_s01")
    engine = FusionEngine(model, params, state, frame_size=FRAME)

    rng = np.random.default_rng(0)
    rec = check_kernels(torch, engine.params, rng)

    reqs = requests(rng, N_REQUESTS)
    for fn, *_ in kernels.values():
        fn.launches = 0
    answers, lat = [], []
    for i, (frame, pts, props) in enumerate(reqs):
        t = time.perf_counter()
        answers.append(engine.infer(frame, pts, props))
        lat.append(time.perf_counter() - t)
    launches = {name: fn.launches for name, (fn, *_) in kernels.items()}
    log(f"main path launches over {N_REQUESTS} requests: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    n_valid = []
    for i, (frame, pts, props) in enumerate(reqs):
        boxes, valid = answers[i]
        if boxes.shape != (model.cfg.max_det + model.cfg.max_radar, 6) \
                or not np.isfinite(boxes).all():
            raise AssertionError(f"request {i}: bad answer {boxes.shape}")
        with cuda_lib.plain_versions():
            ref = engine.infer(frame, pts, props)
        if not (np.array_equal(boxes, ref[0])
                and np.array_equal(valid, ref[1])):
            raise AssertionError(f"request {i}: kernels and plain versions "
                                 f"disagree\n{boxes[valid]}\n"
                                 f"{ref[0][ref[1]]}")
        n_valid.append(int(valid.sum()))
    timed = np.array(lat[N_WARM:]) * 1e3
    prof = profile_requests(torch, engine, reqs[:4])
    log(f"served {N_REQUESTS} requests at pallas_max_s01 (416 px, b1): "
        f"valid rows per answer {n_valid}; every answer bit-identical to "
        f"the same engine's inside cuda_lib.plain_versions()")
    log(f"latency over the last {len(timed)} requests: p50 "
        f"{np.median(timed):.2f} ms, max {timed.max():.2f} ms, "
        f"{1e3 / timed.mean():.1f} frames/s (host clock, each request "
        f"ends in a copy to the host)")

    line = []
    for name, (fn, src, replaces) in kernels.items():
        for b, r in rec[name].items():
            lib = ("none (no single PyTorch call computes it)"
                   if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms ({r['library']})")
            log(f"kernel {name} b{b}: max_abs_err {r['err']:.3g}, "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound'][0]:.6f} ms ({r['bound'][1]}), library {lib}, "
                f"launches on the main path {launches[name]} "
                f"({launches[name] / N_REQUESTS:g} per request)")
        r1, r32 = rec[name][1], rec[name][32]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r1["err"], "ms": r1["ms"],
            "plain_ms": r1["plain_ms"], "bound_ms": r1["bound"][0],
            "bound_by": r1["bound"][1], "library_ms": r1["library_ms"],
            "b32": {"max_abs_err": r32["err"], "ms": r32["ms"],
                    "plain_ms": r32["plain_ms"], "bound_ms": r32["bound"][0],
                    "bound_by": r32["bound"][1],
                    "library_ms": r32["library_ms"]}})
    log(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": line, "card": card,
                      "requests": N_REQUESTS,
                      "p50_ms": float(np.median(timed)),
                      "fps": float(1e3 / timed.mean()), "profile": prof}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
