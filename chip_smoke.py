#!/usr/bin/env python3
"""Check the PyTorch port on one CUDA card: build the kernels, hold each
against its plain version, and serve requests end to end on every path
the port has.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and the result lines are
printed only when every phase passed:
  1. the card's name and power limit; TF32 off;
  2. build the CUDA kernels from ``millieye_torch/csrc`` (one nvcc each,
     all at once);
  3. each kernel wrapper against its plain version on the card, at the shapes
     the serving paths give it, at batch 1 and 32: K1 blocked NMS, K2 padded
     PS-RoIAlign (and its ``reduce="vpu"`` wrapper), K3 RoIAlign, the stem pair
     as K4, K8 (hi/lo pool select), K11 and K12, K12's deep pair (stages 4+6),
     K5 whole-matrix NMS (K1 and K5 on knife-edge inputs, each case also with
     its device time per call from the profiler and the cluster size its launch
     takes), K6 PS-RoIAlign on the unpadded float32 map, K7 padded PS-RoIAlign
     on float32 operands, K9 single stem stage, K10 (the NHWC stage, "vconcat"
     and "im2col" tap orders) at stages 0 and 2 and at block 8's shape (its
     streamed route), K13 (stochastic int8) on block 12's weight and on the
     (8, 128) carrier, each K10 and K13 case with its device time a call, and
     K13 on ragged, 70000-tile, zero, -0.0, inf and NaN inputs; K2, K3 (bf16
     and float32 "highest"), K6 ("upq", "default") and K7 ("highest") also
     with every RoI the whole frame, K3 also at "split"; K9's "highest" and
     K10's lines with their mul-then-add ceiling; the pairs at "default"
     and "highest": bit-equal (each plain version repeats its kernel's
     operations in the kernel's order), except the stem pair, the deep pair and
     K9 at "default", which run on the tensor cores and are held within 2^-6 of
     their plain versions' largest output, the exact share reported; kernel,
     plain and library times (the median of 5 repeats of the timing loop, with
     the spread), and the bound; the deep pair at "highest" also against a
     float64 evaluation of its function (its error at most twice the plain
     version's); how many outputs K8 moves against K4 on the same inputs; K13's
     statistics (benchmarks/quantize_tpu_check.py's checks); block 12's int8 x
     int8 -> int32 convolution bit-equal on the card and the CPU, timed against
     cuDNN float32; deep_stage_kernel ("highest" through the deep pair,
     "default" through K9 at Cin 272) and the CUDA-core deep pair, each just
     under and past the batch its grid once capped (16384 and 65536
     images of a 4x4 map), held to their plain versions;
  4. the serving paths on ``artifacts/stage3_final.npz``, 8 requests or calls
     each at batch 1 (640x480 uint8 frames, radar points and proposals from a
     fixed seed): ``FusionEngine.infer`` at ``pallas_max_s01``,
     ``pallas_max4``, ``pallas_stem`` and ``pallas_max4`` with
     ``roi_precision="highest"``; ``entry()``; ``build_refine`` +
     ``RefineNetwork.apply``; ``FusionEngine.infer`` at ``pallas_stem2``,
     ``pallas_max_pk``, ``pallas_pair2``, ``pallas_deep`` and ``pallas_lat``;
     ``f32``, ``s2d``, ``bf16_s2d``, ``int8`` and ``int8_acts`` (calibrated
     with ``cli/demo.py:calibrate`` on the 8 frames), ``s2d``'s answers held to
     ``f32``'s by box, the int8 rows' distance to them reported; the direct ops
     K10 (on each letterboxed frame, held to cuDNN's float32 stage, and once at
     block 8's served weights, 128 input channels) and K13
     (the carrier, seeds 0 and 1), as their only JAX callers run them; and one
     ``batched_step_fn`` window of the 8 frames at ``pallas_max4`` and one at
     ``f32``, each with its post-merge NMS one K5 launch, bit-identical to the
     same NMS frame by frame on its recorded inputs; then K1 and K5 again on
     the serving shape: valid a prefix of the live rows that P1, P2 and the
     window fed them (recorded through both NMS passes), at batch 1 and 32. The
     launch counts are set to 0 before each path and read after it; every
     kernel the path (or direct op) names must have launched on every request;
     the answers, the window's too, must be finite, of the right shape and
     bit-identical to the same path inside ``cuda_lib.plain_versions()``, or,
     for a path that runs a tensor-core kernel, bit-identical to the same path
     inside ``cuda_lib.plain_versions(keep=stem.TENSOR_CORE_KERNELS)`` (every
     other kernel's plain version) and within ``PAIR_PATH_TOL`` of the fully
     plain path, or beyond it by NMS decisions alone, proven on the recorded
     inputs of both NMS passes (``nms_flips``); the window's answers (held the
     same way) must also equal the per-frame answers (matched by box within a
     stated tolerance, with at most one row of a frame on one side only, where
     the batch-8 convolutions sum in another order); the ``f32`` window to the
     reference's contract (tests/test_runtime.py:147-150: ``valid`` equal, rows
     within rtol 1e-4 and atol 1e-4 of the per-frame answers); p50 latency per
     path; then one request at each alias row (buffering-only or same-function
     twins of the rows above), its launches checked and its answer
     bit-identical to its twin's; a ``torch.profiler`` pass over 4 more
     requests at ``pallas_max_s01``, ``pallas_max4``, ``pallas_pair2``,
     ``pallas_deep``, ``pallas_max4`` with ``roi_precision="highest"``,
     ``pallas_stem`` and the refine path, and over 2 windows;
  5. the recorded-session demo path: a 96-frame recording (640x480 frames
     from a seed, three walkers and clutter in the radar at 20 fps, written
     with numpy and pickle) through the radar host chain at the demo's
     defaults and ``StreamingPipeline``. P15, ``run`` at
     ``pallas_max_s01``: lossless, every frame bit-identical to
     ``FusionEngine.infer`` fed by a second ``RadarPipeline``, K4, K1, K2,
     K3 and K5 once a frame; the live mode's frames + dropped = 96, each
     delivered frame the lossless answer; no host sync inside the step
     (``torch.cuda.set_sync_debug_mode("error")``) and, in a profiled run,
     no more than the drain's two fetches a frame; P16, ``run_batched``
     at ``pallas_max4`` in windows of 32 over 90 frames (the last padded):
     each window bit-identical to ``batched_step_fn`` on the stacked
     arrays and held to its plain versions as the batched window above,
     the staged replay bit-identical to the host-fed windows, K5 once a
     window; against the per-frame answers each frame within
     ``WINDOW_TOL``, or within ``PAIR_PATH_TOL`` (the bf16 class: at batch
     32 cuDNN moves some boxes 0.5-0.65 px), or beyond it by NMS decisions
     alone (``window_flips``), the count of each reported;
     each with frames, e2e_fps, the ``StageTimer`` report, drops, the host
     ms of the radar chain, the DBSCAN and Hungarian backends and the
     device's busy share in one profiled run;
  6. a ``kernels`` JSON line, then the contract line
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

CKPT = "artifacts/stage3_final.npz"
FRAME = (640, 480)
N_REQUESTS = 8
N_WARM = 2
N_REPEATS = 5                  # repeats of each timing loop
HBM_BYTES_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_S = 989e12           # dense bf16 tensor cores
F32_FLOP_S = 67e12             # float32 outside the tensor cores
INT8_OP_S = 1979e12            # dense int8 tensor cores
# batch-8 against batch-1 rows: cuDNN sums a batch-8 convolution in another
# order, which moves boxes and scores a little and may carry a row across
# a threshold (at most ``flipped`` rows of a frame on one side only)
WINDOW_TOL = dict(box=0.5, score=2e-2, flipped=1)
# a path that runs a tensor-core kernel against its fully plain run: the
# pair perturbs a bf16 network at its first layer, and one bf16 ulp of a
# head's regression output moves a box by up to ~1 px, so boxes are held
# at the bf16 class of tests/test_torch_fusion.py (TOL["pallas_*"]: 1 px,
# scores 0.02; WINDOW_TOL's 0.5 px was exceeded, 0.57 px on one row of
# pallas_max4, on an H100)
# An answer beyond it passes only where ``nms_flips`` proves that the two
# runs differ by NMS decisions alone: each run's NMS passes are the plain
# NMS of their own inputs, and the answers meet within it once one run
# takes the other's decisions
PAIR_PATH_TOL = dict(WINDOW_TOL, box=1.0)
BF16_TOL = 0.04   # a bf16 library yardstick against a plain version, as a
                  # share of the output's largest magnitude


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters, repeats=N_REPEATS):
    """ms per call: the median over ``repeats`` runs of a loop of
    ``iters`` calls between CUDA events, after a warm-up call. Returns
    (median, least, most)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs)), min(runs), max(runs)


def host_ms(torch, fn, calls=50):
    """Host time per call of ``fn``: ``calls`` calls enqueued without a
    synchronisation between them (the device queue does not fill), on the
    host's clock; what floors the loop time of a kernel that is faster
    than its launch."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def device_ms(torch, fn, calls=20):
    """Device time per call of ``fn``: in a ``torch.profiler`` trace of
    ``calls`` calls (after a warm-up call), for each kernel the mean time
    of its records times the records it has a call (at least one), summed
    over the kernels, so a wrapper that launches two kernels (K13's two
    passes; K9's weight copy before its kernel) counts both. The mean is
    over the records the profiler kept: late in a long process it drops
    some or all of a short trace's device records (on an H100, 3 or 4 of
    20, or all 20, in this script's last NMS phase), which a sum divided
    by ``calls`` would read as a faster kernel. A trace that kept none is
    taken again; after three,
    the time comes from CUDA events around ``calls`` calls queued behind
    a spin kernel: the host enqueues them while the card spins, so the
    events time the card alone, the gaps between kernels included.
    Returns (ms, records kept; 0 for the events' time). The loop of
    ``cuda_ms`` also times the host's launch, which floors a small
    kernel's time at batch 1."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        kept = sum(e.count for e in kern)
        if kept:
            return (sum(e.self_device_time_total / e.count
                        * max(1, round(e.count / calls)) for e in kern)
                    / 1e3, kept)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # ~25 ms, far longer than the enqueue
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, 0


def bound_ms(nbytes, flops, flop_rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def crop_flops(by, bx, t_lanes, out_lanes, precision="highest"):
    """Operations a separable RoI crop needs on this run's weights, and
    the rate they run at: the products on the nonzero support (per
    (image, RoI, bin row) the span of nonzero by[p, :], per (image, RoI)
    the span of columns where some bx[q, :] is nonzero; the terms outside
    are exact zeros), ``t_lanes`` lanes of t and ``out_lanes`` outputs per
    bin row. "highest" counts its products at the float32 rate; "default"
    one bf16 product, "split" three for t and two for the w-sum, at the
    bf16 tensor-core rate."""
    from millieye_torch.ops.roi_kernel import _span_mask
    ny = _span_mask(by != 0).sum(-1).double()                # [B, N, P]
    nx = _span_mask((bx != 0).any(2)).sum(-1, keepdim=True).double()
    s1 = 2 * float((ny * nx).sum()) * t_lanes
    s2 = 2 * float(nx.sum()) * by.shape[2] * out_lanes
    if precision == "split":
        return 3 * s1 + 2 * s2, BF16_FLOP_S
    return s1 + s2, F32_FLOP_S if precision == "highest" else BF16_FLOP_S


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


def cudnn_stem(torch, x, stages, dtype):
    """The library yardstick of the stem kernels: cuDNN conv2d + bias +
    leaky_relu + max_pool2d per stage on channels_last operands in
    ``dtype``; x NHWC, weights OIHW; returns a callable giving NHWC."""
    import torch.nn.functional as F
    xl = x.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)
    ws = [(w.to(dtype), bs.to(dtype)) for w, bs in stages]

    def run():
        y = xl
        for w, bs in ws:
            y = F.max_pool2d(F.leaky_relu(F.conv2d(y, w, bs, padding=1), 0.1),
                             2)
        return y.permute(0, 2, 3, 1)
    return run


def stochastic_stats(q, scale):
    """benchmarks/quantize_tpu_check.py's checks on the (8, 128) carrier:
    0.3 at scale 1/127 is 38.1 steps. Returns (mean of the dequantized
    body, P(39)); raises where a check fails."""
    body = q[1:].double() * float(scale)
    steps = set(q[1:].unique().tolist())
    if steps != {38, 39}:
        raise AssertionError(f"K13 carrier: steps {steps}, want 38 and 39")
    mean, p39 = float(body.mean()), float((q[1:] == 39).double().mean())
    if not abs(mean - 0.3) < 0.003 or q[0, 0] != 127:
        raise AssertionError(f"K13 carrier: mean {mean}, q[0, 0] {q[0, 0]}")
    return mean, p39


class KernelChecks:
    """Phase 3. ``records[name]`` lists one dict per (case, batch): the
    case's label, max_abs_err against the plain version, times, bound and
    library time."""

    def __init__(self, torch, rng):
        self.torch, self.rng = torch, rng
        self.dev = torch.device("cuda")
        self.records = {}
        self.k8_vs_k4 = []     # (batch, outputs that differ, outputs)

    def case(self, name, label, batch, kern, plain, nbytes, flops, rate,
             library=None, lib_note=None, lib_tol=None, iters=20, tol=None,
             f64=None, device=False, note=None):
        """Hold ``kern()`` bit-equal to ``plain()`` or, with ``tol``, within
        ``tol`` of the plain version's largest magnitude (the share of
        outputs that are bit-equal is recorded); with ``f64``, a float64
        evaluation of the function, the kernel's largest error against it
        at most twice the plain version's; time both and the library
        call, and record the bound; with ``device``, also the kernel's
        device time per call from the profiler and the host's time to
        launch it."""
        torch = self.torch
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        exact = float((got == want).double().mean()) \
            if got.shape == want.shape else 0.0
        if tol is None:
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} {label} b{batch}: not "
                                     f"bit-equal to the plain version (max "
                                     f"error {err})")
        elif (got.dtype != want.dtype or got.shape != want.shape
              or not err <= tol * float(want.float().abs().max())):
            raise AssertionError(f"{name} {label} b{batch}: off the plain "
                                 f"version by {err}, beyond {tol:.3g} of its "
                                 f"largest magnitude")
        err64 = None
        if f64 is not None:
            ref = f64()
            err64 = (float((got.double() - ref).abs().max()),
                     float((want.double() - ref).abs().max()))
            if not err64[0] <= 2 * err64[1]:
                raise AssertionError(f"{name} {label} b{batch}: off the "
                                     f"float64 function by {err64[0]}, more "
                                     f"than twice the plain version's "
                                     f"{err64[1]}")
        lib_ms = lib_err = scale = None
        if library is not None:
            lib_err = float((library().float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            if not lib_err <= lib_tol * scale:
                raise AssertionError(f"{name} {label} b{batch}: the library "
                                     f"yardstick is off by {lib_err} "
                                     f"(largest value {scale})")
            lib_ms = cuda_ms(torch, library, iters)
        rec = dict(case=label, batch=batch, err=err, tol=tol, exact=exact,
                   err64=err64,
                   scale=float(want.float().abs().max()),
                   ms=cuda_ms(torch, kern, iters),
                   plain_ms=cuda_ms(torch, plain, 1, 3),
                   bound=bound_ms(nbytes, flops, rate), library_ms=lib_ms,
                   device_ms=(device_ms(torch, kern) if device
                              else (None, None)),
                   host_ms=host_ms(torch, kern) if device else None,
                   note=note,
                   library=None if library is None else
                   f"{lib_note} (max error {lib_err:.3g} against the plain "
                   f"version, largest value {scale:.3g})")
        self.records.setdefault(name, []).append(rec)

    # ------------------------------------------------------------- NMS
    def nms(self, b, live=None):
        """K1 at 128, 256 and 512 candidates, K5 at 512, 135, 96 and 232
        (the post-merge NMS of 64 + 32 and 200 + 32 rows), on knife-edge
        inputs (90% of the rows valid, the last ones too: the worst case);
        with ``live``, {(name, K): [rows]} the live counts a serving path
        gave that kernel at that K, the same boxes with valid a prefix of
        those counts instead (image i takes count i mod their number;
        labelled "serving"; at batch 1 the median count). The plain
        versions also against the sequential golden; each case's device
        time from the profiler and the cluster size its launch takes."""
        from millieye_torch.ops import nms_kernel
        from millieye_torch.ops.nms import nms_keep_mask_ref
        torch = self.torch
        for name, kern, plain, ks in (
                ("nms", nms_kernel.nms_keep_mask_blocked,
                 nms_kernel.nms_keep_mask_blocked_plain, (128, 256, 512)),
                ("nms_full", nms_kernel.nms_keep_mask_full,
                 nms_kernel.nms_keep_mask_full_plain, (512, 135, 96, 232))):
            for k in ks:
                if live is not None and (name, k) not in live:
                    continue
                boxes, valid = nms_inputs(self.rng, b, k)
                label = f"K={k}"
                if live is not None:
                    n = sorted(live[name, k])
                    n = [n[len(n) // 2]] if b == 1 else n      # the median
                    valid = np.arange(k)[None] < np.array(
                        [n[i % len(n)] for i in range(b)])[:, None]
                    label += (f" serving, live rows {n[0]}" if b == 1 else
                              f" serving, live rows {min(n)}-{max(n)}")
                tb = torch.tensor(boxes, device=self.dev)
                tv = torch.tensor(valid, device=self.dev)
                want = plain(tb, tv, 0.5)
                for i in range(min(b, 4)):   # the sequential golden
                    if not torch.equal(want[i], nms_keep_mask_ref(
                            tb[i], tv[i], 0.5)):
                        raise AssertionError(f"{name} {label} b{b}: the "
                                             f"plain version differs from "
                                             f"the golden on image {i}")
                # the rows each image needs: those up to its last valid one
                n_live = [int(np.flatnonzero(v)[-1]) + 1 if v.any() else 0
                          for v in valid]
                # bytes: valid read and keep written for all K rows, the
                # boxes of the live rows only; IoUs the greedy answer
                # needs: each kept row against the live rows after it,
                # ~14 float32 operations each
                keep = want.cpu().numpy()
                pairs = sum(int(valid[i, j + 1:].sum()) for i in range(b)
                            for j in np.flatnonzero(keep[i]))
                self.case(name, label, b,
                          lambda: kern(tb, tv, 0.5),
                          lambda: plain(tb, tv, 0.5),
                          2 * b * k + 16 * sum(n_live), 14 * pairs,
                          F32_FLOP_S, iters=50, device=True,
                          note=f"cluster {nms_kernel.cluster_size(b, k)}")
                # the greedy chain's floor, a model and not a bound: one
                # dependent integer step for each row up to the last valid
                # one, at the card's 1.98 GHz boost clock and at 1.755 GHz
                # (printed, not in the kernels line)
                self.records[name][-1]["scan_floor_ms"] = (
                    max(n_live) / 1.98e6, max(n_live) / 1.755e6)

    # ------------------------------------------------------------- RoI
    def _rois(self, b, n):
        xy = self.rng.uniform(-10, 380, (b, n, 2))
        return self.torch.tensor(np.concatenate(
            [xy, xy + self.rng.uniform(4, 300, (b, n, 2))], -1),
            dtype=self.torch.float32, device=self.dev)

    def _prep(self, rois, hw, ps):
        from millieye_torch.ops.roi_align import _batched_prep
        return _batched_prep(rois, hw, hw, (7, 7), 1 / 16,
                             -0.5 if ps else 0.0, 0.1 if ps else 1.0, -1, 4)

    def roi_bf16(self, b):
        """K2 and K3 on bf16 operands, N = 96 (64 NMS + 32 radar rows) and
        N = 232 (200 + 32), and N = 96 with every RoI the whole frame (the
        support's worst case); K3's line notes the RoIs a block takes
        (its group). The library yardstick is one einsum by.F.bx
        on the same bf16 operands (cuBLAS, float32 accumulation); it
        rounds t and its output to bf16, so it is held to the plain
        version within 4% of the output's largest magnitude."""
        from millieye_torch.ops import roi_kernel
        torch, bf = self.torch, self.torch.bfloat16
        hw, ph, pw, c_out = 26, 7, 7, 10
        for n, whole in ((96, False), (232, False), (96, True)):
            rois = self._whole_frame(b, n) if whole else self._rois(b, n)
            label = f"N={n}" + (" whole frame" if whole else "")
            feats = torch.tensor(
                self.rng.standard_normal((b, hw, hw, ph * 128)), dtype=bf,
                device=self.dev)
            by, bx = (t.to(bf).contiguous() for t in self._prep(rois, hw,
                                                                True))
            # the c_out*pw live lanes of each 128-lane block, as
            # [B, H, W, ph, c_out, pw]: all the kernel reads
            live = feats.view(b, hw, hw, ph, 128)[..., :c_out * pw] \
                .unflatten(-1, (c_out, pw))
            used = b * hw * hw * ph * c_out * pw
            self.case(
                "ps_roi_align", label, b,
                lambda: roi_kernel.ps_roi_align_padded_kernel(feats, by, bx,
                                                              c_out),
                lambda: roi_kernel.ps_roi_align_padded_plain(feats, by, bx,
                                                             c_out),
                (used + by.numel() + bx.numel()) * 2
                + b * n * ph * pw * c_out * 4,
                *crop_flops(by, bx, c_out * pw, c_out * pw, "default"),
                lambda: torch.einsum("bnph,bhwpuq,bnqw->bnpqu", by, live,
                                     bx),
                "one torch.einsum by.F.bx on the live lanes, bf16", BF16_TOL)
            self.case(
                "ps_roi_align_vpu", label, b,
                lambda: roi_kernel.ps_roi_align_padded_vpu_kernel(
                    feats, by, bx, c_out),
                lambda: roi_kernel.ps_roi_align_padded_plain(feats, by, bx,
                                                             c_out),
                (used + by.numel() + bx.numel()) * 2
                + b * n * ph * pw * c_out * 4,
                *crop_flops(by, bx, c_out * pw, c_out * pw, "default"),
                lambda: torch.einsum("bnph,bhwpuq,bnqw->bnpqu", by, live,
                                     bx),
                "one torch.einsum by.F.bx on the live lanes, bf16", BF16_TOL)
            rfeats = torch.tensor(
                self.rng.standard_normal((b, hw, hw, c_out)), dtype=bf,
                device=self.dev)
            ry, rx = (t.to(bf).contiguous() for t in self._prep(rois, hw,
                                                                False))
            self.case(
                "roi_align", f"N={n} bf16" + (" whole frame" if whole else ""),
                b,
                lambda: roi_kernel.roi_align_kernel(rfeats, ry, rx),
                lambda: roi_kernel.roi_align_plain(rfeats, ry, rx),
                (rfeats.numel() + ry.numel() + rx.numel()) * 2
                + b * n * ph * pw * c_out * 4,
                *crop_flops(ry, rx, c_out, c_out * pw, "default"),
                lambda: torch.einsum("bnph,bhwc,bnqw->bnpqc", ry, rfeats,
                                     rx),
                "one torch.einsum by.F.bx, bf16", BF16_TOL,
                note=f"group {roi_kernel.roi_align_group(b, n)}")

    def _whole_frame(self, b, n):
        """Every RoI the whole 416 px frame: the support's worst case."""
        return self.torch.tensor(np.concatenate(
            [self.rng.uniform(-2, 2, (b, n, 2)),
             416 + self.rng.uniform(-2, 2, (b, n, 2))], -1),
            dtype=self.torch.float32, device=self.dev)

    def roi_f32(self, b):
        """K6 (N = 200, both channel orders, "default" and "highest"; and
        "upq" "default" with every RoI the whole frame), K7 (N = 232,
        "split" and "highest"; and "highest" on whole-frame RoIs), K3 on
        float32 operands (N = 232, "split" and "highest"; and "highest" on
        whole-frame RoIs) and the same crop through K6 (layout "c", what
        ``roi_align(pack_p=False)`` runs), held bit-equal to K3's.
        Library: one einsum by.F.bx, float32 with TF32 off, or on bf16
        operands at "default" (4% as above). Bound: the
        products on the nonzero support (``crop_flops``) against the
        bytes."""
        from millieye_torch.ops import roi_kernel
        torch, bf = self.torch, self.torch.bfloat16
        hw, ph, pw, c_out = 26, 7, 7, 10
        ol = c_out * pw
        lib_tol = {"default": BF16_TOL, "split": 2.0 ** -14,
                   "highest": 1e-5}

        def einsum_for(spec, by, f, bx, precision):
            if precision == "default":
                by, f, bx = by.to(bf), f.to(bf), bx.to(bf)
            return (lambda: torch.einsum(spec, by, f, bx),
                    "one torch.einsum by.F.bx, "
                    + ("bf16" if precision == "default"
                       else "float32, TF32 off"))

        def weights(rois):
            return tuple(t.contiguous() for t in self._prep(rois, hw, True))

        n = 200
        rnd = weights(self._rois(b, n))
        feats = torch.tensor(self.rng.standard_normal((b, hw, hw, 490)),
                             dtype=torch.float32, device=self.dev)
        whole = weights(self._whole_frame(b, n))
        nbytes = (feats.numel() + b * n * (ph + pw) * hw
                  + b * n * ph * pw * c_out) * 4
        views = {"upq": (feats.view(b, hw, hw, c_out, ph, pw),
                         "bnph,bhwupq,bnqw->bnpqu"),
                 "puq": (feats.view(b, hw, hw, ph, c_out, pw),
                         "bnph,bhwpuq,bnqw->bnpqu")}
        for order, precision, (by, bx), label in (
                ("upq", "default", rnd, ""), ("upq", "highest", rnd, ""),
                ("puq", "default", rnd, ""), ("puq", "highest", rnd, ""),
                ("upq", "default", whole, " whole frame")):
            lib, note = einsum_for(views[order][1], by, views[order][0], bx,
                                   precision)
            self.case(
                "ps_roi_align_f32", f"N={n} {order} {precision}{label}", b,
                lambda: roi_kernel.ps_roi_align_f32_kernel(
                    feats, by, bx, c_out, precision, order),
                lambda: roi_kernel.ps_roi_align_f32_plain(
                    feats, by, bx, c_out, precision, order),
                nbytes, *crop_flops(by, bx, ol, ol, precision), lib,
                note, lib_tol[precision])

        n = 232
        rois = self._rois(b, n)
        rnd = weights(rois)
        rnd_k3 = tuple(t.contiguous() for t in self._prep(rois, hw, False))
        fpad = torch.zeros((b, hw, hw, ph * 128), device=self.dev)
        fpad[..., torch.as_tensor(roi_kernel.ps_channel_perm_pad(
            c_out, ph, pw), device=self.dev)] = torch.tensor(
                self.rng.standard_normal((b, hw, hw, 490)),
                dtype=torch.float32, device=self.dev)
        whole = weights(self._whole_frame(b, n))
        live = fpad.view(b, hw, hw, ph, 128)[..., :c_out * pw] \
            .unflatten(-1, (c_out, pw))
        nbytes = (b * hw * hw * 490 + b * n * (ph + pw) * hw
                  + b * n * ph * pw * c_out) * 4
        for precision, (by, bx), label in (
                ("split", rnd, ""), ("highest", rnd, ""),
                ("highest", whole, " whole frame")):
            lib, note = einsum_for("bnph,bhwpuq,bnqw->bnpqu", by, live, bx,
                                   precision)
            self.case(
                "ps_roi_align_padded_f32", f"N={n} {precision}{label}", b,
                lambda: roi_kernel.ps_roi_align_padded_f32_kernel(
                    fpad, by, bx, c_out, precision),
                lambda: roi_kernel.ps_roi_align_f32_plain(
                    fpad, by, bx, c_out, precision, "padded"),
                nbytes, *crop_flops(by, bx, ol, ol, precision), lib,
                note, lib_tol[precision])

        feats = torch.tensor(self.rng.standard_normal((b, hw, hw, c_out)),
                             dtype=torch.float32, device=self.dev)
        nbytes = (feats.numel() + b * n * (ph + pw) * hw
                  + b * n * ph * pw * c_out) * 4
        group = f"group {roi_kernel.roi_align_group(b, n)}"
        whole = tuple(t.contiguous() for t in self._prep(
            self._whole_frame(b, n), hw, False))
        by, bx = rnd_k3
        lib, note = einsum_for("bnph,bhwc,bnqw->bnpqc", by, feats, bx,
                               "highest")
        self.case(
            "roi_align", f"N={n} float32 highest", b,
            lambda: roi_kernel.roi_align_kernel(feats, by, bx, "highest"),
            lambda: roi_kernel.roi_align_f32_plain(feats, by, bx, "highest"),
            nbytes, *crop_flops(by, bx, c_out, ol), lib, note,
            lib_tol["highest"], note=group)
        for precision, (wy, wx), label in (
                ("split", rnd_k3, ""), ("highest", whole, " whole frame")):
            lib, note = einsum_for("bnph,bhwc,bnqw->bnpqc", wy, feats, wx,
                                   precision)
            self.case(
                "roi_align", f"N={n} float32 {precision}{label}", b,
                lambda: roi_kernel.roi_align_kernel(feats, wy, wx, precision),
                lambda: roi_kernel.roi_align_f32_plain(feats, wy, wx,
                                                       precision),
                nbytes, *crop_flops(wy, wx, c_out, ol, precision), lib, note,
                lib_tol[precision], note=group)
        if not torch.equal(
                roi_kernel.ps_roi_align_f32_kernel(feats, by, bx, c_out,
                                                   "highest", "c"),
                roi_kernel.roi_align_kernel(feats, by, bx, "highest")):
            raise AssertionError(f"b{b}: K6 at layout 'c' differs from K3 "
                                 f"on float32 operands")
        lib, note = einsum_for("bnph,bhwc,bnqw->bnpqc", by, feats, bx,
                               "highest")
        self.case(
            "ps_roi_align_f32", f"N={n} c highest", b,
            lambda: roi_kernel.ps_roi_align_f32_kernel(feats, by, bx, c_out,
                                                       "highest", "c"),
            lambda: roi_kernel.roi_align_f32_plain(feats, by, bx, "highest"),
            nbytes, *crop_flops(by, bx, c_out, ol), lib, note,
            lib_tol["highest"])

    # ------------------------------------------------------------ stems
    def stems(self, b, darknet_params):
        """The stem pair (K4, K8, K11, K12 at groups0 4 and 8) on 416 px
        frames at both precisions, K12's deep pair on stage 4's input
        shape, and K9 at the four stage shapes of the 416 px network,
        with the served (folded) weights. At "default" the pair, the deep
        pair and K9 run on the tensor cores and are held within
        ``stem.PAIR_DEFAULT_TOL`` of their plain versions' largest output
        (the exact share recorded); every "highest" case bit-equal, the
        deep pair's also held to the float64 function (``case``'s
        ``f64``).
        Library: cuDNN conv2d + bias + leaky_relu + max_pool2d on channels_last
        operands, bf16 where the kernel's products are bf16 and float32
        (TF32 off) at "highest"; held within 4% (bf16) or 0.2% (float32;
        the float16 store may round the other way) of the largest
        output."""
        from millieye_torch.ops import stem
        torch, bf = self.torch, self.torch.bfloat16

        def cudnn_stages(x, stages, dtype):
            return cudnn_stem(torch, x, stages, dtype)

        def wb(i):
            return (darknet_params[i]["w"].float(),
                    darknet_params[i]["b"].float())

        (w0, b0), (w1, b1) = wb(0), wb(2)
        x = torch.tensor(self.rng.uniform(0, 1, (b, 416, 416, 3)),
                         dtype=torch.float32, device=self.dev)
        args = (x, w0, b0, w1, b1)
        for precision in ("default", "highest"):
            hi = precision == "highest"
            store = torch.float32 if hi else torch.float16
            lib = cudnn_stages(x, [(w0, b0), (w1, b1)],
                               torch.float32 if hi else bf)
            note = ("cuDNN conv2d+bias+leaky+max_pool2d twice, "
                    + ("float32, TF32 off" if hi else "bf16"))
            for name, fn, kw, select in (
                    ("stem_pair", stem.fused_stem_pair, {}, False),
                    ("stem_pair_select", stem.fused_stem_pair_select, {},
                     not hi),
                    ("stem_pair_packed", stem.fused_stem_pair_packed, {},
                     False),
                    ("stem_pair_s2d", stem.fused_stem_pair_s2d,
                     {"groups0": 4}, False),
                    ("stem_pair_s2d", stem.fused_stem_pair_s2d,
                     {"groups0": 8}, False)):
                label = (f"416 px 3->16->32 {precision} {str(store)[6:]}"
                         + (f" groups0={kw['groups0']}" if kw else ""))
                self.case(
                    name, label, b,
                    lambda fn=fn, kw=kw: fn(*args, precision, store, **kw),
                    lambda select=select: stem.fused_stem_pair_plain(
                        *args, precision, store, select),
                    x.numel() * 4 + b * 104 * 104 * 32 * store.itemsize
                    + (w0.numel() + w1.numel()) * (4 if hi else 2),
                    2 * b * (416 * 416 * 16 * 27 + 208 * 208 * 32 * 144),
                    F32_FLOP_S if hi else BF16_FLOP_S, lib, note,
                    2e-3 if hi else BF16_TOL,
                    tol=None if hi else stem.PAIR_DEFAULT_TOL)
            if not hi:
                k8 = stem.fused_stem_pair_select(*args, precision, store)
                k4 = stem.fused_stem_pair(*args, precision, store)
                self.k8_vs_k4.append((b, int((k8 != k4).sum()), k8.numel()))

        # the deep pair: stages 4+6 on 104 px, bf16 store
        (w4, b4), (w6, b6) = wb(4), wb(6)
        x = torch.tensor(self.rng.uniform(0, 1, (b, 104, 104, 32)),
                         dtype=torch.float32, device=self.dev)
        for precision in ("default", "highest"):
            hi = precision == "highest"
            self.case(
                "stem_pair_deep",
                f"104 px 32->64->128 {precision} bf16", b,
                lambda: stem.fused_stem_pair_s2d(x, w4, b4, w6, b6, precision,
                                                 torch.bfloat16, groups0=2),
                lambda: stem.fused_stem_pair_deep_plain(
                    x, w4, b4, w6, b6, precision, torch.bfloat16),
                x.numel() * 4 + b * 26 * 26 * 128 * 2
                + (w4.numel() + w6.numel()) * (4 if hi else 2),
                2 * b * (104 * 104 * 64 * 288 + 52 * 52 * 128 * 576),
                F32_FLOP_S if hi else BF16_FLOP_S,
                cudnn_stages(x, [(w4, b4), (w6, b6)],
                             torch.float32 if hi else bf),
                "cuDNN conv2d+bias+leaky+max_pool2d twice, "
                + ("float32, TF32 off" if hi else "bf16"),
                # float32 against the plain version's bf16 store at
                # "highest": half a bf16 ulp, 2^-9 of the value, and order
                2.0 ** -8 if hi else BF16_TOL,
                tol=None if hi else stem.PAIR_DEFAULT_TOL,
                f64=(lambda: stem.fused_stem_pair_f64(x, w4, b4, w6, b6))
                if hi else None)

        for i, hw, precision, store in ((0, 416, "highest", torch.float16),
                                        (2, 208, "highest", torch.float16),
                                        (4, 104, "default", torch.float16),
                                        (6, 52, "default", torch.bfloat16)):
            w, bs = wb(i)
            cout, cin = w.shape[0], w.shape[1]
            x = torch.tensor(self.rng.uniform(0, 1, (b, hw, hw, cin)),
                             dtype=torch.float32, device=self.dev)
            hi = precision == "highest"
            self.case(
                "stem_stage", f"stage {i}: {hw} px {cin}->{cout} "
                f"{precision} {str(store)[6:]}", b,
                lambda: stem.fused_stem_stage(x, w, bs, precision, store),
                lambda: stem.fused_stem_stage_plain(x, w, bs, precision,
                                                    store),
                x.numel() * 4 + b * (hw // 2) ** 2 * cout * 2
                + w.numel() * 4 + cout * 4,
                2 * b * hw * hw * cout * 9 * cin,
                F32_FLOP_S if hi else BF16_FLOP_S,
                cudnn_stages(x, [(w, bs)], torch.float32 if hi else bf),
                "cuDNN conv2d+bias+leaky+max_pool2d, "
                + ("float32, TF32 off" if hi else "bf16"),
                2e-3 if hi else BF16_TOL,
                tol=None if hi else stem.PAIR_DEFAULT_TOL)
            if hi:
                # mul-then-add takes two issue slots a product on the 132
                # SMs' 128 float32 lanes, at 1.98 and 1.755 GHz (printed,
                # not in the kernels line)
                slots = 2 * b * hw * hw * cout * 9 * cin
                self.records["stem_stage"][-1]["ceiling_ms"] = (
                    slots / (132 * 128 * 1.98e6), slots / (132 * 128 * 1.755e6))

    # ------------------------------------------------------------- K10
    def fused_stem_nhwc(self, b, darknet_params):
        """K10 at stage 0 (416 px, 3->16) and stage 2 (208 px, 16->32) with
        the served weights (HWIO), float32 in, float16 out, for the
        "vconcat" and "im2col" tap orders, and at block 8's shape (26 px,
        128->256, its served weights: past the resident route's shared
        memory, ``stem.nhwc_route``), each with its device time a call
        and its mul-then-add ceiling. Library: cuDNN float32 (TF32 off),
        within 0.2% of the largest output (the float16 store may round
        the other way). Bound: the products at the float32 rate."""
        from millieye_torch.ops import stem
        torch = self.torch
        for i, hw, variants in ((0, 416, ("vconcat", "im2col")),
                                (2, 208, ("vconcat", "im2col")),
                                (8, 26, ("im2col",))):
            w = darknet_params[i]["w"].float()
            bs = darknet_params[i]["b"].float()
            cout, cin = w.shape[0], w.shape[1]
            w_hwio = w.permute(2, 3, 1, 0).contiguous()
            x = torch.tensor(self.rng.uniform(0, 1, (b, hw, hw, cin)),
                             dtype=torch.float32, device=self.dev)
            for variant in variants:
                self.case(
                    "fused_stem", f"{'stage' if i < 8 else 'block'} {i}: "
                    f"{hw} px {cin}->{cout} {variant} f16, "
                    f"{stem.nhwc_route(cin, cout)}", b,
                    lambda: stem.fused_stem(x, w_hwio, bs, 1, torch.float16,
                                            variant),
                    lambda: stem.fused_stem_plain(x, w_hwio, bs, 1,
                                                  torch.float16, variant),
                    x.numel() * 4 + b * (hw // 2) ** 2 * cout * 2
                    + w.numel() * 4 + cout * 4,
                    2 * b * hw * hw * cout * 9 * cin, F32_FLOP_S,
                    cudnn_stem(torch, x, [(w, bs)], torch.float32),
                    "cuDNN conv2d+bias+leaky+max_pool2d, float32, TF32 off",
                    2e-3, device=True)
                # two issue slots a product, as K9's "highest" lines
                slots = 2 * b * hw * hw * cout * 9 * cin
                self.records["fused_stem"][-1]["ceiling_ms"] = (
                    slots / (132 * 128 * 1.98e6),
                    slots / (132 * 128 * 1.755e6))

    # ------------------------------------------------------------- K13
    def quantize(self, w12):
        """K13 on block 12's served weight as the JAX package lays it out,
        [3, 3, 512, 1024] -> [4608, 1024] (9 row tiles of 512), and on the
        (8, 128) carrier of benchmarks/quantize_tpu_check.py, seeds 0 and
        1: bit-equal to the plain version (same Philox words); the
        carrier's statistics; every value floor or floor + 1 of w / scale.
        Timed: the wrapper (the absmax pass and the rounding pass, both
        hand-written), with its device time a call (both launches).
        Bound: bytes, 4 read by the absmax pass, 4 read and 1 written by
        the rounding pass per element. Then held to the plain version, not
        timed: a ragged [37, 13] at row_tile 5, 70000 row tiles of one row
        (more than a grid's y dimension holds), and all-zero, -0.0, inf,
        -inf and NaN inputs (a NaN scale compares as NaN)."""
        from millieye_torch.ops import quantize
        torch = self.torch
        carrier = torch.full((8, 128), 0.3, device=self.dev)
        carrier[0, 0] = 1.0
        w2d = w12.permute(2, 3, 1, 0).reshape(-1, w12.shape[0]).float() \
            .contiguous()
        self.k13_stats = []
        for label, w in (("block 12 [4608, 1024]", w2d),
                         ("carrier [8, 128]", carrier)):
            for seed in (0, 1):
                q, s = quantize.quantize_int8_stochastic(w, seed)
                wq, ws = quantize.quantize_int8_stochastic_plain(w, seed)
                if not (torch.equal(s, ws) and torch.equal(q, wq)):
                    raise AssertionError(f"K13 {label} seed {seed}: not "
                                         f"bit-equal to the plain version")
                fl = torch.floor(w / s)
                if not ((q == fl) | (q == fl + 1) | (q.abs() == 127)).all():
                    raise AssertionError(f"K13 {label}: a value is neither "
                                         f"floor nor floor + 1")
                if w is carrier:
                    self.k13_stats.append((seed,) + stochastic_stats(q, s))
            if w is carrier and torch.equal(
                    quantize.quantize_int8_stochastic(w, 0)[0],
                    quantize.quantize_int8_stochastic(w, 1)[0]):
                raise AssertionError("K13: seeds 0 and 1 gave one stream")
            self.case("quantize_stochastic", label, 1,
                      lambda: quantize.quantize_int8_stochastic(w, 0)[0],
                      lambda: quantize.quantize_int8_stochastic_plain(w, 0)[0],
                      9 * w.numel(), 0, F32_FLOP_S, iters=50, device=True)
        gen = torch.Generator().manual_seed(11)

        def special(fill, at):
            w = torch.randn((9, 20), generator=gen)
            if at is None:
                w[:] = fill
            else:
                w[at] = fill
            return w.to(self.dev)

        self.k13_edges = []
        for label, w, row_tile in (
                ("ragged [37, 13]", torch.randn((37, 13), generator=gen),
                 5),
                ("70000 tiles [70000, 3]",
                 torch.randn((70000, 3), generator=gen), 1),
                ("all zero", special(0.0, None), 4),
                ("-0.0", special(-0.0, None), 4),
                ("inf", special(float("inf"), (3, 7)), 4),
                ("-inf", special(-float("inf"), (8, 19)), 4),
                ("NaN", special(float("nan"), (0, 5)), 4)):
            w = w.to(self.dev)
            for seed in (0, -3):
                q, s = quantize.quantize_int8_stochastic(w, seed, row_tile)
                wq, ws = quantize.quantize_int8_stochastic_plain(w, seed,
                                                                 row_tile)
                same = torch.equal(s, ws) or bool(s.isnan() & ws.isnan())
                if not (same and torch.equal(q, wq)):
                    raise AssertionError(f"K13 {label} seed {seed}: not "
                                         f"bit-equal to the plain version "
                                         f"(scale {float(s)!r} against "
                                         f"{float(ws)!r})")
            self.k13_edges.append(f"{label} (row_tile {row_tile}, scale "
                                  f"{float(s):.6g})")


def int8_conv_phase(torch, w12, rng):
    """Block 12's int8 x int8 -> int32 convolution (13x13, 512 -> 1024,
    3x3) through torch._int_mm: bit-equal on the card and the CPU at b1;
    its time at b1 and b32 against cuDNN's float32 convolution of the same
    shapes (TF32 off). Bound: the products at the int8 tensor-core rate
    against the int8 operands and int32 result."""
    import torch.nn.functional as F
    from millieye_torch.ops.quantize import int8_conv2d, quantize_int8
    q, _ = quantize_int8(w12.float())
    out = {}
    for b in (1, 32):
        zq = torch.tensor(rng.integers(-127, 128, (b, 512, 13, 13)),
                          dtype=torch.int8)
        zc, qc = zq.cuda(), q.cuda()
        got = int8_conv2d(zc, qc, 1, 1)
        torch.cuda.synchronize()
        if b == 1 and not torch.equal(got.cpu(), int8_conv2d(zq, q.cpu(), 1,
                                                              1)):
            raise AssertionError("int8 conv: the card and the CPU disagree")
        xf, wf = zc.float(), qc.float()
        ops = 2 * b * 13 * 13 * 1024 * 4608
        out[b] = {"ms": cuda_ms(torch, lambda: int8_conv2d(zc, qc, 1, 1), 20),
                  "cudnn_f32_ms": cuda_ms(
                      torch, lambda: F.conv2d(xf, wf, padding=1), 20),
                  "bound_ms": bound_ms(zq.numel() + q.numel()
                                       + b * 13 * 13 * 1024 * 4, ops,
                                       INT8_OP_S)}
    return out


def deep_batch_cases(torch):
    """The deep stage's batch past the grid's old cap: deep_stage_kernel
    at "highest" (the deep pair's two launches, 4x4 maps, 64 -> 64 ->
    128: 4 slices of 32 channels an image at stage 1, so n = 16384 put
    65536 on a grid's z) and at "default" (K9 at Cin 272, above the
    tensor-core kernel's widest Cin, 4x4 -> 128), and the CUDA-core deep
    pair ("default" at Cin 72, 4x4 maps, whose grid z held n alone), each
    just under its old cap and past it, held to its plain version:
    bit-equal at "highest", within ``stem.PAIR_DEFAULT_TOL`` of the
    largest plain output at "default" (the exact share reported)."""
    from millieye_torch.ops import stem
    gen = torch.Generator(device="cuda").manual_seed(12)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    out = []
    for label, n, precision, shape in (
            ("deep pair 'highest' 4x4 64->64->128 (deep_stage_kernel x2)",
             16383, "highest", (64, 64, 128)),
            ("deep pair 'highest' 4x4 64->64->128 (deep_stage_kernel x2)",
             16384, "highest", (64, 64, 128)),
            ("K9 'default' 4x4 272->128 (deep_stage_kernel)", 16383,
             "default", (272, 128)),
            ("K9 'default' 4x4 272->128 (deep_stage_kernel)", 16384,
             "default", (272, 128)),
            ("CUDA-core deep pair 'default' 4x4 72->16->24", 65535,
             "default", (72, 16, 24)),
            ("CUDA-core deep pair 'default' 4x4 72->16->24", 65536,
             "default", (72, 16, 24))):
        x = torch.rand((n, 4, 4, shape[0]), device="cuda", generator=gen)
        ws = [(rand(co, ci, 3, 3, scale=0.1), rand(co, scale=0.1))
              for ci, co in zip(shape, shape[1:])]
        args = [x] + [t for wb in ws for t in wb]
        if len(ws) == 2:
            kern = stem.fused_stem_pair_deep
            plain = stem.fused_stem_pair_deep_plain
        else:
            kern, plain = stem.fused_stem_stage, stem.fused_stem_stage_plain
        before = kern.launches
        got = kern(*args, precision)
        torch.cuda.synchronize()
        if kern.launches != before + 1:
            raise AssertionError(f"batch cap, {label}, n {n}: no launch")
        want = plain(*args, precision)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        exact = float((got == want).double().mean())
        if got.shape != want.shape or got.dtype != want.dtype or (
                precision == "highest" and not torch.equal(got, want)) or (
                not err <= stem.PAIR_DEFAULT_TOL * scale):
            raise AssertionError(f"batch cap, {label}, n {n}: off the plain "
                                 f"version by {err} (largest {scale})")
        out.append({"case": label, "n": n, "precision": precision,
                    "max_abs_err": err, "exact_share": exact,
                    "input_mb": x.numel() * 4 / 2 ** 20})
        del x, ws, args, got, want
        torch.cuda.empty_cache()
    return out


# the recorded session of phases P15 and P16: 96 frames at 20 fps, the
# demo's radar defaults, a pinhole camera (fx = fy = 500, principal point
# at the centre of 640x480, no distortion, the default radar -> camera
# translation)
STREAM_FRAMES = 96
STREAM_WINDOW = 32
STREAM_WINDOW_FRAMES = 90      # three windows, the last 26 frames + 6 pads
STREAM_PROFILED = 24           # frames of P15's profiled run
STREAM_CALIB = np.array([500.0, 320.0, 500.0, 240.0, 0.0, 0.0, 0.0, 0.0,
                         0.0, -0.07, -0.05, 0.0])


def write_recording(root, n_frames=STREAM_FRAMES, seed=5):
    """A recorded session in the recorder's layout, with numpy and pickle
    only: ``timestamps.txt`` and ``pointcloud.pkl`` (records of
    ``{"Data": {"numObj", "x", "y", "z", "velocity"}, "Time",
    "Frame_ID"}``, as tests/test_runtime.py writes them), camera and
    radar at 20 fps. Each radar frame holds three walkers at 2-6 m depth
    (turning at the ends) and |x| <= 1.5 m, 12-25 points each spread
    0.3 m, moving at 0.5-1.5 m/s, and 15 clutter points with |v| < 0.1;
    radar frames 40 and 41 also hold a burst of 150 points on a walker,
    so the overlay of two frames passes ``FusionEngine.max_points`` (256)
    and is trimmed. Returns the video frames, [(index, uint8 [480, 640,
    3])] from the same seed, to hand over through ``frames=``: decode is
    not what is measured."""
    import os
    import pickle
    rng = np.random.default_rng(seed)
    times = 1000.0 + np.arange(n_frames) / 20
    with open(os.path.join(root, "timestamps.txt"), "w") as f:
        for i, t in enumerate(times):
            f.write(f"{float(t)!r} {i}\n")
    x0 = rng.uniform(-1.5, 1.5, 3)
    d0 = rng.uniform(2, 6, 3)
    speed = rng.uniform(0.5, 1.5, 3) * rng.choice([-1.0, 1.0], 3)
    records = []
    for i, t in enumerate(times):
        # depth walks back and forth between 2 and 6 m
        u = np.mod(d0 - 2 + speed * i / 20, 8)
        depth = 2 + np.where(u < 4, u, 8 - u)
        vel = np.where(u < 4, speed, -speed)
        cols = []
        for w in range(3):
            k = int(rng.integers(12, 26)) + (150 if i in (40, 41) and w == 0
                                             else 0)
            cols.append(np.stack([x0[w] + rng.normal(0, 0.3, k),
                                  depth[w] + rng.normal(0, 0.3, k),
                                  rng.normal(0, 0.3, k),
                                  vel[w] + rng.normal(0, 0.05, k)]))
        cols.append(np.stack([rng.uniform(-4, 4, 15), rng.uniform(1, 12, 15),
                              rng.uniform(-1, 1, 15),
                              rng.uniform(-0.099, 0.099, 15)]))
        pts = np.concatenate(cols, 1)
        records.append({"Data": {"numObj": pts.shape[1], "x": pts[0],
                                 "y": pts[1], "z": pts[2],
                                 "velocity": pts[3]},
                        "Time": float(t), "Frame_ID": i})
    with open(os.path.join(root, "pointcloud.pkl"), "wb") as f:
        pickle.dump(records, f)
    return [(i, rng.integers(0, 256, (FRAME[1], FRAME[0], 3), np.uint8))
            for i in range(n_frames)]


def radar_replay(rec, eng, params):
    """The radar inputs the stream's producer computes, from a second
    ``RadarPipeline`` replaying the recording with the producer's frame
    matching and overlay: per frame (points_uvzv, proposals) and the
    host's time of the radar chain (``process`` and ``pack_radar``), the
    native library's first load (or build) done before the first frame."""
    import os
    from millieye_torch.collection.sync import (load_pointcloud,
                                                load_timestamps,
                                                match_frames)
    from millieye_torch.radar.dbscan import dbscan
    from millieye_torch.radar.pipeline import RadarPipeline
    dbscan(np.zeros((2, 4)), 1.0, 2)
    vt = load_timestamps(os.path.join(rec, "timestamps.txt"))
    rt, rf = load_pointcloud(os.path.join(rec, "pointcloud.pkl"))
    radar = RadarPipeline(STREAM_CALIB, params)
    overlay, out, host = [], [], []
    for picks in match_frames(vt, rt, params.num_nearest):
        t = time.perf_counter()
        overlay = (overlay + [rf[i] for i in picks])[-params.overlay_num:]
        r = radar.process(np.concatenate(overlay, 1) if overlay
                          else np.zeros((4, 0)))
        eng.pack_radar(r["points_uvzv"], r["proposals"])
        host.append((time.perf_counter() - t) * 1e3)
        out.append((r["points_uvzv"], r["proposals"]))
    return out, host


def profile_run(torch, run):
    """One ``torch.profiler`` pass over ``run()``: (device busy ms, wall
    ms, host syncs: the runtime's stream and device synchronisations and
    synchronous copies, device-to-host copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    syncs = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"))
    d2h = sum(e.count for e in dev if "DtoH" in e.key)
    return busy, wall, syncs, d2h


def same_answer(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


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


def profile_calls(torch, label, calls):
    """Device time per call from a torch.profiler trace of ``calls``:
    kernel time summed over the CUDA events, against the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for call in calls:
            call()
        wall = (time.perf_counter() - t) * 1e3 / len(calls)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kern) / 1e3 / len(calls)
    n_launch = sum(e.count for e in kern) / len(calls)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    log(f"profile of {label} over {len(calls)} requests: device busy "
        f"{dev:.3f} ms of {wall:.2f} ms wall per request "
        f"({100 * dev / wall:.1f}%), {n_launch:.0f} device activities per "
        f"request (profiled wall includes the profiler's overhead)")
    own = [e for e in kern if "(anonymous namespace)::" in e.key
           and "at::" not in e.key]      # the port's kernels
    for e in top + [e for e in own if e not in top]:
        log(f"  {e.self_device_time_total / 1e3 / len(calls):8.4f} ms/request"
            f"  x{e.count / len(calls):g}  {e.key[:90]}")
    return {"device_ms_per_request": dev, "wall_ms_per_request": wall,
            "device_activities_per_request": n_launch,
            "port_kernels_ms_per_request": {
                e.key.split("::", 1)[1].split("(", 1)[0]:
                    e.self_device_time_total / 1e3 / len(calls)
                for e in own}}


def _pairs(got, want, box_tol):
    """Pair the valid rows of two (rows, valid) answers: a row of ``got``
    and its nearest row of ``want`` by box, when each is the other's
    nearest and their boxes agree within ``box_tol``. Returns index
    pairs [(i, j), ...] into the full arrays."""
    gi, wi = np.flatnonzero(got[1]), np.flatnonzero(want[1])
    if len(gi) == 0 or len(wi) == 0:
        return []
    dist = np.abs(got[0][gi, None, :4] - want[0][None, wi, :4]).max(-1)
    near = dist.argmin(1)
    return [(gi[a], wi[near[a]]) for a in range(len(gi))
            if dist[a, near[a]] <= box_tol and dist[:, near[a]].argmin() == a]


def rows_match(got, want, tol):
    """Hold (rows, valid) pairs together: each valid row is paired with
    the nearest row of the other side by box (``_pairs``). Returns (ok,
    largest box difference, largest score difference, rows without a
    partner): ok when the paired scores agree within ``tol["score"]``
    and at most ``tol["flipped"]`` rows stand on one side only."""
    pairs = _pairs(got, want, tol["box"])
    flipped = int(got[1].sum() + want[1].sum()) - 2 * len(pairs)
    if not pairs:
        return flipped <= tol["flipped"], 0.0, 0.0, flipped
    gi, wi = (list(ix) for ix in zip(*pairs))
    d_box = float(np.abs(got[0][gi, :4] - want[0][wi, :4]).max())
    d_score = float(np.abs(got[0][gi, 4:] - want[0][wi, 4:]).max())
    return (d_score <= tol["score"] and flipped <= tol["flipped"], d_box,
            d_score, flipped)


@contextlib.contextmanager
def post_merge_inputs(eng):
    """Record what ``eng``'s post-merge NMS (``FusionEngine._post``) is
    given for each frame, rows [K, 7] and valid [K], in order (a
    window's call gives one record a frame)."""
    seen, post = [], eng._post

    def record(boxes, valid):
        seen.extend(zip(boxes.reshape(-1, *boxes.shape[-2:]).clone(),
                        valid.reshape(-1, valid.shape[-1]).clone()))
        return post(boxes, valid)

    eng._post = record
    try:
        yield seen
    finally:
        del eng._post


def window_nms_per_frame(torch, eng, step, tens, got):
    """The window's post-merge NMS is one call for its frames: run the
    window again with its NMS inputs recorded, and hold its answer
    ``got`` (rows, valid as numpy), bit for bit, to the same post-merge
    NMS frame by frame on those inputs (the loop the port ran before the
    batched call)."""
    with post_merge_inputs(eng) as seen:
        again = [a.cpu().numpy() for a in step(*tens)]
    per = [eng._post(b, v) for b, v in seen]
    loop = [torch.stack(c).cpu().numpy() for c in zip(*per)]
    for name, a, b in (("repeat", again, got), ("per-frame loop", loop, got)):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"window: the batched post-merge NMS "
                                 f"differs from its {name}")


def nms_live_rows(torch, runs):
    """{(kernel name, K): [live rows, one an image]} that the serving
    paths feed the NMS kernels: ``runs`` is [(engine, calls)], run with
    both NMS passes recorded (``pre_merge_nms``, ``post_merge_inputs``).
    The pre-merge pass feeds its candidates passing the confidence
    threshold, the post-merge pass its valid rows: each a prefix of the
    score-sorted rows."""
    from millieye_torch.ops.nms import _candidates
    live = {}
    for eng, calls in runs:
        with pre_merge_nms(torch) as pre, post_merge_inputs(eng) as post:
            for call in calls:
                call()
        for r in pre:
            k = min(r["kw"]["pre_top_k"], r["pred"].shape[1])
            blocked = k % 128 == 0 and r["kw"]["use_blocked"] is not False
            v = _candidates(r["pred"], r["args"][0], r["kw"]["pre_top_k"])[3]
            live.setdefault(("nms" if blocked else "nms_full", k), []).extend(
                v.sum(-1).tolist())
        for boxes, valid in post:
            k = boxes.shape[0]
            n = torch.isfinite(torch.where(valid, boxes[:, 4],
                                           float("-inf"))).sum()
            live.setdefault(("nms" if k % 128 == 0 else "nms_full", k),
                            []).append(int(n))
    return live


def nms_flip_proof(torch, cuda_lib, eng, got, want, got_in, want_in, tol):
    """Whether one frame's answers ``got`` (a kernel run) and ``want``
    (the fully plain run), (rows [K, 6], valid), differ only by
    post-merge NMS decisions; ``got_in`` and ``want_in`` are that NMS's
    inputs in the two runs. Proven when (1) the inputs, as output rows
    (camera box, score, label), agree within ``tol``; (2) each side's
    answer is, bit for bit, the plain post-merge NMS of its own inputs;
    and (3) each side's inputs under the other side's decisions (which
    inputs it kept, carried over by the pairing of (1)) give the other
    side's answer within ``tol``. Returns (proven, why not, inputs kept on
    one side only)."""
    from millieye_torch.ops.boxes import rescale_boxes
    w, h = eng.frame_size

    def as_rows(c):
        boxes, valid = c
        cam = rescale_boxes(boxes[:, :4], eng.model.darknet.img_size, (h, w))
        return (torch.cat([cam, boxes[:, 4:5], boxes[:, 6:7]], -1).cpu()
                .numpy(), valid.cpu().numpy())

    cg, cw = as_rows(got_in), as_rows(want_in)
    ok, db, ds, fl = rows_match(cg, cw, tol)
    if not ok:
        return (False, f"the NMS inputs differ beyond {tol} (box {db}, "
                f"score {ds}, {fl} rows on one side only)", 0)
    with cuda_lib.plain_versions():
        for side, c, out in (("kernel", got_in, got), ("plain", want_in,
                                                       want)):
            r, v = (a.cpu().numpy() for a in eng._post(*c))
            if not (np.array_equal(r, out[0]) and np.array_equal(v, out[1])):
                return (False, f"the {side} run's answer is not the plain "
                        f"post-merge NMS of its inputs", 0)

    def kept(c, out):
        return c[1] & (c[0][:, None] == out[0][out[1]][None]).all(-1).any(1)

    kg, kw = kept(cg, got), kept(cw, want)
    pairs = _pairs(cg, cw, tol["box"])
    under_w, under_g = np.zeros_like(cg[1]), np.zeros_like(cw[1])
    for i, j in pairs:
        under_w[i], under_g[j] = kw[j], kg[i]
    for side, rows, keep, out in (("kernel", cg[0], under_w, want),
                                  ("plain", cw[0], under_g, got)):
        ok, db, ds, fl = rows_match((rows, keep), out, tol)
        if not ok:
            return (False, f"the {side} run's inputs under the other run's "
                    f"NMS decisions differ from its answer beyond {tol} "
                    f"(box {db}, score {ds}, {fl} rows on one side only)", 0)
    paired_g = {i for i, _ in pairs}
    paired_w = {j for _, j in pairs}
    moved = (sum(bool(kg[i] != kw[j]) for i, j in pairs)
             + sum(bool(kg[i]) for i in range(len(kg)) if i not in paired_g)
             + sum(bool(kw[j]) for j in range(len(kw)) if j not in paired_w))
    return True, "", moved


@contextlib.contextmanager
def pre_merge_nms(torch, inject=None):
    """Record each call of the fusion network's pre-merge NMS
    (``models.fusion.batched_nms``): its arguments, its detections [B, A,
    5+C], its answer and the anchor each valid answer row came from.
    With ``inject``, another run's records call by call, each call
    answers instead with the rows of the anchors that run kept, taken
    from this run's detections: that run's decisions on this run's
    inputs."""
    from millieye_torch.models import fusion
    from millieye_torch.ops.boxes import xywh_to_xyxy
    seen, real = [], fusion.batched_nms

    def record(pred, *args, **kw):
        out, valid = real(pred, *args, **kw)
        xyxy = xywh_to_xyxy(pred[..., :4])
        same = ((xyxy[:, None] == out[:, :, None, :4]).all(-1)
                & (pred[:, None, :, 4] == out[:, :, None, 4]))
        if not bool(same.any(-1)[valid].all()):
            raise AssertionError("a pre-merge NMS row is no anchor's")
        anchors = torch.where(valid, same.int().argmax(-1), -1)
        seen.append({"pred": pred.clone(), "args": args, "kw": kw,
                     "out": out.clone(), "valid": valid.clone(),
                     "anchors": anchors})
        if inject is None:
            return out, valid
        other = inject[len(seen) - 1]
        valid = other["valid"]
        rows = torch.gather(pred, 1, other["anchors"].clamp(min=0)[..., None]
                            .expand(-1, -1, pred.shape[-1]))
        c = rows[..., 5:]
        out = torch.cat([xywh_to_xyxy(rows[..., :4]), rows[..., 4:5],
                         c.amax(-1, keepdim=True),
                         c.argmax(-1).to(pred.dtype)[..., None], c], -1)
        return torch.where(valid[..., None], out, torch.zeros_like(out)), \
            valid

    fusion.batched_nms = record
    try:
        yield seen
    finally:
        fusion.batched_nms = real


def pre_merge_is_nms(torch, cuda_lib, got, want):
    """The pre-merge NMS records of a kernel run (``got``) and its fully
    plain run (``want``): each run's answer must be, bit for bit, the
    plain NMS of its own detections. Returns the number of anchors kept
    by one run only, over all frames; raises AssertionError otherwise."""
    from millieye_torch.models import fusion
    for side, recs in (("kernel", got), ("plain", want)):
        for r in recs:
            with cuda_lib.plain_versions():
                out, valid = fusion.batched_nms(r["pred"], *r["args"],
                                                **r["kw"])
            if not (torch.equal(out, r["out"])
                    and torch.equal(valid, r["valid"])):
                raise AssertionError(f"the {side} run's pre-merge NMS "
                                     f"answer is not the plain NMS of its "
                                     f"detections")
    moved = 0
    for g, w in zip(got, want):
        for n in range(g["pred"].shape[0]):
            moved += len(set(g["anchors"][n][g["valid"][n]].tolist())
                         ^ set(w["anchors"][n][w["valid"][n]].tolist()))
    return moved


def nms_flips(torch, cuda_lib, eng, call, first, tol):
    """Prove that a kernel run and its fully plain run differ only by NMS
    decisions where they differ beyond ``tol``: ``call`` returns [(rows,
    valid)], one per frame, and ``first`` is its kernel run's answer.
    Both run again with the inputs and answers of both NMS passes
    recorded; the kernel run must repeat ``first``, and each run's
    pre-merge NMS must be the plain NMS of its detections
    (``pre_merge_is_nms``). Where the two pre-merge NMS kept other
    anchors, each run runs once more with the other run's pre-merge
    decisions (``pre_merge_nms(inject=)``) and must then meet the other
    run's answer. Each pair of answers still beyond ``tol`` goes through
    ``nms_flip_proof`` (the post-merge NMS). Returns (anchors the pre-merge NMS kept in one run only,
    post-merge NMS inputs kept in one run only), summed over the frames;
    raises AssertionError when a frame is not proven."""
    with pre_merge_nms(torch) as got_nms, post_merge_inputs(eng) as got_in:
        got = call()
    with pre_merge_nms(torch) as want_nms, post_merge_inputs(eng) as \
            want_in, cuda_lib.plain_versions():
        want = call()
    if not all(np.array_equal(g[0], f[0]) and np.array_equal(g[1], f[1])
               for g, f in zip(got, first)):
        raise AssertionError("a kernel run did not repeat its answer")
    anchors = pre_merge_is_nms(torch, cuda_lib, got_nms, want_nms)
    pairs = [(got, want, got_in, want_in)]
    if anchors:
        with pre_merge_nms(torch, inject=want_nms), \
                post_merge_inputs(eng) as got2_in:
            got2 = call()
        with pre_merge_nms(torch, inject=got_nms), \
                post_merge_inputs(eng) as want2_in, \
                cuda_lib.plain_versions():
            want2 = call()
        pairs = [(got2, want, got2_in, want_in), (got, want2, got_in,
                                                  want2_in)]
    return anchors, post_merge_flips(torch, cuda_lib, eng, pairs, tol,
                                     anchors, "the fully plain run")


def post_merge_flips(torch, cuda_lib, eng, pairs, tol, anchors, other):
    """The last step of ``nms_flips`` and ``window_flips``: each pair of
    answers still beyond ``tol`` must go through ``nms_flip_proof`` (the
    post-merge NMS). ``pairs``: [(answers, other answers, their post-merge
    NMS inputs, the other's)]. Returns the post-merge inputs kept in one
    run only, summed over the frames."""
    moved = 0
    for answers in pairs:
        for n, (g, w, gi, wi) in enumerate(zip(*answers)):
            if rows_match(g, w, tol)[0]:
                continue
            ok, why, k = nms_flip_proof(torch, cuda_lib, eng, g, w, gi, wi,
                                        tol)
            if not ok:
                raise AssertionError(
                    f"frame {n}: beyond {tol} of {other}, and not by NMS "
                    f"decisions alone: {why}"
                    + (" (with the other run's pre-merge NMS decisions)"
                       if anchors else ""))
            moved += k
    return moved


def window_flips(torch, cuda_lib, eng, window_call, frame_calls, first,
                 tol):
    """``nms_flips`` for a window against its frames one call each: a
    batch of 32 sums its cuDNN convolutions in another order than batch
    1, which moves scores by bf16 steps and can flip an NMS decision.
    ``window_call`` returns [(rows, valid)], one a frame of the window
    (its pads included), ``frame_calls`` answer those frames one at a
    time, ``first`` is the window's answer. Each side's pre-merge NMS
    must be the plain NMS of its detections (the frames' records taken as
    one batch); where the two kept other anchors, each side runs again
    with the other's decisions; what still differs beyond ``tol`` must be
    post-merge NMS decisions (``post_merge_flips``). Returns (anchors the
    pre-merge NMS kept on one side only, post-merge inputs kept on one
    side only); raises AssertionError when a frame is not proven."""
    def frames():
        return [call() for call in frame_calls]

    def as_one(recs):
        return [{k: (torch.cat([r[k] for r in recs])
                     if torch.is_tensor(recs[0][k]) else recs[0][k])
                 for k in recs[0]}]

    with pre_merge_nms(torch) as w_nms, post_merge_inputs(eng) as w_in:
        got = window_call()
    with pre_merge_nms(torch) as f_nms, post_merge_inputs(eng) as f_in:
        want = frames()
    if not all(same_answer(g, f) for g, f in zip(got, first)):
        raise AssertionError("the window did not repeat its answer")
    f_nms = as_one(f_nms)
    anchors = pre_merge_is_nms(torch, cuda_lib, w_nms, f_nms)
    pairs = [(got, want, w_in, f_in)]
    if anchors:
        per_frame = [{k: (v[i:i + 1] if torch.is_tensor(v) else v)
                      for k, v in w_nms[0].items()}
                     for i in range(len(frame_calls))]
        with pre_merge_nms(torch, inject=f_nms), \
                post_merge_inputs(eng) as w2_in:
            got2 = window_call()
        with pre_merge_nms(torch, inject=per_frame), \
                post_merge_inputs(eng) as f2_in:
            want2 = frames()
        pairs = [(got2, want, w2_in, f_in), (got, want2, w_in, f2_in)]
    return anchors, post_merge_flips(torch, cuda_lib, eng, pairs, tol,
                                     anchors, "the per-frame answers")


def log_case(name, r):
    """One line for a kernel case of phase 3."""
    lib = ("none (no single PyTorch call computes it)"
           if r["library_ms"] is None else
           f"{r['library_ms'][0]:.4f} ms [{r['library_ms'][1]:.4f}, "
           f"{r['library_ms'][2]:.4f}] ({r['library']})")
    held = ("bit-equal" if r["tol"] is None else
            f"bound {r['tol']:.3g} x {r['scale']:.3g}, exact share "
            f"{r['exact']:.5f}")
    dev = ("" if r["device_ms"][0] is None else
           f", device {r['device_ms'][0]:.4f} ms a call ("
           + (f"profiler, {r['device_ms'][1]} records" if r["device_ms"][1]
              else "CUDA events behind a spin: the profiler kept no record")
           + f"), host {r['host_ms']:.4f} ms a launch")
    extra = ("" if r.get("scan_floor_ms") is None else
             f", scan floor {r['scan_floor_ms'][0]:.6f}-"
             f"{r['scan_floor_ms'][1]:.6f} ms")
    if r.get("ceiling_ms") is not None:
        extra += (f", mul-then-add ceiling {r['ceiling_ms'][0]:.4f}-"
                  f"{r['ceiling_ms'][1]:.4f} ms")
    extra += "" if r["note"] is None else f", {r['note']}"
    log(f"kernel {name} {r['case']} b{r['batch']}: max_abs_err "
        f"{r['err']:.3g} ({held}), {r['ms'][0]:.4f} ms [{r['ms'][1]:.4f}, "
        f"{r['ms'][2]:.4f}]{dev}, plain {r['plain_ms'][0]:.4f} ms, bound "
        f"{r['bound'][0]:.3g} ms ({r['bound'][1]}){extra}, library {lib}")


def flat(r):
    """A kernel case of phase 3 as the ``kernels`` line gives it."""
    return {"case": r["case"], "batch": r["batch"],
            "max_abs_err": r["err"], "tol": r["tol"],
            "exact_share": r["exact"], "f64_err": r["err64"],
            "ms": r["ms"][0], "ms_min": r["ms"][1], "ms_max": r["ms"][2],
            "plain_ms": r["plain_ms"][0], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": (None if r["library_ms"] is None
                           else r["library_ms"][0]),
            "device_ms": r["device_ms"][0], "host_ms": r["host_ms"]}


def window_tensors(torch, engine, reqs):
    """The requests as one window's tensors on the card."""
    packed = [engine.pack_radar(pts, props) for _, pts, props in reqs]
    return [torch.from_numpy(np.ascontiguousarray(np.stack(a))).to("cuda")
            for a in [[f for f, _, _ in reqs]] + [list(c)
                                                  for c in zip(*packed)]]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from millieye_torch.cli._common import build_fusion, build_refine
    from millieye_torch.cli.demo import calibrate
    from millieye_torch.device import set_numerics
    from millieye_torch.entry import entry
    from millieye_torch.ops import (cuda_lib, nms_kernel, quantize, roi_kernel,
                                    stem)
    from millieye_torch.runtime.engine import FusionEngine, fold_for_serving

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
            if "Used" in ln or "Compiling entry" in ln or (
                    "spill" in ln and " 0 bytes spill stores" not in ln):
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
        "nms_full": (nms_kernel.nms_keep_mask_full,
                     "millieye_torch/csrc/nms.cu",
                     "millieye_tpu/ops/nms_pallas.py:80"),
        "ps_roi_align_f32": (roi_kernel.ps_roi_align_f32_kernel,
                             "millieye_torch/csrc/roi_align.cu",
                             "millieye_tpu/ops/roi_pallas.py:119"),
        "ps_roi_align_padded_f32": (roi_kernel.ps_roi_align_padded_f32_kernel,
                                    "millieye_torch/csrc/roi_align.cu",
                                    "millieye_tpu/ops/roi_pallas.py:344"),
        "stem_stage": (stem.fused_stem_stage, "millieye_torch/csrc/stem.cu",
                       "millieye_tpu/ops/stem_pallas.py:500"),
        "stem_pair_select": (stem.fused_stem_pair_select,
                             "millieye_torch/csrc/stem.cu",
                             "millieye_tpu/ops/stem_pallas.py:416"),
        "stem_pair_packed": (stem.fused_stem_pair_packed,
                             "millieye_torch/csrc/stem.cu",
                             "millieye_tpu/ops/stem_pallas_rejected.py:267"),
        "stem_pair_s2d": (stem.fused_stem_pair_s2d,
                          "millieye_torch/csrc/stem.cu",
                          "millieye_tpu/ops/stem_pallas_rejected.py:615"),
        "stem_pair_deep": (stem.fused_stem_pair_deep,
                           "millieye_torch/csrc/stem.cu",
                           "millieye_tpu/ops/stem_pallas_rejected.py:615"),
        "ps_roi_align_vpu": (roi_kernel.ps_roi_align_padded_vpu_kernel,
                             "millieye_torch/csrc/roi_align.cu",
                             "millieye_tpu/ops/roi_pallas.py:439"),
        "fused_stem": (stem.fused_stem, "millieye_torch/csrc/stem.cu",
                       "millieye_tpu/ops/stem_pallas.py:604"),
        "quantize_stochastic": (quantize.quantize_int8_stochastic,
                                "millieye_torch/csrc/quantize.cu",
                                "millieye_tpu/ops/quantize.py:54"),
    }

    def engine_at(preset, **cfg):
        model, params, state = build_fusion(CKPT, preset, **cfg)
        return FusionEngine(model, params, state, frame_size=FRAME)

    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2

    engines = {"pallas_max_s01": engine_at("pallas_max_s01"),
               "pallas_max4": engine_at("pallas_max4"),
               "pallas_stem": engine_at("pallas_stem"),
               "pallas_max4+highest": engine_at("pallas_max4",
                                                roi_precision="highest")}
    for preset in ("pallas_stem2", "pallas_max_pk", "pallas_pair2",
                   "pallas_deep", "pallas_lat", "f32", "s2d", "bf16_s2d",
                   "int8"):
        engines[preset] = engine_at(preset)

    rng = np.random.default_rng(0)
    checks = KernelChecks(torch, rng)
    t = time.time()
    for b in (1, 32):
        checks.nms(b)
        checks.roi_bf16(b)
        checks.roi_f32(b)
        checks.stems(b, engines["pallas_max_s01"].params["darknet"])
        checks.fused_stem_nhwc(b, engines["pallas_max_s01"].params["darknet"])
    w12 = engines["f32"].params["darknet"][12]["w"]
    checks.quantize(w12)
    torch.cuda.empty_cache()
    recs = [r for rs in checks.records.values() for r in rs]
    bounded = [r for r in recs if r["tol"] is not None]
    log(f"kernel phase: {len(recs) - len(bounded)} cases bit-equal to their "
        f"plain versions, {len(bounded)} (the tensor-core kernels at "
        f"'default') within {stem.PAIR_DEFAULT_TOL:.3g} of their plain "
        f"versions' largest output, at worst 2^"
        f"{max(np.log2(max(r['err'], 1e-30) / r['scale']) for r in bounded):.2f}"
        f" of it, at least {min(r['exact'] for r in bounded):.5f} of the "
        f"outputs bit-equal; {time.time() - t:.1f} s")
    for r in checks.records["stem_pair_deep"]:
        if r["err64"] is not None:
            log(f"deep pair {r['case']} b{r['batch']}: exact share "
                f"{r['exact']:.5f}; against the float64 function the kernel "
                f"is off by {r['err64'][0]:.4g}, the plain version by "
                f"{r['err64'][1]:.4g} (ratio "
                f"{r['err64'][0] / max(r['err64'][1], 1e-300):.4f}, at most 2)")
    log(f"K13 bit-equal to its plain version on {'; '.join(checks.k13_edges)}")
    for seed, mean, p39 in checks.k13_stats:
        log(f"K13 carrier, seed {seed}: values 38 and 39, dequantized mean "
            f"{mean:.5f} (0.3 within 0.003), P(39) {p39:.3f} (expect ~0.10); "
            f"seeds 0 and 1 differ")
    int8_conv = int8_conv_phase(torch, w12, np.random.default_rng(2))
    for b, r in int8_conv.items():
        log(f"int8 conv, block 12 (13x13, 512->1024, 3x3), b{b}: "
            f"{r['ms'][0]:.4f} ms [{r['ms'][1]:.4f}, {r['ms'][2]:.4f}] "
            f"through torch._int_mm, cuDNN float32 (TF32 off) "
            f"{r['cudnn_f32_ms'][0]:.4f} ms, bound {r['bound_ms'][0]:.6f} ms "
            f"({r['bound_ms'][1]}); bit-equal to the CPU at b1")
    for b, moved, total in checks.k8_vs_k4:
        log(f"K8 against K4 at 416 px, 'default', b{b}: {moved} of {total} "
            f"float16 outputs differ (the hi/lo pool select)")
    t = time.time()
    batch_cap = deep_batch_cases(torch)
    for r in batch_cap:
        log(f"batch cap: {r['case']} at n {r['n']} ({r['input_mb']:.0f} MB "
            f"in): max_abs_err {r['max_abs_err']:.3g} against the plain "
            f"version, exact share {r['exact_share']:.5f}")
    log(f"batch cap: {time.time() - t:.1f} s")

    rng = np.random.default_rng(1)      # the requests' own stream
    reqs = requests(rng, N_REQUESTS)
    launches_by_path, answers_by_path, summary = {}, {}, {}

    tc_kernels = stem.TENSOR_CORE_KERNELS

    def against_plain(path, got, call):
        """Hold one answer to the plain versions. A path that ran a
        tensor-core kernel is held bit-identical to the same call with
        only the tensor-core kernels launched (``plain_versions(keep=
        ...)``), and within PAIR_PATH_TOL of the fully plain call, or
        beyond it by NMS decisions alone (``nms_flips``); any other path
        bit-identical to the fully plain call. Returns (bit-identical to
        the fully plain answer, largest box and score differences of the
        paired rows, rows on one side only, and the anchors the pre-merge
        NMS and the inputs the post-merge NMS kept in one run only)."""
        boxes, valid = got
        with cuda_lib.plain_versions():
            ref = call()
        same = (np.array_equal(boxes, ref[0])
                and np.array_equal(valid, ref[1]))
        if path not in tc_paths:
            if not same:
                raise AssertionError(
                    f"{path}: kernels and plain versions disagree\n"
                    f"{boxes[valid]}\n{ref[0][ref[1]]}")
            return same, 0.0, 0.0, 0, (0, 0)
        with cuda_lib.plain_versions(keep=tc_kernels):
            kept = call()
        if not (np.array_equal(boxes, kept[0])
                and np.array_equal(valid, kept[1])):
            raise AssertionError(
                f"{path}: differs from its run with only the tensor-core "
                f"kernels launched\n{boxes[valid]}\n{kept[0][kept[1]]}")
        ok, db, ds, fl = rows_match((boxes, valid), ref, PAIR_PATH_TOL)
        if ok:
            return same, db, ds, fl, (0, 0)
        if path not in engines:
            raise AssertionError(
                f"{path}: differs from its fully plain run beyond "
                f"{PAIR_PATH_TOL} (box {db}, score {ds}, {fl} rows on one "
                f"side only)\n{boxes[valid]}\n{ref[0][ref[1]]}")
        try:
            moved = nms_flips(torch, cuda_lib, engines[path],
                              lambda: [call()], [got], PAIR_PATH_TOL)
        except AssertionError as e:
            raise AssertionError(
                f"{path}: {e}\n{boxes[valid]}\n{ref[0][ref[1]]}") from None
        return same, db, ds, fl, moved

    tc_paths = set()

    def drive(path, calls, shape, must_launch, bit_equal=False):
        """Run ``calls`` with the launch counts at 0, check the counts,
        the answers and their agreement with the plain versions
        (``against_plain``); ``bit_equal``: the path runs its kernels at
        "highest" only, so it is held bit-identical to the fully plain
        path whatever it launched."""
        for fn, *_ in kernels.values():
            fn.launches = 0
        answers, lat = [], []
        for call in calls:
            t0 = time.perf_counter()
            answers.append(call())
            lat.append(time.perf_counter() - t0)
        launches = {name: fn.launches for name, (fn, *_) in kernels.items()}
        launches_by_path[path] = launches
        short = {k: launches[k] for k, per in must_launch.items()
                 if launches[k] < per * len(calls)}
        if short:
            raise AssertionError(f"{path}: kernels launched too few times "
                                 f"over {len(calls)} calls: {short} (need "
                                 f"{must_launch} per call)")
        if not bit_equal and any(launches[k] for k in tc_kernels):
            tc_paths.add(path)
        n_valid, n_same, d_box, d_score, flips = [], 0, 0.0, 0.0, 0
        moved = np.zeros(2, int)
        for i, (call, (boxes, valid)) in enumerate(zip(calls, answers)):
            if boxes.shape != shape or not np.isfinite(boxes).all():
                raise AssertionError(f"{path} call {i}: bad answer "
                                     f"{boxes.shape}, want {shape}")
            same, db, ds, fl, mv = against_plain(path, (boxes, valid), call)
            n_same, flips, moved = n_same + same, flips + fl, moved + mv
            d_box, d_score = max(d_box, db), max(d_score, ds)
            n_valid.append(int(valid.sum()))
        timed = np.array(lat[N_WARM:]) * 1e3
        used = {k: v for k, v in launches.items() if v}
        held = (f"every answer bit-identical to the same path inside "
                f"cuda_lib.plain_versions(keep=<tensor-core kernels>) and "
                f"within PAIR_PATH_TOL of the fully plain path ({n_same} of "
                f"{len(calls)} bit-identical to it, the rest paired within "
                f"{d_box:.3g} px and {d_score:.3g} on scores, {flips} rows "
                f"on one side only; NMS decisions proven by nms_flips: "
                f"{moved[0]} anchors kept by the pre-merge NMS and "
                f"{moved[1]} inputs kept by the post-merge NMS in one run "
                f"only)" if path in tc_paths
                else "every answer bit-identical to the same path inside "
                "cuda_lib.plain_versions()")
        log(f"path {path}: {len(calls)} calls at 416 px, batch 1; launches "
            f"{used}; valid rows per answer {n_valid}; {held}; p50 "
            f"{np.median(timed):.2f} ms, max "
            f"{timed.max():.2f} ms, {1e3 / timed.mean():.1f} calls/s over "
            f"the last {len(timed)} (host clock, each call ends in a copy "
            f"to the host)")
        answers_by_path[path] = answers
        summary[path] = {"calls": len(calls),
                         "bit_identical_to_plain": n_same,
                         "against_plain": {"max_box_diff": d_box,
                                           "max_score_diff": d_score,
                                           "rows_on_one_side": flips,
                                           "nms_kept_on_one_side": {
                                               "pre_merge_anchors":
                                                   int(moved[0]),
                                               "post_merge_inputs":
                                                   int(moved[1])}},
                         "p50_ms": float(np.median(timed)),
                         "per_s": float(1e3 / timed.mean()),
                         "valid_rows": n_valid}

    def infer_calls(engine):
        return [lambda r=r: engine.infer(*r) for r in reqs]

    def rows(engine):
        return (engine.model.cfg.max_det + engine.model.cfg.max_radar, 6)

    one = dict.fromkeys
    eng = engines["pallas_max_s01"]
    drive("pallas_max_s01", infer_calls(eng), rows(eng),
          one(("nms", "ps_roi_align", "roi_align", "stem_pair", "nms_full"),
              1))
    eng = engines["pallas_max4"]
    drive("pallas_max4", infer_calls(eng), rows(eng),
          one(("stem_stage", "stem_pair", "nms", "ps_roi_align",
               "roi_align", "nms_full"), 1))
    eng = engines["pallas_stem"]
    drive("pallas_stem", infer_calls(eng), rows(eng),
          {"stem_stage": 2, "nms": 1, "nms_full": 1}, bit_equal=True)
    eng = engines["pallas_max4+highest"]
    drive("pallas_max4+highest", infer_calls(eng), rows(eng),
          one(("ps_roi_align_padded_f32", "roi_align", "stem_stage",
               "stem_pair", "nms", "nms_full"), 1))

    # the stem-kernel ladder: K8, K11, K12 (stem pair, deep pair) and K2's
    # "vpu" reduce on their serving rows
    for path, must in (
            ("pallas_stem2", ("stem_pair_select", "nms")),
            ("pallas_max_pk", ("stem_pair_packed", "ps_roi_align",
                               "roi_align", "nms")),
            ("pallas_pair2", ("stem_pair_s2d", "stem_pair_deep",
                              "ps_roi_align", "roi_align", "nms")),
            ("pallas_deep", ("stem_pair_s2d", "ps_roi_align", "roi_align",
                             "nms")),
            ("pallas_lat", ("stem_pair", "ps_roi_align_vpu", "roi_align",
                            "nms"))):
        eng = engines[path]
        need = one(must + ("nms_full",), 1)
        if path == "pallas_deep":
            need["stem_stage"] = 2               # stages 4 and 6
        drive(path, infer_calls(eng), rows(eng), need)
    # K11 computes K4's function: the packed path repeats P1's answers
    if not all(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
               for g, w in zip(answers_by_path["pallas_max_pk"],
                               answers_by_path["pallas_max_s01"])):
        raise AssertionError("pallas_max_pk: answers differ from "
                             "pallas_max_s01's")
    # K = 256 takes K1 in batched_nms: K5 runs only in the post-merge NMS
    lat = launches_by_path["pallas_lat"]
    if lat["nms_full"] > N_REQUESTS or lat["ps_roi_align"]:
        raise AssertionError(f"pallas_lat: launched the whole-matrix NMS "
                             f"before the merge or K2's 'dot' wrapper: {lat}")

    # the s2d stem and the int8 ladder (P11-P14) beside the plain float32
    # network; int8_acts calibrated on the requests' frames
    model, params, state = build_fusion(CKPT, "int8_acts")
    absmax = calibrate(model, params, state, [f for f, _, _ in reqs])
    engines["int8_acts"] = FusionEngine(model, params, state,
                                        frame_size=FRAME, act_absmax=absmax)
    for path in ("f32", "s2d", "bf16_s2d", "int8", "int8_acts"):
        eng = engines[path]
        drive(path, infer_calls(eng), rows(eng), {"nms": 1, "nms_full": 1})
    for path in ("s2d", "int8", "int8_acts"):
        flips, d_box, d_score, exact, near = 0, 0.0, 0.0, 0, []
        for got, want in zip(answers_by_path[path], answers_by_path["f32"]):
            ok, db, ds, fl = rows_match(got, want, WINDOW_TOL)
            if path == "s2d" and not ok:
                raise AssertionError(
                    f"s2d: differs from f32 beyond {WINDOW_TOL} (box {db}, "
                    f"score {ds}, {fl} rows on one side only)")
            exact += int(np.array_equal(got[0], want[0])
                         and np.array_equal(got[1], want[1]))
            flips, d_box, d_score = flips + fl, max(d_box, db), max(d_score,
                                                                    ds)
            g, w = got[0][got[1]], want[0][want[1]]
            if len(g) and len(w):     # each row's nearest f32 box, px
                near += list(np.abs(g[:, None, :4] - w[None, :, :4])
                             .max(-1).min(1))
        n_rows = int(sum(v.sum() for _, v in answers_by_path["f32"]))
        near_q = [float(np.percentile(near, q)) for q in (50, 90)] \
            if near else [None, None]
        summary[path]["against_f32"] = {
            "bit_identical": exact, "max_box_diff": d_box,
            "max_score_diff": d_score, "rows_on_one_side": flips,
            "f32_rows": n_rows, "nearest_box_px_p50_p90": near_q}
        log(f"{path} against f32 over {N_REQUESTS} requests: {exact} answers "
            f"bit-identical, paired rows within {d_box:.3g} px and {d_score:.3g}"
            f" on scores, {flips} of {n_rows} rows on one side only; each "
            f"row's nearest f32 box {near_q[0]:.3g} px at the median, "
            f"{near_q[1]:.3g} at the 90th percentile"
            + (f" (held to {WINDOW_TOL} per request: the s2d rewrite is "
               f"exact in real arithmetic, cuDNN sums in another order)"
               if path == "s2d" else " (post-training quantization: "
               "reported, not held)"))

    # K10 and K13 as their only JAX callers run them: K10 as the JAX tests
    # do, on each request's letterboxed frame with stage 0's served
    # weights, held to cuDNN's float32 stage (atol 1e-4, their tolerance),
    # and once at block 8's served weights (26 px, 128 -> 256: the
    # streamed route, ``stem.nhwc_route``) on a seeded input, held within
    # 1e-5 of the largest output of cuDNN's float32 block (as the CPU
    # tests hold the plain version to the JAX function); K13 as
    # benchmarks/quantize_tpu_check.py does, the carrier at seeds 0 and 1
    from millieye_torch.ops import letterbox
    dn = engines["f32"].params["darknet"]
    stem_inputs = [(letterbox.letterbox_image(torch.from_numpy(f).cuda(),
                                              416)[0][None], dn[0], 26)
                   for f, _, _ in reqs]
    stem_inputs.append((torch.tensor(
        np.random.default_rng(8).uniform(0, 1, (1, 26, 26, 128)),
        dtype=torch.float32, device="cuda"), dn[8], 13))
    carrier = torch.full((8, 128), 0.3, device="cuda")
    carrier[0, 0] = 1.0
    for path, name, calls in (
            ("direct fused_stem", "fused_stem",
             [lambda im=im, p=p, th=th: stem.fused_stem(
                 im, p["w"].permute(2, 3, 1, 0).contiguous(), p["b"], th)
              for im, p, th in stem_inputs]),
            ("direct quantize_stochastic", "quantize_stochastic",
             [lambda s=s: quantize.quantize_int8_stochastic(carrier, s)[0]
              for s in (0, 1)])):
        for fn, *_ in kernels.values():
            fn.launches = 0
        outs = [call() for call in calls]
        launches_by_path[path] = {k: fn.launches
                                  for k, (fn, *_) in kernels.items()}
        if launches_by_path[path][name] != len(calls):
            raise AssertionError(f"{path}: {launches_by_path[path]}")
        with cuda_lib.plain_versions():
            if not all(torch.equal(o, call()) for o, call in zip(outs,
                                                                 calls)):
                raise AssertionError(f"{path}: kernel and plain version "
                                     f"disagree")
        if name == "fused_stem":
            errs = [float((o - cudnn_stem(torch, im, [(p["w"], p["b"])],
                                          torch.float32)()).abs().max())
                    for o, (im, p, _) in zip(outs, stem_inputs)]
            wide = float(outs[-1].abs().max())
            if not (max(errs[:-1]) <= 1e-4 and errs[-1] <= 1e-5 * wide):
                raise AssertionError(f"{path}: off cuDNN's float32 stage by "
                                     f"{errs}")
            note = (f"within {max(errs[:-1]):.3g} of cuDNN's float32 stage; "
                    f"block 8 (128 -> 256, route "
                    f"{stem.nhwc_route(128, 256)}) within {errs[-1]:.3g} "
                    f"of cuDNN's float32 block, largest value {wide:.4g}")
        else:
            stats = [stochastic_stats(q, 1.0 / 127) for q in outs]
            if torch.equal(outs[0], outs[1]):
                raise AssertionError(f"{path}: seeds 0 and 1 gave one stream")
            note = f"carrier (mean, P(39)) {stats}, seeds differ"
        log(f"path {path}: {len(calls)} calls, launches "
            f"{ {k: v for k, v in launches_by_path[path].items() if v} }, "
            f"bit-identical to the plain version; {note}")

    # entry(): the float32 flagship forward; its example inputs with a new
    # image for each call
    fn, args = entry()
    images = [torch.tensor(rng.uniform(size=(1, 416, 416, 3)),
                           dtype=torch.float32, device="cuda")
              for _ in range(N_REQUESTS)]
    images[0] = args[2]

    def entry_call(img):
        boxes, valid = fn(args[0], args[1], img, *args[3:])
        return boxes.cpu().numpy(), valid.cpu().numpy()

    drive("entry", [lambda im=im: entry_call(im) for im in images],
          (1, 232, 7), {"nms_full": 1})

    # module2: the camera-only refinement network through kernel K6
    model2, p2, s2 = build_refine(CKPT, "f32", roi_impl="kernel")
    p2, s2 = fold_for_serving(model2, p2, s2)
    log("refine path: Darknet and the score-map stack from the fusion "
        "checkpoint; the refinement and ensemble heads are UNTRAINED "
        "(seeded initialisers, torch.Generator().manual_seed(0)): no "
        "module2 checkpoint is tracked")

    @torch.no_grad()
    def refine_call(img):
        out = model2.apply(p2, s2, img)
        return out["boxes"].cpu().numpy(), out["valid"].cpu().numpy()

    drive("refine", [lambda im=im: refine_call(im) for im in images],
          (1, 200, 7), {"ps_roi_align_f32": 1, "nms": 1})

    # one batched window of the 8 frames at pallas_max4
    eng = engines["pallas_max4"]
    tens = window_tensors(torch, eng, reqs)
    step = eng.batched_step_fn(0)
    step(*tens)                                   # warm-up at batch 8
    for wfn, *_ in kernels.values():
        wfn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrows, wvalid = step(*tens)
    wrows, wvalid = wrows.cpu().numpy(), wvalid.cpu().numpy()
    window_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: wfn.launches for name, (wfn, *_) in kernels.items()}
    launches_by_path["window8@pallas_max4"] = launches
    short = [k for k in ("stem_stage", "stem_pair", "nms", "ps_roi_align",
                         "roi_align") if launches[k] < 1]
    if short:
        raise AssertionError(f"batched window: kernels not launched: {short}")
    if launches["nms_full"] != 1:       # one post-merge NMS for the window
        raise AssertionError(f"batched window: K5 launched "
                             f"{launches['nms_full']} times, want once")
    window_nms_per_frame(torch, eng, step, tens, (wrows, wvalid))
    if wrows.shape != (N_REQUESTS,) + rows(eng) \
            or not np.isfinite(wrows).all():
        raise AssertionError(f"batched window: bad answer {wrows.shape}")
    with cuda_lib.plain_versions(keep=tc_kernels):
        krows, kvalid = step(*tens)
    if not (np.array_equal(wrows, krows.cpu().numpy())
            and np.array_equal(wvalid, kvalid.cpu().numpy())):
        raise AssertionError("batched window: differs from its run with only "
                             "the tensor-core kernels launched")
    with cuda_lib.plain_versions():
        prows, pvalid = step(*tens)
    prows, pvalid = prows.cpu().numpy(), pvalid.cpu().numpy()
    window_plain_same, wp_box, wp_score, wp_flips, wp_moved = (0, 0.0, 0.0,
                                                               0, (0, 0))
    beyond = False
    for i in range(N_REQUESTS):
        ok, db, ds, fl = rows_match((wrows[i], wvalid[i]),
                                    (prows[i], pvalid[i]), PAIR_PATH_TOL)
        beyond |= not ok
        window_plain_same += int(np.array_equal(wrows[i], prows[i])
                                 and np.array_equal(wvalid[i], pvalid[i]))
        wp_box, wp_score = max(wp_box, db), max(wp_score, ds)
        wp_flips += fl

    def window_frames():
        r, v = (a.cpu().numpy() for a in step(*tens))
        return list(zip(r, v))

    if beyond:
        try:
            wp_moved = nms_flips(torch, cuda_lib, eng, window_frames,
                                 list(zip(wrows, wvalid)), PAIR_PATH_TOL)
        except AssertionError as e:
            raise AssertionError(f"batched window: {e}") from None
    exact, d_box, d_score, flipped = 0, 0.0, 0.0, 0
    for i, want in enumerate(answers_by_path["pallas_max4"]):
        got = (wrows[i], wvalid[i])
        if np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1]):
            exact += 1
            continue
        ok, db, ds, fl = rows_match(got, want, WINDOW_TOL)
        if not ok:
            raise AssertionError(
                f"batched window, frame {i}: differs from the per-frame "
                f"answer beyond {WINDOW_TOL} (box {db}, score {ds}, {fl} "
                f"rows on one side only)\n"
                f"{got[0][got[1]]}\n{want[0][want[1]]}")
        d_box, d_score = max(d_box, db), max(d_score, ds)
        flipped += fl
    n_rows = int(sum(v.sum() for _, v in answers_by_path["pallas_max4"]))
    log(f"batched window of {N_REQUESTS} frames at pallas_max4: launches "
        f"{ {k: v for k, v in launches.items() if v} }; bit-identical to "
        f"the same window inside cuda_lib.plain_versions(keep=<tensor-"
        f"core kernels>), within PAIR_PATH_TOL of the fully plain window "
        f"({window_plain_same} of {N_REQUESTS} frames bit-identical to it, "
        f"the rest within {wp_box:.3g} px and {wp_score:.3g} on scores, "
        f"{wp_flips} rows on one side only; NMS decisions proven by "
        f"nms_flips: {wp_moved[0]} anchors kept by the pre-merge NMS and "
        f"{wp_moved[1]} inputs kept by the post-merge NMS in one run only); "
        f"the post-merge NMS one K5 launch, bit-identical to it frame by "
        f"frame; {exact} of "
        f"{N_REQUESTS} answers bit-identical to the per-frame answers, the "
        f"rest paired by box within {d_box:.3g} px and {d_score:.3g} on "
        f"scores, {flipped} of {n_rows} rows on one side only (tolerance "
        f"{WINDOW_TOL} per frame: cuDNN sums a batch-8 convolution in "
        f"another order); {window_ms:.2f} ms for the window "
        f"({N_REQUESTS * 1e3 / window_ms:.1f} frames/s, host clock)")
    summary["window8@pallas_max4"] = {
        "ms": window_ms, "frames_per_s": N_REQUESTS * 1e3 / window_ms,
        "bit_identical_to_plain": window_plain_same,
        "against_plain": {"max_box_diff": wp_box, "max_score_diff": wp_score,
                          "rows_on_one_side": wp_flips,
                          "nms_kept_on_one_side": {
                              "pre_merge_anchors": wp_moved[0],
                              "post_merge_inputs": wp_moved[1]}},
        "bit_identical": exact, "max_box_diff": d_box,
        "max_score_diff": d_score, "rows_on_one_side": flipped}

    # the reference's window contract at its float32 default
    # (tests/test_runtime.py:147-150): one window of the 8 frames at f32,
    # each frame against its own per-frame answer: valid equal, rows within
    # rtol 1e-4 and atol 1e-4
    eng = engines["f32"]
    ftens = window_tensors(torch, eng, reqs)
    fstep = eng.batched_step_fn(0)
    fstep(*ftens)                                 # warm-up at batch 8
    for wfn, *_ in kernels.values():
        wfn.launches = 0
    frows, fvalid = (a.cpu().numpy() for a in fstep(*ftens))
    launches = {name: wfn.launches for name, (wfn, *_) in kernels.items()}
    launches_by_path["window8@f32"] = launches
    if launches["nms"] < 1 or launches["nms_full"] != 1:
        raise AssertionError(f"f32 window: want K1 launched and K5 once: "
                             f"{launches}")
    if frows.shape != (N_REQUESTS,) + rows(eng) \
            or not np.isfinite(frows).all():
        raise AssertionError(f"f32 window: bad answer {frows.shape}")
    with cuda_lib.plain_versions():
        prows, pvalid = (a.cpu().numpy() for a in fstep(*ftens))
    if not (np.array_equal(frows, prows) and np.array_equal(fvalid, pvalid)):
        raise AssertionError("f32 window: differs from the same window "
                             "inside cuda_lib.plain_versions()")
    window_nms_per_frame(torch, eng, fstep, ftens, (frows, fvalid))
    f32_err, f32_exact = 0.0, 0
    for i, (want, want_valid) in enumerate(answers_by_path["f32"]):
        if not (np.array_equal(fvalid[i], want_valid)
                and np.allclose(frows[i], want, rtol=1e-4, atol=1e-4)):
            raise AssertionError(
                f"f32 window, frame {i}: differs from the per-frame answer "
                f"beyond the reference's contract (valid equal, rtol 1e-4, "
                f"atol 1e-4)\n{frows[i][fvalid[i]]}\n{want[want_valid]}")
        f32_err = max(f32_err, float(np.abs(frows[i] - want).max()))
        f32_exact += int(np.array_equal(frows[i], want))
    log(f"batched window of {N_REQUESTS} frames at f32: launches "
        f"{ {k: v for k, v in launches.items() if v} }; bit-identical to "
        f"the same window inside cuda_lib.plain_versions(), its post-merge "
        f"NMS one K5 launch, bit-identical to it frame by frame; against the "
        f"per-frame answers valid equal, {f32_exact} of {N_REQUESTS} rows "
        f"arrays bit-identical, the largest row difference {f32_err:.3g} "
        f"(the reference's rtol 1e-4, atol 1e-4)")
    summary["window8@f32"] = {"bit_identical": f32_exact,
                              "max_row_diff": f32_err}

    # the NMS kernels on the serving shape: valid a prefix of the live
    # rows that P1, P2 and the pallas_max4 window feed them
    live = nms_live_rows(torch, [
        (engines["pallas_max_s01"], infer_calls(engines["pallas_max_s01"])),
        (engines["pallas_max4"], infer_calls(engines["pallas_max4"])
         + [lambda: step(*tens)])])
    log("live rows fed to the NMS kernels by P1, P2 and the pallas_max4 "
        "window: " + "; ".join(f"{n} K={k}: {sorted(c)}"
                               for (n, k), c in sorted(live.items())))
    for b in (1, 32):
        checks.nms(b, live)

    # the alias rows: one request each; their launches, and their answer
    # bit-identical to the row they repeat (the JAX package's comments: a
    # bf16-scratch or VMEM-input spelling is bit-identical to its f32-DMA
    # twin, packed and s2d compute the phase kernel's products, "vpu" the
    # "dot" reduce's)
    twins = {name: "pallas_max_s01" for name in (
        "pallas_max_s2d", "pallas_max_bf16s", "pallas_max_pk_bf16s",
        "pallas_max_s2d_bf16s", "pallas_max_vm", "pallas_max_vm_s01",
        "pallas_max_vm_bf16s")}
    twins.update(pallas_s2d8="pallas_s2d", pallas_maxv="pallas_s2d")
    alias_kernel = {"pallas_max_s2d": "stem_pair_s2d",
                    "pallas_max_s2d_bf16s": "stem_pair_s2d",
                    "pallas_max_pk_bf16s": "stem_pair_packed",
                    "pallas_s2d": "stem_pair_s2d",
                    "pallas_s2d8": "stem_pair_s2d"}
    alias_answers = {"pallas_max_s01": answers_by_path["pallas_max_s01"][0]}
    for name in ["pallas_s2d"] + sorted(twins):
        eng = engine_at(name)
        for fn, *_ in kernels.values():
            fn.launches = 0
        got = eng.infer(*reqs[0])
        launches = {k: fn.launches for k, (fn, *_) in kernels.items()}
        launches_by_path[f"alias {name}"] = launches
        need = [alias_kernel.get(name, "stem_pair"), "roi_align", "nms",
                "nms_full", "ps_roi_align_vpu" if name == "pallas_maxv"
                else "ps_roi_align"]
        if any(launches[k] < 1 for k in need):
            raise AssertionError(f"alias {name}: launches {launches}, need "
                                 f"{need}")
        alias_answers[name] = got
        if name in twins:
            want = alias_answers[twins[name]]
            if not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1])):
                raise AssertionError(f"alias {name}: differs from "
                                     f"{twins[name]}")
        del eng
    log(f"alias rows: one request each, launches as named, answers "
        f"bit-identical to their twins {twins}")

    profiles = {p: profile_calls(torch, p, infer_calls(engines[p])[:4])
                for p in ("pallas_max_s01", "pallas_max4", "pallas_pair2",
                          "pallas_deep", "pallas_max4+highest",
                          "pallas_stem")}
    profiles["refine"] = profile_calls(
        torch, "refine", [lambda im=im: refine_call(im) for im in images[:4]])
    profiles["window8@pallas_max4"] = profile_calls(
        torch, "the window of 8 frames at pallas_max4 (a request: one "
        "window)", [lambda: step(*tens)] * 2)

    # P15 and P16: the recorded session through the streaming runtime,
    # the radar inputs from the host chain (sync -> projection -> DBSCAN
    # -> Kalman/Hungarian tracker -> proposals) at the demo's defaults
    import tempfile
    from millieye_torch.radar.dbscan import dbscan
    from millieye_torch.radar.hungarian import assign
    from millieye_torch.radar.pipeline import RadarParams
    from millieye_torch.runtime.stream import StreamingPipeline

    def zero_counts():
        for fn, *_ in kernels.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, (fn, *_) in kernels.items()}

    def collect(store):
        return lambda i, b, v: store.update({i: (b, v)})

    t = time.time()
    params = RadarParams()
    stream_dir = tempfile.TemporaryDirectory()
    rec = stream_dir.name
    frames = write_recording(rec)
    n_frames = len(frames)

    # P15: per frame at pallas_max_s01, lossless, against FusionEngine.infer
    # fed by a second RadarPipeline replaying the recording
    eng = engines["pallas_max_s01"]
    replay, radar_ms = radar_replay(rec, eng, params)
    with_props = sum(len(p) > 0 for _, p in replay)
    most_points = max(len(p) for p, _ in replay)
    if with_props < n_frames / 2 or most_points <= eng.max_points:
        raise AssertionError(f"stream: the tracker gave proposals on "
                             f"{with_props} of {n_frames} frames, the "
                             f"largest cloud {most_points} points")
    want = [eng.infer(f, *r) for (_, f), r in zip(frames, replay)]
    zero_counts()
    eng.warmup(0)
    warm = counts()
    zero_counts()
    dbscan.backends.clear()
    assign.backends.clear()
    pipe = StreamingPipeline(eng, rec, STREAM_CALIB, params, frames=frames,
                             drop_on_full=False)
    got = {}
    n, report = pipe.run(on_result=collect(got))
    launches = counts()
    launches_by_path["stream@pallas_max_s01"] = launches
    backends = {"dbscan": dict(dbscan.backends),
                "hungarian": dict(assign.backends)}
    per_frame = {k: launches[k] - warm[k] for k in
                 ("stem_pair", "nms", "ps_roi_align", "roi_align",
                  "nms_full")}
    if n != n_frames or sorted(got) != list(range(n_frames)) \
            or set(per_frame.values()) != {n_frames}:
        raise AssertionError(f"stream: {n} frames, launches past the "
                             f"warm-up {per_frame}, want each {n_frames}")
    differ = [i for i in range(n_frames) if not same_answer(got[i], want[i])]
    if differ:
        raise AssertionError(f"stream: frames {differ} differ from "
                             f"FusionEngine.infer on the same frame")
    if any(not np.isfinite(b).all() or b.shape != rows(eng)
           for b, _ in got.values()):
        raise AssertionError("stream: an answer is not finite or of the "
                             "wrong shape")
    live = StreamingPipeline(eng, rec, STREAM_CALIB, params, frames=frames,
                             drop_on_full=True)
    got_live = {}
    n_live, live_report = live.run(on_result=collect(got_live))
    if n_live + live.dropped != n_frames or not all(
            same_answer(a, got[i]) for i, a in got_live.items()):
        raise AssertionError(f"stream, live mode: {n_live} frames + "
                             f"{live.dropped} dropped, or a delivered frame "
                             f"differs from the lossless run")
    # the step never waits for the card: no host sync inside it, and in
    # a profiled run no more than the drain's two fetches a frame
    staged = [pipe._stage(f, eng.pack_radar(*r), None)
              for (_, f), r in zip(frames[:8], replay)]
    step = eng.step_fn(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fr, packed in staged:
            step(fr, *packed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # (the profiler's own cost grows with the trace: 24 frames)
    n_prof = STREAM_PROFILED
    _, _, warm_syncs, warm_d2h = profile_run(torch, lambda: eng.warmup(0))
    busy, wall, syncs, d2h = profile_run(torch, lambda: StreamingPipeline(
        eng, rec, STREAM_CALIB, params, frames=frames[:n_prof],
        drop_on_full=False).run())
    if syncs - warm_syncs > 2 * n_prof:
        raise AssertionError(f"stream: {syncs - warm_syncs} host syncs "
                             f"past the warm-up over {n_prof} frames, "
                             f"more than the drain's two a frame")
    log(f"path stream@pallas_max_s01 ({card}): {n} frames of 640x480 "
        f"through StreamingPipeline.run(drop_on_full=False) on the recorded "
        f"session (3 walkers, radar at 20 fps), each bit-identical to "
        f"FusionEngine.infer fed by a second RadarPipeline; launches "
        f"{ {k: v for k, v in launches.items() if v} } (the warm-up frame "
        f"{ {k: v for k, v in warm.items() if v} }): {per_frame} a frame "
        f"each; e2e_fps {report['e2e_fps']}, StageTimer {report}; "
        f"proposals on {with_props} of {n_frames} frames, the largest "
        f"cloud {most_points} points (trimmed to {eng.max_points}); radar "
        f"chain on the host {np.mean(radar_ms):.3f} ms a frame (p50 "
        f"{np.median(radar_ms):.3f}, max {max(radar_ms):.3f}); backends "
        f"{backends}; live mode (drop_on_full=True): {n_live} frames + "
        f"{live.dropped} dropped, each delivered frame the lossless "
        f"answer, e2e_fps {live_report['e2e_fps']}; no host sync inside "
        f"the step (torch.cuda.set_sync_debug_mode('error') over 8 "
        f"frames); profiled run of {n_prof} frames: device busy "
        f"{busy:.2f} ms of {wall:.2f} ms wall ({100 * busy / wall:.1f}%), "
        f"host syncs {syncs} "
        f"(warm-up {warm_syncs}), device-to-host copies {d2h} (warm-up "
        f"{warm_d2h}); {time.time() - t:.1f} s")
    t = time.time()
    summary["stream@pallas_max_s01"] = {
        "frames": n, "e2e_fps": report["e2e_fps"],
        "stage_fps": {k: report[k] for k in ("track", "device")
                      if k in report},
        "dropped": report["dropped"], "launches_per_frame": per_frame,
        "frames_with_proposals": with_props, "largest_cloud": most_points,
        "radar_host_ms_mean": float(np.mean(radar_ms)),
        "radar_host_ms_p50": float(np.median(radar_ms)),
        "backends": backends,
        "live": {"frames": n_live, "dropped": live.dropped,
                 "e2e_fps": live_report["e2e_fps"]},
        "profiled": {"frames": n_prof, "device_busy_ms": busy,
                     "wall_ms": wall, "busy_share": busy / wall,
                     "host_syncs": syncs, "warmup_host_syncs": warm_syncs,
                     "d2h_copies": d2h}}

    # P16: windows of 32 at pallas_max4 (90 frames: the last window 26
    # frames and 6 pads), host-fed and staged, against batched_step_fn on
    # the stacked arrays and the per-frame answers
    eng = engines["pallas_max4"]
    nw = STREAM_WINDOW_FRAMES
    per = [eng.infer(f, *r) for (_, f), r in zip(frames[:nw], replay)]
    zero_counts()
    dbscan.backends.clear()
    assign.backends.clear()
    pipe = StreamingPipeline(eng, rec, STREAM_CALIB, params, frames=frames)
    got = {}
    n, report = pipe.run_batched(window=STREAM_WINDOW,
                                 on_result=collect(got), max_frames=nw)
    launches = counts()
    launches_by_path["stream windows@pallas_max4"] = launches
    backends = {"dbscan": dict(dbscan.backends),
                "hungarian": dict(assign.backends)}
    n_win = -(-nw // STREAM_WINDOW)
    if n != nw or sorted(got) != list(range(nw)) \
            or launches["nms_full"] != n_win + 1:
        raise AssertionError(f"stream windows: {n} frames, K5 launched "
                             f"{launches['nms_full']} times (want one a "
                             f"window and the warm-up window's)")
    step = eng.batched_step_fn(0)
    windows = []
    for lo in range(0, nw, STREAM_WINDOW):
        idx = list(range(lo, min(lo + STREAM_WINDOW, nw)))
        pad = idx + [idx[-1]] * (STREAM_WINDOW - len(idx))
        packed = [eng.pack_radar(*replay[i]) for i in pad]
        arrays = [np.stack([frames[i][1] for i in pad])] + [
            np.stack(c) for c in zip(*packed)]
        windows.append((idx, tuple(torch.from_numpy(a).cuda()
                                   for a in arrays)))
    w_exact, w_within, w_class, w_box, w_score, w_flips = 0, 0, 0, 0.0, \
        0.0, 0
    w_plain, w_moved, f_moved = 0, np.zeros(2, int), np.zeros(2, int)
    for idx, tens in windows:
        zero_counts()
        wr, wv = (a.cpu().numpy() for a in step(*tens))
        if counts()["nms_full"] != 1:
            raise AssertionError("stream windows: K5 not once a window")
        if not all(same_answer((wr[j], wv[j]), got[i])
                   for j, i in enumerate(idx)):
            raise AssertionError(f"stream windows {idx[0]}-{idx[-1]}: the "
                                 f"stream differs from batched_step_fn on "
                                 f"the stacked arrays")
        with cuda_lib.plain_versions(keep=tc_kernels):
            kr, kv = (a.cpu().numpy() for a in step(*tens))
        if not same_answer((wr, wv), (kr, kv)):
            raise AssertionError("stream windows: differ from the run with "
                                 "only the tensor-core kernels launched")
        with cuda_lib.plain_versions():
            pr, pv = (a.cpu().numpy() for a in step(*tens))
        beyond = False
        for j in range(len(idx)):
            ok, db, ds, fl = rows_match((wr[j], wv[j]), (pr[j], pv[j]),
                                        PAIR_PATH_TOL)
            beyond |= not ok
            w_plain += same_answer((wr[j], wv[j]), (pr[j], pv[j]))
        if beyond:
            try:
                w_moved += nms_flips(
                    torch, cuda_lib, eng,
                    lambda tens=tens: list(zip(*(a.cpu().numpy()
                                                 for a in step(*tens)))),
                    list(zip(wr, wv)), PAIR_PATH_TOL)
            except AssertionError as e:
                raise AssertionError(f"stream windows: {e}") from None
        # against the per-frame answers: WINDOW_TOL, else the bf16 class
        # (a batch of 32 moves some boxes 0.5-0.65 px), else NMS
        # decisions alone, proven at the bf16 class
        beyond = False
        for i in idx:
            w_exact += same_answer(got[i], per[i])
            w_within += rows_match(got[i], per[i], WINDOW_TOL)[0]
            ok, db, ds, fl = rows_match(got[i], per[i], PAIR_PATH_TOL)
            w_class += ok
            beyond |= not ok
            w_box, w_score, w_flips = max(w_box, db), max(w_score, ds), \
                w_flips + fl
        if beyond:
            pad = idx + [idx[-1]] * (STREAM_WINDOW - len(idx))
            try:
                f_moved += window_flips(
                    torch, cuda_lib, eng,
                    lambda tens=tens: list(zip(*(a.cpu().numpy()
                                                 for a in step(*tens)))),
                    [lambda i=i: eng.infer(frames[i][1], *replay[i])
                     for i in pad], list(zip(wr, wv)), PAIR_PATH_TOL)
            except AssertionError as e:
                raise AssertionError(f"stream windows {idx[0]}-{idx[-1]} "
                                     f"against the per-frame answers: "
                                     f"{e}") from None
    pipe2 = StreamingPipeline(eng, rec, STREAM_CALIB, params, frames=frames)
    got_staged = {}
    n_staged, staged_report = pipe2.run_batched(
        window=STREAM_WINDOW, staged=windows,
        on_result=collect(got_staged))
    if n_staged != nw or not all(same_answer(got_staged[i], got[i])
                                 for i in range(nw)):
        raise AssertionError("stream windows: the staged replay differs "
                             "from the host-fed windows")
    busy, wall, syncs, d2h = profile_run(torch, lambda: StreamingPipeline(
        eng, rec, STREAM_CALIB, params, frames=frames).run_batched(
            window=STREAM_WINDOW, max_frames=STREAM_WINDOW))
    n_rows = int(sum(v.sum() for _, v in per))
    log(f"path stream windows@pallas_max4 ({card}): {n} frames through "
        f"StreamingPipeline.run_batched(window={STREAM_WINDOW}, "
        f"max_frames={nw}): {n_win} windows, the last padded; each window "
        f"bit-identical to batched_step_fn on the stacked arrays and to the "
        f"same window inside cuda_lib.plain_versions(keep=<tensor-core "
        f"kernels>), K5 once a window; within PAIR_PATH_TOL of the fully "
        f"plain windows ({w_plain} of {nw} frames bit-identical to them; "
        f"NMS decisions proven by nms_flips: {w_moved[0]} anchors and "
        f"{w_moved[1]} post-merge inputs kept in one run only); staged "
        f"replay bit-identical to the host-fed windows (e2e_fps "
        f"{staged_report['e2e_fps']}); against the per-frame answers "
        f"{w_exact} of {nw} frames bit-identical, {w_within} within "
        f"WINDOW_TOL {WINDOW_TOL}, {w_class} within PAIR_PATH_TOL (the "
        f"bf16 class; paired rows within {w_box:.3g} px and {w_score:.3g} "
        f"on scores, {w_flips} of {n_rows} rows on one side only), the "
        f"other {nw - w_class} beyond it by NMS decisions alone, proven by "
        f"window_flips ({f_moved[0]} anchors and {f_moved[1]} post-merge "
        f"inputs kept on one side only); "
        f"launches { {k: v for k, v in launches.items() if v} } (the "
        f"warm-up window's included); e2e_fps {report['e2e_fps']}, "
        f"StageTimer {report}; backends {backends}; profiled run of one "
        f"window (its warm-up window included): device busy {busy:.2f} ms "
        f"of {wall:.2f} ms wall "
        f"({100 * busy / wall:.1f}%); {time.time() - t:.1f} s")
    summary["stream windows@pallas_max4"] = {
        "frames": n, "window": STREAM_WINDOW, "windows": n_win,
        "e2e_fps": report["e2e_fps"],
        "staged_e2e_fps": staged_report["e2e_fps"],
        "stage_fps": {k: report[k] for k in ("track", "device")
                      if k in report},
        "dropped": report["dropped"], "backends": backends,
        "bit_identical_to_plain": w_plain,
        "nms_kept_on_one_side": {"pre_merge_anchors": int(w_moved[0]),
                                 "post_merge_inputs": int(w_moved[1])},
        "bit_identical_to_per_frame": w_exact,
        "within_window_tol": w_within, "within_pair_path_tol": w_class,
        "max_box_diff": w_box, "max_score_diff": w_score,
        "rows_on_one_side": w_flips,
        "per_frame_nms_kept_on_one_side": {
            "pre_merge_anchors": int(f_moved[0]),
            "post_merge_inputs": int(f_moved[1])},
        "profiled": {"frames": STREAM_WINDOW, "device_busy_ms": busy,
                     "wall_ms": wall, "busy_share": busy / wall}}
    stream_dir.cleanup()

    line = []
    for name, (_, src, replaces) in kernels.items():
        per_path = {p: l[name] for p, l in launches_by_path.items()
                    if l[name]}
        for r in checks.records[name]:
            log_case(name, r)
        log(f"kernel {name}: launches by path {per_path}")

        first = flat(checks.records[name][0])     # its first case, batch 1
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": max(r["err"] for r in checks.records[name]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "cases": [flat(r) for r in checks.records[name]]})
    log(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": line, "card": card, "paths": summary,
                      "profile": profiles, "batch_cap": batch_cap,
                      "int8_conv": {f"b{b}": r for b, r in int8_conv.items()},
                      "k8_vs_k4": [{"batch": b, "differ": m, "outputs": t}
                                   for b, m, t in checks.k8_vs_k4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
