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
     takes), K4 at "default" storing float32 at batch 8 and 32 (the training
     forward of ``cli.train --fold_frozen``), K6 PS-RoIAlign on the unpadded float32 map, K7 padded PS-RoIAlign
     on float32 operands, K9 single stem stage, K10 (the NHWC stage, "vconcat"
     and "im2col" tap orders) at stages 0 and 2 and at block 8's shape (its
     streamed route), K13 (stochastic int8) on block 12's weight and on the
     (8, 128) carrier, each K10 and K13 case with its device time a call, and
     K13 on ragged, 70000-tile, zero, -0.0, inf and NaN inputs, K14 (the
     inference convolution's tail) at Darknet-53's shapes and, in its
     Mish mode, at CSPDarknet53's (YOLOv4 at 608 px) at batch 8; K15 (the
     float32 convolution) at both networks' main shapes at batch 8, within
     1e-5 of its plain version and at most twice its error against the
     float64 convolution, timed against ``F.conv2d`` (cuDNN float32); K15
     sums in its own order, so the paths below keep it launching in their
     plain runs (``keep=K15``), and after P22 it is held the same way to
     its plain version at every convolution they launched it at, and at
     Darknet-53's at 416 px and YOLOv4's at 608 px b8 (``ConvShapes``,
     ``KernelChecks.conv_paths``), and each of those launches that took a
     tail (and a shortcut's add) in its store is held bit-equal to K15,
     then K14, then the eager add (``KernelChecks.conv_tail``: the paths'
     own plain runs keep the fused store on both sides); K2, K3 (bf16
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
     bit-identical to the same path inside ``cuda_lib.plain_versions(keep=
     K15)``, or, for a path that runs a tensor-core kernel, bit-identical to
     the same path inside ``cuda_lib.plain_versions(keep=stem.
     TENSOR_CORE_KERNELS + K15)`` (every other kernel's plain version) and
     within ``PAIR_PATH_TOL`` of the plain path (K15 kept), or beyond it
     by NMS decisions alone, proven on the recorded inputs of both NMS
     passes (``nms_flips``); the window's answers (held the
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
  6. P17, weights in every format: the tracked checkpoint written with
     the port's writers into a temporary directory as the JAX package's
     ``.npz`` (its arrays byte-equal to the tracked file's), a darknet
     ``.weights`` of the backbone, a reference module3 ``.pth``, an
     ultralytics-style ``.pt`` (``{"model": nn.Module}``) of the backbone,
     a ``yolov3-tiny.conv.15`` file and a ``save_sharded`` directory (the
     JAX package's ``save_orbax``) written from the tree's CUDA tensors,
     its host ms and MB reported; each read on the host
     (``load_weights_any``, ``load_fusion`` for the ``.weights`` files,
     ``load_ultralytics_pt`` for the ``.pt`` by position too,
     ``load_sharded`` for the directory) to the tree written, the
     backbone-only files over the checkpoint's heads, the conv.15 file
     over ``FusionNetwork.init``'s (blocks 15-23 and heads
     kept), its host ms reported; each served at ``pallas_max_s01`` on
     P1's 8 requests with K4, K1, K2, K3 and K5 on every request, held to
     the plain versions as P1 and bit-identical to P1's answers (the
     conv.15 tree: its own); ``cli.demo.main`` on P15's recording read
     from disk (PNG frames, a camera_info YAML) with ``--weights`` the
     ``.pth``, then the ``.npz`` (every frame both live runs delivered
     bit-identical between the two), then with none (the seed-0 init),
     each to its end (frames delivered + dropped = 96) with the five
     kernels launched on every frame and finite answers;
  7. P18, the full YOLOv3 (Darknet-53, 80 classes, 416 px) from a ``.cfg``
     the script writes: ``parse_model_config`` back to ``yolov3_defs``, a
     stem preset refused, ``Darknet.init`` on the card equal to the CPU's
     moved there, the forward at batch 8 on the card with every image
     held to the CPU's forward (TF32 off) within ``YOLOV3_TOL``,
     ``batched_nms`` on the 8 x 10647 detections at ``pre_top_k=512``
     (one K1 launch, bit-identical to its plain version), device ms a
     forward at batch 1 and 8, and the full ``.weights`` file (62M
     floats) and a ``darknet53.conv.74`` cutoff file round-tripped leaf
     for leaf;
  8. P19, the evaluation path: ``cli.evaluate.main`` in this process on
     ``SyntheticScenes(64, seed=777)`` (H and L) at 416 px, batch 8, on
     the tracked checkpoint: ``--what fusion`` at ``f32``,
     ``pallas_max_s01``, ``pallas_max4`` and ``int8_acts`` (calibrated on
     the first 4 eval batches), ``pallas_max_s01`` with ``--device_cache``
     and at ``--model_mode 3``, ``--what yolo`` on P17's ``.weights`` file
     and ``--what refine`` on the ``.npz``; each run's launches counted
     per batch (the preset's kernels on every batch; the eval step has no
     post-merge NMS, so no K5), the run repeated inside
     ``cuda_lib.plain_versions(keep=K15)``: at ``f32``, ``int8_acts``, yolo and
     refine every batch bit-identical and the same mAP, at the tensor-core
     presets each image's rows within ``PAIR_PATH_TOL`` or beyond it by
     pre-merge NMS decisions alone (``eval_flips``), both mAPs printed;
     mAP, images/s and wall s per run; the device cache's batches equal to
     the host collate's after the float16 round trip; one profiled run
     (the device's busy share); ``--plot`` where matplotlib imports;
  9. P20, the export path: ``cli.export.main --verify`` on the card at
     ``pallas_max_s01`` b1, ``pallas_max4`` b8 and ``f32`` b1 (the
     artifact bit-identical to the live graph), each blob served by
     ``io/export.py:load_serving`` in a process of its own that imports no
     model code, on P1's letterboxed inputs: bit-identical to the live
     ``FusionNetwork.apply``, the preset's kernels launched once a call
     (K4, K1, K2, K3, and K9 at ``pallas_max4``; K1 at ``f32``), and
     inside ``plain_versions()`` no launch and the live graph's plain
     answer; blob MB, export s, load s, device ms a call of the artifact
     and of the live step; then a custom op's host cost against a direct
     launch of its kernel (K1 at P1's shape) beside P1's host ms;
 10. P21, the training path: ``cli.train.main`` in this process on
     ``SyntheticScenes(64, seed=777)`` at 416 px, batch 8, ``--grad_accum
     2``, one epoch (8 steps) for each stage: (a) stage 3 ``--fold_frozen``
     and (b) stage 3 unfolded from the tracked checkpoint, (c) stage 2 from
     its Darknet and score-map stack (seed-0 heads), (d) stage 1 from the
     seed-0 init; each step's launches read around it (K4 and K1 once in
     (a), K1 once in (b) and (c), none in (d), and nothing else); every
     metric finite but module3's category and regression terms, which its
     total leaves out, and no element reverted; the frozen leaves and the
     Darknet's BN statistics bit-identical after the run, the trained ones
     moved; steps/s after the first (host clock, synchronised), device ms
     and busy share of one profiled step, peak allocated memory. (a)'s
     frozen forward again inside ``plain_versions(keep=K15)`` (the rows within
     ``PAIR_PATH_TOL``, or beyond it by NMS decisions alone) and its first
     two steps (the loss within ``TRAIN_LOSS_RTOL``); (d)'s first step
     against the CPU's and against its float64 gradient
     (``YOLO_CPU_TOL``);
 11. P22, the live path: ``cli.realtime.main`` in this process on P15's
     recording and engine (``pallas_max_s01``), through its seams: the
     camera a capture of the 96 frames, the radar the recording's frames
     as TI demo-protocol packets behind a garbage prefix, read by the
     port's ``RadarReader`` in uneven chunks off a replayed data port
     that receives a frame's packet as the camera takes that frame, and a
     headless display that keeps each frame's record (``live_phase``):
     the native frame parser answering every packet, each frame's answer
     bit-identical to ``FusionEngine.infer`` on the points it consumed
     (replayed through a second ``RadarPipeline``), K4, K1, K2, K3 and K5
     once in every frame and nothing else, the radar thread stopped when
     ``main`` returns; host ms a frame, frames/s and, in a profiled run of
     24 frames, the device's busy share. Then ``cli.prepare_data.main``
     on the recording (its PNG frames and camera YAML from P17), its
     stems and radar pickles equal to an in-process ``RadarPipeline``'s
     (``prepare_data_check``);
 12. P23, ``parallel/``: four gloo ranks sharing the card (spawned by
     ``parallel/world.py``, each join with a time limit), each rank's
     launch counts read in the rank: (a) ``cli.evaluate.main --what
     fusion --data_parallel 4`` at ``f32`` and ``pallas_max_s01`` on
     P19's 64 scenes, 2 images a rank a batch, against P19's one-process
     runs: the f32 mAP within ``PAR_EVAL_MAP_TOL``, each image's rows
     within ``PAIR_PATH_TOL`` or beyond it by NMS decisions alone
     (``slice_flips``), K1 (and at ``pallas_max_s01`` K4, K2 and K3) once
     a batch on every rank and nothing else; (b) ``cli.train.main --stage
     fusion --fold_frozen --data_parallel 2 --model_parallel 2 --grad_accum
     1`` on 32 scenes (4 steps) from the tracked checkpoint against the
     same run in one process: K4 and K1 once a step on every rank, the
     frozen leaves unchanged on every rank, the replicated leaves
     bit-identical across ranks after every step, each step's loss and
     the final checkpoint within ``PAR_TRAIN_TOL``; then every rank writes
     the mesh's ``TrainState`` into one directory with ``save_sharded``
     (each slice of a leaf sharded over "model" written once, each
     rank's save s reported) and reports the digest of each of its
     tensors; here ``load_sharded`` reads it whole: its parameters and
     BN state bit-identical to the gathered ``.npz`` the CLI wrote, each
     rank's tensors to the loaded tree cut by ``parallel/mesh.py``'s
     shape rule, and a leaf sliced over "model" whose slices differ;
     (c) the ``pallas_max4`` engine window of P1's 8 frames, 2 a rank, each
     rank's bit-identical to ``batched_step_fn`` over its frames here, K9,
     K4, K1, K2, K3 and K5 once a rank; (d) ``entry.dryrun_multichip(4,
     device="cuda")``; then a ``parallel`` JSON line (meshes, launches a
     rank, wall s a part with the spawn, the largest deviations);
 13. a ``kernels`` JSON line, then the contract line
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
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
# K15, the float32 convolution, sums K in its own order (in two halves,
# or in split ranges), so a path held bit-identical to its plain run keeps
# K15 launching there (``keep=K15``); K15 itself is held within K15_TOL
# of its plain version's largest output at every convolution those paths
# launch it at (``ConvShapes``, ``KernelChecks.conv_paths``)
K15 = ("conv2d_nhwc",)
K15_TOL = 1e-5
# P18, Darknet-53 on the card against the CPU, float32 with TF32 off on
# both (summation order only): the feature map within 1e-3 of its largest
# magnitude, the detections (pixels and sigmoid scores) within 1e-3;
# float32 against float64 on the CPU at 160 px is 1.4e-6 of the feature
# map's magnitude and 6e-8 on the detections
YOLOV3_TOL = {"feature_map": lambda w: 1e-3 * float(w.abs().max()),
              "detections": lambda w: 1e-3}
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


class ConvShapes:
    """The distinct convolutions K15 launched at while ``start()``ed:
    each launch's (batch, H, W, Cin, Cout, kh, kw, stride, pad), as it
    asks ``ops/conv.py:plan`` for them, and in ``tails`` those of them
    that took a tail in the store, with its form: (dims, batch norm, the
    activation's code, a residual added), as the launch then hands it to
    ``ops/conv.py:_tail_ptrs`` (in this process only)."""

    def __init__(self, kconv):
        self.kconv, self.dims, self.tails = kconv, set(), set()
        self._saved = self._last = None

    def start(self):
        plan, ptrs = self._saved = self.kconv.plan, self.kconv._tail_ptrs

        def spy(dims, ld, forced=None):
            self._last = tuple(dims)
            self.dims.add(self._last)
            return plan(dims, ld, forced)

        def tail_spy(y, cout, bias, mean, inv, gamma, act, residual):
            # _launch plans its launch, then reads the tail's pointers
            self.tails.add((self._last, mean is not None, act,
                            residual is not None))
            return ptrs(y, cout, bias, mean, inv, gamma, act, residual)
        self.kconv.plan, self.kconv._tail_ptrs = spy, tail_spy

    def stop(self):
        self.kconv.plan, self.kconv._tail_ptrs = self._saved
        return sorted(self.dims)


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

    def stem_pair_f32(self, b, darknet_params):
        """K4 at "default" storing float32: the training forward of
        ``cli.train --fold_frozen`` (stage 2 is a hi-prec stage with no
        store type), on 416 px frames with the folded weights of the
        tracked checkpoint; held within ``stem.PAIR_DEFAULT_TOL`` of its
        plain version's largest output, timed and bounded as the K4 row;
        library: cuDNN bf16 twice."""
        from millieye_torch.ops import stem
        torch = self.torch
        w0, b0, w1, b1 = (darknet_params[i][k].float() for i in (0, 2)
                          for k in ("w", "b"))
        x = torch.tensor(self.rng.uniform(0, 1, (b, 416, 416, 3)),
                         dtype=torch.float32, device=self.dev)
        args = (x, w0, b0, w1, b1, "default", torch.float32)
        self.case(
            "stem_pair", "416 px 3->16->32 default float32 (training)", b,
            lambda: stem.fused_stem_pair(*args),
            lambda: stem.fused_stem_pair_plain(*args),
            x.numel() * 4 + b * 104 * 104 * 32 * 4
            + (w0.numel() + w1.numel()) * 2,
            2 * b * (416 * 416 * 16 * 27 + 208 * 208 * 32 * 144),
            BF16_FLOP_S, cudnn_stem(torch, x, [(w0, b0), (w1, b1)],
                                    torch.bfloat16),
            "cuDNN conv2d+bias+leaky+max_pool2d twice, bf16", BF16_TOL,
            tol=stem.PAIR_DEFAULT_TOL)

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

    # ------------------------------------------------------------- K14
    # ------------------------------------------------------------- K15
    def conv(self, b=8):
        """K15 at batch ``b`` at the main float32 convolutions of the two
        benchmarked configurations, a channels_last input as the runner
        gives it: Darknet-53 at 416 px (the 3-channel first convolution,
        then the 3x3 convolution at each side, 208 to 13 px) and
        CSPDarknet53 at 608 px (the first convolution, the 3x3 at each
        side 304 to 19 px), and the 19 px 255-channel head. Held within
        1e-5 of its plain version's largest output (K sums in another
        order) and, against the float64 convolution, at most twice the
        error of cuDNN's float32 convolution (TF32 off), which it replaced
        (the plain version's product, cuBLAS's, sums in yet another
        order). Bound: operations at the float32 peak. Library, timed,
        never called by the port: ``F.conv2d`` in float32."""
        from millieye_torch.ops import conv
        torch = self.torch
        F = torch.nn.functional
        g = torch.Generator(device=self.dev).manual_seed(15)
        cases = [("d53", 416, 3, 32, 3, 1), ("d53", 208, 32, 64, 3, 1),
                 ("d53", 104, 64, 128, 3, 1), ("d53", 52, 128, 256, 3, 1),
                 ("d53", 26, 256, 512, 3, 1), ("d53", 13, 512, 1024, 3, 1),
                 ("v4", 608, 3, 32, 3, 1), ("v4", 304, 32, 64, 3, 1),
                 ("v4", 152, 64, 64, 3, 1), ("v4", 76, 128, 128, 3, 1),
                 ("v4", 38, 256, 256, 3, 1), ("v4", 19, 512, 1024, 3, 1),
                 ("v4", 19, 1024, 255, 1, 1)]
        for net, hw, cin, cout, k, st in cases:
            x = torch.randn((b, hw, hw, cin), generator=g,
                            device=self.dev).permute(0, 3, 1, 2)
            w = torch.randn((cout, cin, k, k), generator=g,
                            device=self.dev) / (k * k * cin) ** 0.5
            wp, pad = conv.pack_weight(w), (k - 1) // 2
            ho = (hw + 2 * pad - k) // st + 1
            flops = 2 * b * ho * ho * cout * cin * k * k
            nbytes = 4 * (x.numel() + w.numel() + b * ho * ho * cout)
            ref = F.conv2d(x.double(), w.double(), stride=st, padding=pad)
            err64 = [float((f().double() - ref).abs().max()) for f in (
                lambda: conv.conv2d_nhwc(x, w, st, pad),
                lambda: F.conv2d(x, w, stride=st, padding=pad),
                lambda: conv._op.plain(x, wp, cout, st, pad))]
            del ref
            if not err64[0] <= 2 * err64[1]:
                raise AssertionError(
                    f"conv2d_nhwc {net} {hw} px {cin}->{cout} b{b}: off the "
                    f"float64 convolution by {err64[0]}, more than twice "
                    f"cuDNN float32's {err64[1]}")
            self.case(
                "conv2d_nhwc", f"{net} {hw} px {cin}->{cout} {k}x{k}", b,
                lambda x=x, w=w, st=st, pad=pad: conv.conv2d_nhwc(
                    x, w, st, pad),
                lambda x=x, wp=wp, cout=cout, st=st, pad=pad:
                conv._op.plain(x, wp, cout, st, pad),
                nbytes, flops, F32_FLOP_S,
                lambda x=x, w=w, st=st, pad=pad: F.conv2d(
                    x, w, stride=st, padding=pad),
                "F.conv2d float32, TF32 off (cuDNN)", K15_TOL, iters=20,
                tol=K15_TOL, device=True,
                note=f"against float64: K15 {err64[0]:.3g}, cuDNN float32 "
                     f"{err64[1]:.3g}, the plain product {err64[2]:.3g}")
            del x, w, wp

    def conv_tail(self, tails):
        """K15 with the tail in its store at each of ``tails``
        (``ConvShapes``'s: every launch the paths, and the Darknet-53 and
        YOLOv4 forwards, made with a tail, in its form: batch norm or the
        bias, leaky or linear, a shortcut's add or none), on seeded
        inputs: bit-equal to K15, then K14, then the eager add (the
        "plain" and the timed "library" call here: the launches the store
        replaces). The paths' own plain runs keep K15 launching
        (``keep=K15``), its store included, so this is where those
        launches are held to the unfused sequence. Bound: the larger of
        the operations at the float32 peak and the bytes (input, weights,
        output, the residual). Returns the labels."""
        from millieye_torch.ops import conv, epilogue
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(17)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=self.dev)

        def unfused(x, w, st, pad, vecs, act, res):
            y = epilogue.conv_epilogue(conv.conv2d_nhwc(x, w, st, pad), *vecs,
                                       act=act)
            return y if res is None else y + res

        labels = []
        for dims, bn, code, add in sorted(tails):
            n, h, w_, cin, cout, kh, kw, st, pad = dims
            act = epilogue.ACTS[code]
            x = randn(n, h, w_, cin).permute(0, 3, 1, 2)
            w = randn(cout, cin, kh, kw) / (kh * kw * cin) ** 0.5
            ho, wo = conv.out_size(h, kh, st, pad), conv.out_size(w_, kw, st,
                                                                 pad)
            vecs = [0.1 * randn(cout)]
            if bn:
                vecs += [0.1 * randn(cout),
                         torch.rsqrt(0.5 + torch.rand(cout, generator=g,
                                                      device=self.dev)),
                         1 + 0.1 * randn(cout)]
            res = randn(n, ho, wo, cout).permute(0, 3, 1, 2) if add else None
            flops = 2 * n * ho * wo * cout * cin * kh * kw
            nbytes = 4 * (x.numel() + w.numel()
                          + n * ho * wo * cout * (2 if add else 1))
            args = (x, w, st, pad, vecs, act, res)
            label = (f"tail {h}x{w_} px {cin}->{cout} {kh}x{kw} s{st} "
                     f"{'bn' if bn else 'bias'}+{act}"
                     + (" +add" if add else ""))
            self.case(
                "conv2d_nhwc", label, n,
                lambda a=args: conv.conv2d_nhwc(
                    *a[:4], *a[4], act=a[5], residual=a[6]),
                lambda a=args: unfused(*a), nbytes, flops, F32_FLOP_S,
                lambda a=args: unfused(*a), "K15, then K14, then the eager "
                "add (the launches the store replaces)", 0.0, iters=20,
                device=True)
            labels.append(f"{label} b{n}")
            del x, w, res, vecs, args
        torch.cuda.empty_cache()
        return labels

    def conv_paths(self, dims):
        """K15 at each convolution of ``dims`` (``ConvShapes``'s, as the
        paths launched it), on seeded inputs: within K15_TOL of its plain
        version's largest output, and against the float64 convolution at
        most twice as far off as cuDNN's float32 convolution (TF32 off).
        Not timed. Returns one (dims, error against the plain version as
        a share of its largest output, float64 errors of K15, cuDNN and
        the plain version) a convolution."""
        from millieye_torch.ops import conv
        torch = self.torch
        F = torch.nn.functional
        g = torch.Generator(device=self.dev).manual_seed(16)
        out = []
        for d in dims:
            n, h, w_, cin, cout, kh, kw, st, pad = d
            x = torch.randn((n, h, w_, cin), generator=g,
                            device=self.dev).permute(0, 3, 1, 2)
            w = torch.randn((cout, cin, kh, kw), generator=g,
                            device=self.dev) / (kh * kw * cin) ** 0.5
            got = conv.conv2d_nhwc(x, w, st, pad)
            want = conv._op.plain(x, conv.pack_weight(w), cout, st, pad)
            lib = F.conv2d(x, w, stride=st, padding=pad)
            ref = F.conv2d(x.double(), w.double(), stride=st, padding=pad)
            e64 = [float((t.double() - ref).abs().max())
                   for t in (got, lib, want)]
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if not (got.shape == want.shape and err <= K15_TOL * scale):
                raise AssertionError(f"conv2d_nhwc at {d}: off its plain "
                                     f"version by {err}, beyond {K15_TOL} "
                                     f"of its largest output {scale}")
            if not e64[0] <= 2 * e64[1]:
                raise AssertionError(f"conv2d_nhwc at {d}: off the float64 "
                                     f"convolution by {e64[0]}, more than "
                                     f"twice cuDNN float32's {e64[1]}")
            out.append((d, err / scale, *e64))
            del x, w, got, want, lib, ref
        torch.cuda.empty_cache()
        return out

    def epilogue(self, b=8):
        """K14 at batch ``b`` on a channels_last convolution output as
        cuDNN gives it: at Darknet-53's shapes at 416 px, 208 px x 64,
        52 px x 256 and 13 px x 1024 in the batch-norm form with leaky,
        and the 13 px 255-channel head in the bias form, linear; at
        CSPDarknet53's shapes at 608 px (YOLOv4), 608 px x 32, 304 px x
        64, 152 px x 128 and 19 px x 1024 in the batch-norm form with
        Mish; bit-equal to the plain version (the eager sequence), with
        its device time a call. Bound: bytes, each element read and
        written once (8 bytes in float32) and the vectors. Library, timed,
        never called by the port: ``F.batch_norm`` (eval) then
        ``F.leaky_relu`` or ``F.mish`` in float32 for the batch-norm form,
        ``torch.add`` of the bias for the bias form."""
        from millieye_torch.ops import epilogue
        torch = self.torch
        F = torch.nn.functional
        g = torch.Generator(device=self.dev).manual_seed(14)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device=self.dev)

        # operations an element, each library function counted as one:
        # the batch norm's four, then leaky's compare and product, or
        # Mish's exp, log1p, tanh and product
        ops = {"leaky": 6, "mish": 8, "linear": 1}
        for c, hw, act in ((64, 208, "leaky"), (256, 52, "leaky"),
                           (1024, 13, "leaky"), (255, 13, "linear"),
                           (32, 608, "mish"), (64, 304, "mish"),
                           (128, 152, "mish"), (1024, 19, "mish")):
            x = (3 * randn(b, c, hw, hw)).contiguous(
                memory_format=torch.channels_last)
            beta = 0.1 * randn(c)
            vecs = (beta, None, None, None)

            def lib(x=x, beta=beta):
                return torch.add(x, beta[:, None, None])
            lib_name = "torch.add of the bias, float32"
            if act != "linear":
                mean, gamma = 0.1 * randn(c), 1 + 0.1 * randn(c)
                var = 0.5 + 1.5 * torch.rand(c, generator=g, device=self.dev)
                vecs = (beta, mean, torch.rsqrt(var + 1e-5), gamma)
                fn = {"leaky": lambda t: F.leaky_relu(t, 0.1),
                      "mish": F.mish}[act]

                def lib(x=x, mean=mean, var=var, gamma=gamma, beta=beta,
                        fn=fn):
                    return fn(F.batch_norm(x, mean, var, gamma, beta, False,
                                           0.0, 1e-5))
                lib_name = (f"F.batch_norm (eval) + "
                            f"F.{'leaky_relu' if act == 'leaky' else act}, "
                            f"float32")
            n_vec = sum(v is not None for v in vecs)
            self.case(
                "conv_epilogue", f"{hw} px x {c}, " + (
                    "bias, linear" if act == "linear"
                    else f"batch norm + {act}"), b,
                lambda x=x, vecs=vecs, act=act: epilogue.conv_epilogue(
                    x, *vecs, act),
                lambda x=x, vecs=vecs, act=act: epilogue.epilogue_eager(
                    x, *vecs, act),
                2 * x.numel() * 4 + n_vec * c * 4,
                ops[act] * x.numel(), F32_FLOP_S, lib, lib_name, 1e-5,
                iters=50, device=True)


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
    with cuda_lib.plain_versions(keep=K15):
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
            with cuda_lib.plain_versions(keep=K15):
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
            want_in, cuda_lib.plain_versions(keep=K15):
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
                cuda_lib.plain_versions(keep=K15):
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


# phases P17 and P18: the weights in every format, written from the
# tracked checkpoint with the port's own writers; the reference's formats
# have no writer in either package, so the two below stand in for the
# reference's own ``torch.save``
def write_cfg(blocks, path):
    """A darknet ``.cfg`` of ``blocks`` (models/zoo.py's dicts): one
    ``[type]`` section a block, its other keys as ``key=value`` lines."""
    with open(path, "w") as f:
        for block in blocks:
            f.write(f"[{block['type']}]\n")
            f.writelines(f"{k}={v}\n" for k, v in block.items()
                         if k != "type")
            f.write("\n")


def module3_state_dict(torch, model, params, state):
    """The reference module3 ``Network.state_dict()`` of a port
    ``FusionNetwork`` tree: the keys that
    ``io/torch_ckpt.py:fill_fusion_network`` reads, in the reference's
    module order, each BN with the ``num_batches_tracked`` the fills skip;
    conv weights OIHW, linear weights [out, in]."""
    sd = {}

    def conv(key, p):
        sd[f"{key}.weight"] = p["w"]
        sd[f"{key}.bias"] = p["b"]

    def bn(key, p, s):
        sd.update({f"{key}.weight": p["gamma"], f"{key}.bias": p["beta"],
                   f"{key}.running_mean": s["mean"],
                   f"{key}.running_var": s["var"],
                   f"{key}.num_batches_tracked": torch.tensor(0)})

    def linear(key, p):
        sd[f"{key}.weight"] = p["w"].t()
        sd[f"{key}.bias"] = p["b"]

    for i, info in enumerate(model.darknet._plan):
        if info["type"] != "convolutional":
            continue
        p, base = params["darknet"][i], f"base_detector.module_list.{i}"
        if info["bn"]:
            sd[f"{base}.conv_{i}.weight"] = p["w"]
            bn(f"{base}.batch_norm_{i}", p, state["darknet"][i])
        else:
            conv(f"{base}.conv_{i}", p)
    for i, (p, s) in enumerate(zip(params["img_cnn"], state["img_cnn"])):
        conv(f"img_cnn_layers.net.conv_{i}", p)
        bn(f"img_cnn_layers.net.batch_norm_{i}", p["bn"], s)
    enc, enc_s = params["radar_enc"], state["radar_enc"]
    for i, name in enumerate(("conv1", "conv2", "conv3")):
        conv(f"radar_cnn_layers.{name}.0", enc[i])
        bn(f"radar_cnn_layers.{name}.1", enc[i]["bn"], enc_s[i])
    conv("radar_cnn_layers.conv3.3", enc[3])
    ref = params["refine"]
    for net in ("net0", "net1", "net2"):
        linear(f"refinement_head.{net}.0", ref[net])
    rn = ref["radar_net"]
    conv("refinement_head.radar_net.0", rn["conv7"])
    bn("refinement_head.radar_net.1", rn["bn"], state["refine"]["radar_net"])
    conv("refinement_head.radar_net.3", rn["conv1"])
    for fc in ("fc1", "fc2"):
        linear(f"ensemble_head.{fc}.0", params["ensemble"][fc])
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def darknet_module(torch, darknet, params, state):
    """An ultralytics-style ``nn.Module`` of a Darknet tree:
    ``module_list`` of Sequential(conv_{i}[, batch_norm_{i}]), so its
    ``state_dict`` holds, block by block, the conv weight, then the conv
    bias or the BN weight, bias, running mean, running var and
    ``num_batches_tracked`` (the order a positional load reads)."""
    nn = torch.nn
    blocks = nn.ModuleList()
    for i, info in enumerate(darknet._plan):
        seq = nn.Sequential()
        if info["type"] == "convolutional":
            p, k = params[i], info["size"]
            cv = nn.utils.skip_init(nn.Conv2d, info["in_ch"],
                                    info["filters"], k, info["stride"],
                                    (k - 1) // 2, bias=not info["bn"])
            seq.add_module(f"conv_{i}", cv)
            with torch.no_grad():
                cv.weight.copy_(p["w"])
                if info["bn"]:
                    b = nn.BatchNorm2d(info["filters"])
                    b.weight.copy_(p["gamma"])
                    b.bias.copy_(p["beta"])
                    b.running_mean.copy_(state[i]["mean"])
                    b.running_var.copy_(state[i]["var"])
                    seq.add_module(f"batch_norm_{i}", b)
                else:
                    cv.bias.copy_(p["b"])
        blocks.append(seq)
    holder = nn.Module()
    holder.module_list = blocks
    return holder


def write_weight_files(torch, root, model, params, state):
    """A FusionNetwork's CPU tree in every format the loaders read: the
    JAX package's ``.npz``, a darknet ``.weights`` of the backbone, a
    module3 ``.pth`` state dict, an ultralytics-style ``.pt``
    (``{"model": nn.Module}``) of the backbone, and a
    ``yolov3-tiny.conv.15`` file of its first 15 blocks. Returns
    {format: path}."""
    import os
    from millieye_torch.io.checkpoint import save_checkpoint
    from millieye_torch.io.darknet_weights import save_darknet_weights
    dn, dp, ds = model.darknet, params["darknet"], state["darknet"]
    files = {f: os.path.join(root, name) for f, name in (
        ("npz", "fusion.npz"), ("weights", "fusion.weights"),
        ("pth", "module3.pth"), ("pt", "darknet.pt"),
        ("tiny15", "yolov3-tiny.conv.15"))}
    save_checkpoint(files["npz"], {"params": params, "state": state})
    save_darknet_weights(dn, dp, ds, files["weights"])
    torch.save(module3_state_dict(torch, model, params, state), files["pth"])
    torch.save({"model": darknet_module(torch, dn, dp, ds), "epoch": -1},
               files["pt"])
    save_darknet_weights(dn, dp, ds, files["tiny15"], cutoff=15)
    return files


def path_bytes(path):
    """The bytes of a file, or of every file under a directory."""
    import os
    if not os.path.isdir(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(path) for f in names)


def same_tree(torch, a, b):
    """Two trees with the same key paths and bit-equal leaves."""
    from millieye_torch.io.checkpoint import leaf_items
    la, lb = leaf_items(a), leaf_items(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for (_, x), (_, y) in zip(la, lb))


def write_demo_inputs(rec, frames):
    """The recorded session's frames as ``frames/*.png`` (lossless) and
    its pinhole camera (``STREAM_CALIB``) as a camera_info YAML, so
    ``cli.demo`` can read the recording from disk. Returns the YAML's
    path."""
    import os
    from PIL import Image
    os.makedirs(os.path.join(rec, "frames"), exist_ok=True)
    for i, f in frames:
        Image.fromarray(f).save(os.path.join(rec, "frames", f"{i:06d}.png"))
    fx, cx, fy, cy = STREAM_CALIB[:4]
    path = os.path.join(rec, "calib.yaml")
    with open(path, "w") as f:
        f.write(f"camera_matrix: {{data: [{fx}, 0.0, {cx}, 0.0, {fy}, {cy}, "
                f"0.0, 0.0, 1.0]}}\n"
                f"distortion_coefficients: {{data: "
                f"{[float(v) for v in STREAM_CALIB[4:9]]}}}\n")
    return path


def yolov3_phase(torch, cuda_lib, root, size=416, batch=8):
    """P18: the full YOLOv3 (Darknet-53, 80 classes) at ``size`` px from a
    ``.cfg`` written under ``root``: parsed back to ``yolov3_defs``, a stem
    preset refused, ``Darknet.init`` on the card equal to the CPU's moved
    there, the forward of ``batch`` images on the card with every image
    held to the CPU's forward within ``YOLOV3_TOL``, ``batched_nms`` at
    ``pre_top_k=512`` (one K1 launch, bit-identical to its plain
    version), device ms a forward at batch 1 and ``batch``, and the full
    ``.weights`` and a ``darknet53.conv.74`` file round-tripped leaf for
    leaf. Returns (summary, the stem preset's refusal, the tolerances)."""
    import os
    from millieye_torch.io.checkpoint import leaf_items
    from millieye_torch.io.config import parse_model_config
    from millieye_torch.io.darknet_weights import (load_darknet_weights,
                                                   save_darknet_weights)
    from millieye_torch.models.darknet import Darknet
    from millieye_torch.models.zoo import yolov3_defs
    from millieye_torch.ops import nms_kernel
    from millieye_torch.ops.nms import batched_nms
    cfg_path = os.path.join(root, "yolov3.cfg")
    defs = yolov3_defs(num_classes=80, img_size=size)
    write_cfg(defs, cfg_path)
    if parse_model_config(cfg_path) != defs:
        raise AssertionError("yolov3: the .cfg parses to other blocks")
    try:
        Darknet(cfg_path, stem_stages=(0, 2))
    except ValueError as e:
        stem_refusal = str(e)
    else:
        raise AssertionError("yolov3: a stem preset on Darknet-53 built")
    dn = Darknet(cfg_path, img_size=size, feature_tap=36)
    p53, s53 = dn.init(torch.Generator().manual_seed(0))
    p53_card, s53_card = dn.init(torch.Generator().manual_seed(0),
                                 device="cuda")
    if not same_tree(torch, (p53_card, s53_card), (p53, s53)):
        raise AssertionError("yolov3: Darknet.init on the card differs "
                             "from the same init on the CPU")
    x53 = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (batch, size, size, 3)).astype(np.float32))
    x53_card = x53.cuda()
    with torch.no_grad():
        t0 = time.perf_counter()
        want = dn.apply(p53, s53, x53, collect_outputs=True)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = dn.apply(p53_card, s53_card, x53_card)
    errs, limits = {}, {}
    for key, tol in YOLOV3_TOL.items():
        g, w = got[key].cpu(), want[key]
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"yolov3 {key}: {tuple(g.shape)}, want "
                                 f"{tuple(w.shape)}, or not finite")
        errs[key], limits[key] = float((g - w).abs().max()), tol(w)
        if errs[key] > limits[key]:
            raise AssertionError(f"yolov3 {key}: the card is off the CPU "
                                 f"by {errs[key]:.3g}, above "
                                 f"{limits[key]:.3g}")
    det53 = got["detections"]
    before = nms_kernel.nms_keep_mask_blocked.launches
    kd, kv = batched_nms(det53, 0.3, 0.5, max_det=100, pre_top_k=512)
    k1 = nms_kernel.nms_keep_mask_blocked.launches - before
    with cuda_lib.plain_versions(keep=K15):
        pd, pv = batched_nms(det53, 0.3, 0.5, max_det=100, pre_top_k=512)
    if k1 != 1 or not (torch.equal(kd, pd) and torch.equal(kv, pv)):
        raise AssertionError(f"yolov3: K1 launched {k1} times, or its "
                             f"detections differ from its plain version's")
    ms53 = {f"b{b}": device_ms(torch, lambda b=b: dn.apply(
        p53_card, s53_card, x53_card[:b]), calls=5) for b in (1, batch)}
    # the bound of a forward: each convolution's multiply-adds (2 flops)
    # at its output's size, float32 outside the tensor cores; bytes: the
    # weights and statistics, the images, the detections and feature map
    flops = sum(2 * info["size"] ** 2 * info["in_ch"] * info["filters"]
                * out.shape[2] * out.shape[3]
                for info, out in zip(dn._plan, want["outputs"])
                if info["type"] == "convolutional")
    n_params = sum(v.numel() for _, v in leaf_items((p53, s53)))
    per_image = 4 * (x53[0].numel() + want["detections"][0].numel()
                     + want["feature_map"][0].numel())
    bound53 = {f"b{b}": bound_ms(4 * n_params + b * per_image, b * flops,
                                 F32_FLOP_S) for b in (1, batch)}
    full = os.path.join(root, "yolov3.weights")
    header = np.array([0, 2, 0, 32013, 0], np.int32)
    save_darknet_weights(dn, p53, s53, full, header=header)
    tp, ts = dn.init(torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    lp, ls, hdr = load_darknet_weights(dn, tp, ts, full)
    load_ms = (time.perf_counter() - t0) * 1e3
    cut = os.path.join(root, "darknet53.conv.74")
    save_darknet_weights(dn, p53, s53, cut, cutoff=75)
    cp, cs, _ = load_darknet_weights(dn, tp, ts, cut)
    if not (same_tree(torch, (lp, ls), (p53, s53))
            and np.array_equal(hdr, header)
            and same_tree(torch, (cp, cs), (p53[:75] + tp[75:],
                                            s53[:75] + ts[75:]))):
        raise AssertionError("yolov3: a .weights round trip differs")
    return ({"blocks": len(dn.block_defs),
             "weights": n_params,
             "max_err_vs_cpu": errs, "device_ms": ms53,
             "bound_ms": bound53, "flops_per_image": flops,
             f"cpu_b{batch}_ms": cpu_ms,
             "weights_floats": (os.path.getsize(full) - 20) // 4,
             "weights_load_host_ms": load_ms,
             "nms_rows_kept_b8": int(kv.sum())}, stem_refusal, limits)


# phases P19 and P20: the evaluation path (cli.evaluate) and the export
# path (cli.export, io/export.py's artifact in a process of its own)
EVAL_SCENES = 64               # SyntheticScenes(64, seed=777), H and L
EVAL_BATCH = 8
# the runs' common arguments, first: a run's own --weights comes later
EVAL_ARGS = ["--weights", CKPT, "--synthetic", str(EVAL_SCENES),
             "--illumination", "H", "L", "--batch_size", str(EVAL_BATCH)]
_RIGHT_PAIR = ("stem_pair", "nms", "ps_roi_align", "roi_align")


def eval_runs(weights_file):
    """(label, argv, launches a batch, held): ``held`` "exact" for a run
    whose kernels are bit-equal to their plain versions, "tensor-core"
    for one that runs the stem pair or K9 at "default"."""
    one = dict.fromkeys
    return (
        ("fusion@f32", ["--what", "fusion", "--serving", "f32"],
         {"nms": 1}, "exact"),
        ("fusion@pallas_max_s01", ["--what", "fusion", "--serving",
                                   "pallas_max_s01"], one(_RIGHT_PAIR, 1),
         "tensor-core"),
        ("fusion@pallas_max4", ["--what", "fusion", "--serving",
                                "pallas_max4"],
         one(_RIGHT_PAIR + ("stem_stage",), 1), "tensor-core"),
        ("fusion@int8_acts", ["--what", "fusion", "--serving", "int8_acts"],
         {"nms": 1}, "exact"),
        ("fusion@pallas_max_s01+device_cache",
         ["--what", "fusion", "--serving", "pallas_max_s01",
          "--device_cache"], one(_RIGHT_PAIR, 1), "tensor-core"),
        ("fusion@pallas_max_s01+mode3",
         ["--what", "fusion", "--serving", "pallas_max_s01",
          "--model_mode", "3"], one(("stem_pair", "nms"), 1), "tensor-core"),
        ("yolo@weights", ["--what", "yolo", "--weights", weights_file],
         {"nms": 1}, "exact"),
        ("refine@npz", ["--what", "refine"], {"nms": 1}, "exact"),
    )


@contextlib.contextmanager
def eval_records(harness):
    """Record each batch of a harness run: its forward, its device batch,
    its answer (rows [B, K, 7], valid [B, K]) and, for the fusion
    harness at mode 3, the mode ``auto_mode`` chose."""
    seen, modes = [], []
    real_eval, real_auto = harness._evaluate, harness.auto_mode

    def evaluate(batches, forward, iou_thresh, mesh=None):
        def rec(batch):
            out = forward(batch)
            seen.append({"forward": forward, "batch": batch, "out": out})
            return out
        return real_eval(batches, rec, iou_thresh, mesh)

    def auto(images, brightness=None):
        modes.append(real_auto(images, brightness))
        return modes[-1]

    harness._evaluate, harness.auto_mode = evaluate, auto
    try:
        yield seen, modes
    finally:
        harness._evaluate, harness.auto_mode = real_eval, real_auto


def _np_out(out):
    return tuple(a.cpu().numpy() for a in out)


def eval_flips(torch, cuda_lib, rec, tol):
    """One batch of a tensor-core run whose rows differ from its fully
    plain run beyond ``tol``: prove that NMS decisions alone make the
    difference (the eval step has only the pre-merge NMS). Both runs
    again with the pre-merge NMS recorded; the kernel run must repeat its
    answer, each run's NMS must be the plain NMS of its own detections
    (``pre_merge_is_nms``) and have kept other anchors, and each run
    under the other's decisions (``pre_merge_nms(inject=)``) must meet
    the other's answer within ``tol``, image by image. Returns the
    anchors kept by one run only; raises AssertionError otherwise."""
    forward, batch = rec["forward"], rec["batch"]
    with torch.inference_mode():
        with pre_merge_nms(torch) as got_nms:
            got = _np_out(forward(batch))
        with pre_merge_nms(torch) as want_nms, \
                cuda_lib.plain_versions(keep=K15):
            want = _np_out(forward(batch))
        if not all(np.array_equal(a, b) for a, b in zip(got,
                                                        _np_out(rec["out"]))):
            raise AssertionError("an eval batch did not repeat its answer")
        anchors = pre_merge_is_nms(torch, cuda_lib, got_nms, want_nms)
        if not anchors:
            raise AssertionError("an eval batch differs beyond its bound "
                                 "with the same NMS decisions")
        with pre_merge_nms(torch, inject=want_nms):
            got2 = _np_out(forward(batch))
        with pre_merge_nms(torch, inject=got_nms), \
                cuda_lib.plain_versions(keep=K15):
            want2 = _np_out(forward(batch))
    for a, b in ((got2, want), (got, want2)):
        for i in range(len(a[0])):
            ok, db, ds, fl = rows_match((a[0][i], a[1][i]),
                                        (b[0][i], b[1][i]), tol)
            if not ok:
                raise AssertionError(
                    f"an eval batch under the other run's NMS decisions "
                    f"differs beyond {tol} (image {i}: box {db}, score {ds},"
                    f" {fl} rows on one side only)")
    return anchors


def eval_phase(torch, cuda_lib, weights_file, zero_counts, counts,
               keep=None):
    """P19: ``cli.evaluate.main`` in this process on the card, each run of
    ``eval_runs`` with its launches counted, again inside
    ``plain_versions(keep=K15)``, and held to it; the device cache's batches
    against the host collate's; one profiled run. Returns (summary,
    {label: launches}); ``keep`` (a dict) gets (mAP, records) of each
    run its keys name, for P23."""
    import io
    from millieye_torch.cli import evaluate
    from millieye_torch.data.device_cache import DeviceCache
    from millieye_torch.data.loader import DataLoader, PaddedCollate
    from millieye_torch.data.synthetic import SyntheticScenes
    from millieye_torch.eval import harness

    def run(argv):
        with contextlib.redirect_stdout(io.StringIO()), \
                eval_records(harness) as (seen, modes):
            t0 = time.perf_counter()
            m_ap = evaluate.main(EVAL_ARGS + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return m_ap, wall, seen, modes

    summary, launches_by_run = {}, {}
    for label, argv, per_batch, held in eval_runs(weights_file):
        zero_counts()
        m_ap, wall, seen, modes = run(argv)
        launches = counts()
        launches_by_run[label] = launches
        n_b = len(seen)
        need = {k: v * n_b for k, v in per_batch.items()}
        if modes:       # mode 3: the RoI kernels on the batches at mode 0
            need.update(dict.fromkeys(("ps_roi_align", "roi_align"),
                                      modes.count(0)))
        short = {k: launches[k] for k, v in need.items() if launches[k] < v}
        if n_b != EVAL_SCENES // EVAL_BATCH or short:
            raise AssertionError(f"eval {label}: {n_b} batches; kernels "
                                 f"launched too few times: {short} (need "
                                 f"{need})")
        if keep is not None and label in keep:
            keep[label] = (m_ap, seen)
        with cuda_lib.plain_versions(keep=K15):
            m_plain, wall_plain, pseen, _ = run(argv)
        got = [_np_out(r["out"]) for r in seen]
        want = [_np_out(r["out"]) for r in pseen]
        for g, w in zip(got, want):
            if g[0].shape != (EVAL_BATCH,) + g[0].shape[1:] or \
                    not np.isfinite(g[0]).all():
                raise AssertionError(f"eval {label}: bad rows {g[0].shape}")
        same = sum(all(np.array_equal(a, b) for a, b in zip(g, w))
                   for g, w in zip(got, want))
        d_box = d_score = 0.0
        flips = anchors = 0
        if held == "exact":
            if same != n_b or m_ap != m_plain:
                raise AssertionError(
                    f"eval {label}: kernels and plain versions disagree "
                    f"({same} of {n_b} batches bit-identical, mAP {m_ap} "
                    f"against {m_plain})")
        else:
            for rec, g, w in zip(seen, got, want):
                beyond = False
                for i in range(len(g[0])):
                    ok, db, ds, fl = rows_match((g[0][i], g[1][i]),
                                                (w[0][i], w[1][i]),
                                                PAIR_PATH_TOL)
                    d_box, d_score = max(d_box, db), max(d_score, ds)
                    flips += fl
                    beyond |= not ok
                if beyond:
                    try:
                        anchors += eval_flips(torch, cuda_lib, rec,
                                              PAIR_PATH_TOL)
                    except AssertionError as e:
                        raise AssertionError(f"eval {label}: {e}") from None
        used = {k: v for k, v in launches.items() if v}
        summary[label] = {
            "mAP": m_ap, "plain_mAP": m_plain, "batches": n_b,
            "images": EVAL_SCENES, "wall_s": wall,
            "images_per_s": EVAL_SCENES / wall, "plain_wall_s": wall_plain,
            "launches": used, "batches_bit_identical_to_plain": same,
            "against_plain": {"max_box_diff": d_box,
                              "max_score_diff": d_score,
                              "rows_on_one_side": flips,
                              "nms_anchors_on_one_side": anchors},
            "modes": modes or None}
        log(f"eval {label}: mAP {m_ap:.6f} (plain versions {m_plain:.6f}); "
            f"{EVAL_SCENES} images in {wall:.2f} s, "
            f"{EVAL_SCENES / wall:.1f} images/s (host clock: the call to "
            f"cli.evaluate.main, the build, the data and the calibration "
            f"included); launches {used} over {n_b} batches"
            + (f", modes chosen {modes}" if modes else "") + "; "
            + ("every batch bit-identical to the plain versions' run"
               if held == "exact" else
               f"{same} of {n_b} batches bit-identical to the plain "
               f"versions' run, the rest within PAIR_PATH_TOL (box "
               f"{d_box:.3g} px, score {d_score:.3g}, {flips} rows on one "
               f"side only) or beyond it by NMS decisions alone "
               f"({anchors} anchors kept by one run only)"))

    # the device cache's batches against the host collate's
    ds = SyntheticScenes(EVAL_SCENES, seed=777, illumination=("H", "L"))
    coll = dict(max_targets=64, max_radar=32, max_points=256)
    t0 = time.perf_counter()
    cache = DeviceCache.build(ds, PaddedCollate(416, **coll), device="cuda")
    build_s = time.perf_counter() - t0
    n_cached = 0
    host_loader = DataLoader(ds, EVAL_BATCH, PaddedCollate(416, **coll))
    for got, host in zip(cache.loader(EVAL_BATCH), host_loader):
        want = host["images"].astype(np.float16).astype(np.float32)
        if not (got["images"].dtype == torch.float32 and np.array_equal(
                got["images"].cpu().numpy(), want)):
            raise AssertionError("device cache: images differ from the host "
                                 "collate's after the float16 round trip")
        for k in ("targets", "tmask", "radar_boxes", "rmask",
                  "radar_points", "pmask"):
            if not np.array_equal(got[k].cpu().numpy(), host[k]):
                raise AssertionError(f"device cache: {k} differs from the "
                                     f"host collate's")
        n_cached += 1
    mb = sum(t.numel() * t.element_size()
             for t in cache.arrays.values()) / 1e6
    log(f"eval device cache: {n_cached} batches equal to the host "
        f"collate's (images after the float16 round trip); {mb:.1f} MB on "
        f"the card, built in {build_s:.2f} s")
    summary["device_cache"] = {"batches_equal": n_cached, "mb": mb,
                               "build_s": build_s}
    argv = eval_runs(weights_file)[1][1]
    summary["profile@pallas_max_s01"] = profile_calls(
        torch, "eval fusion@pallas_max_s01 (one cli.evaluate.main call)",
        [lambda: run(argv)])
    try:
        import matplotlib  # noqa: F401
        plot = True
    except ImportError:
        plot = False
    if plot:
        import os
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "pr.png")
            with contextlib.redirect_stdout(io.StringIO()):
                evaluate.main(EVAL_ARGS + argv + ["--plot", path])
            if not os.path.getsize(path):
                raise AssertionError("eval --plot wrote an empty file")
    log("eval --plot: " + ("a PR curve written" if plot else
                           "matplotlib does not import here: not run"))
    summary["plot"] = plot
    return summary, launches_by_run


TRAIN_SCENES = 64             # SyntheticScenes(64, seed=777), as P19
TRAIN_BATCH = 8
TRAIN_SIZE = 416
TRAIN_LR = 5e-4
# the kernels each P21 run must launch on every step, and nothing else.
# K15 (conv2d_nhwc) runs each float32 plain convolution of the frozen
# forward (eval mode under no_grad): all 13 of tiny-YOLO's in float32
# (stage 3 unfolded, stage 2), each with its leaky or linear tail in its
# store, so K14 runs none of them; with --fold_frozen (bfloat16) stage
# 4's alone, and K14 (conv_epilogue) the tails of the 11 the stem pair
# leaves (stage 4 in float32; the others bfloat16 with a float32 bias,
# written float32 as the eager sequence widens them). Stage 1 trains the
# Darknet itself (train mode): none.
TRAIN_EXPECT = {"fusion_fold": {"stem_pair": 1, "nms": 1,
                                "conv_epilogue": 11, "conv2d_nhwc": 1},
                "fusion": {"nms": 1, "conv2d_nhwc": 13},
                "refine": {"nms": 1, "conv2d_nhwc": 13}, "yolo": {}}
# module3's total leaves out its category and regression terms; they are
# reported, and the category BCE is NaN wherever a class score saturates
# to 1.0 in float32 (its clip, 1 - 1e-12, rounds to 1.0): so in the JAX
# package too. Every other metric must be finite.
TRAIN_OUTSIDE_TOTAL = {"fusion_fold": ("category_loss", "loss_xy",
                                       "loss_wh"),
                       "fusion": ("category_loss", "loss_xy", "loss_wh")}
# (a) against its plain versions: the frozen forward moves by the tensor
# cores' bf16 roundings (the pair within 2^-6), so the loss within 2e-2
# relative, as the CPU tests hold the fold step to the unfolded one
TRAIN_LOSS_RTOL = 2e-2
# (d) stage 1 on the card (TF32 off) against the CPU, both float32: the
# loss within 1e-4 relative; the gradient held to the same gradient in
# float64 on the CPU, the card's largest error over every leaf at most 4
# times the CPU float32 step's. (Each float32 gradient is off the float64
# one by up to ~2e-3 of the tree's largest: train-mode BN sums N*H*W =
# 1.4M terms a channel at 416 px b8, and its backward cancels them; the
# two devices sum in other orders, so leaf by leaf they differ by that.)
YOLO_CPU_TOL = dict(loss=1e-4, f64=4.0)


@contextlib.contextmanager
def step_probe(torch, recipes, counts):
    """Every ``Trainer`` made inside: each step synchronised before and
    after and timed on the host clock, its metrics and its launches (the
    counts read around it) kept, and its first batch and its unwrapped
    step function."""
    rec = {"s": [], "metrics": [], "launches": [], "batch": None,
           "step_fn": None}
    orig = recipes.Trainer.__init__

    def init(self, step_fn, *a, **kw):
        def timed(ts, batch, draw):
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            ts, m = step_fn(ts, batch, draw)
            torch.cuda.synchronize()
            rec["s"].append(time.perf_counter() - t0)
            c1 = counts()
            rec["launches"].append({k: c1[k] - c0[k] for k in c1})
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            if rec["batch"] is None:
                rec["batch"] = batch
            return ts, m

        orig(self, timed, *a, **kw)
        rec["step_fn"] = step_fn

    recipes.Trainer.__init__ = init
    try:
        yield rec
    finally:
        recipes.Trainer.__init__ = orig


def _leaves_moved(torch, got, start):
    from millieye_torch.train.optim import tree_leaves
    return any(not torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(start)))


def _frozen_identical(torch, params, start, frozen):
    from millieye_torch.train.optim import label_tree, tree_leaves
    for lab, a, b in zip(tree_leaves(label_tree(params, frozen)),
                         tree_leaves(params), tree_leaves(start)):
        if lab == "freeze" and not torch.equal(a, b):
            return False
    return True


def fold_forward_vs_plain(torch, cuda_lib, model, params, state, images,
                          zero_counts, counts):
    """(a)'s frozen forward, the folded Darknet and its NMS, as the fold
    step runs it: K4 and K1 once, K14 on its 11 tails; bit-identical to
    the run with every kernel but the tensor-core ones plain; against the
    fully plain run each image's rows within ``PAIR_PATH_TOL``, or beyond
    it by NMS decisions alone (each run's NMS the plain NMS of its
    detections, and the kernel run's detections under the plain run's
    decisions within the bound). Returns (largest box difference, largest score
    difference, anchors kept in one run only)."""
    from millieye_torch.models import fusion
    from millieye_torch.ops import stem
    with torch.no_grad():
        fp, fs = model.darknet.fold_batchnorm(params["darknet"],
                                              state["darknet"])
    p, s = dict(params, darknet=fp), dict(state, darknet=fs)

    def fwd():
        det, valid, _ = fusion._frozen_forward(model, p, s, images, True)
        return det[..., :7].cpu().numpy(), valid.cpu().numpy()

    zero_counts()
    got = fwd()
    c = counts()
    if {k: v for k, v in c.items() if v} != TRAIN_EXPECT["fusion_fold"]:
        raise AssertionError(f"P21 frozen forward launched {c}")
    with cuda_lib.plain_versions(keep=stem.TENSOR_CORE_KERNELS + K15):
        keep = fwd()
    if not same_answer(got, keep):
        raise AssertionError("P21 frozen forward: not bit-identical to its "
                             "run with only the tensor-core kernels")
    with cuda_lib.plain_versions(keep=K15):
        want = fwd()
    rows = [rows_match((got[0][i], got[1][i]), (want[0][i], want[1][i]),
                       PAIR_PATH_TOL) for i in range(len(got[1]))]
    anchors = 0
    if not all(r[0] for r in rows):
        with pre_merge_nms(torch) as got_nms:
            fwd()
        with pre_merge_nms(torch) as want_nms, \
                cuda_lib.plain_versions(keep=K15):
            fwd()
        anchors = pre_merge_is_nms(torch, cuda_lib, got_nms, want_nms)
        with pre_merge_nms(torch, inject=want_nms):
            got2 = fwd()
        for i in range(len(got2[1])):
            if not rows_match((got2[0][i], got2[1][i]),
                              (want[0][i], want[1][i]), PAIR_PATH_TOL)[0]:
                raise AssertionError(f"P21 frozen forward, image {i}: "
                                     f"beyond {PAIR_PATH_TOL} of plain, and "
                                     f"not by NMS decisions alone")
    return (max(r[1] for r in rows), max(r[2] for r in rows), anchors)


def fold_step_vs_plain(torch, cuda_lib, trainer, batch, dev="cuda"):
    """(a)'s first two steps (one optimizer update at every_k 2) from the
    same start and the same draws, with the kernels and inside
    ``plain_versions(keep=K15)``: (loss, plain loss, largest difference of the
    trained leaves after the update, frozen leaves identical)."""
    from millieye_torch.train.optim import (STAGE3_FROZEN, label_tree,
                                            tree_leaves)
    from millieye_torch.train.steps import generator_draw

    def run():
        draw = generator_draw(torch.Generator(device=dev).manual_seed(3))
        ts, m = trainer.step(trainer.ts, batch, draw)
        loss = float(m["loss"])
        ts, _ = trainer.step(ts, batch, draw)
        return loss, ts.params

    loss, got = run()
    with cuda_lib.plain_versions(keep=K15):
        plain_loss, want = run()
    labels = tree_leaves(label_tree(got, STAGE3_FROZEN))
    d_trained, frozen_same = 0.0, True
    for lab, a, b, c in zip(labels, tree_leaves(got), tree_leaves(want),
                            tree_leaves(trainer.ts.params)):
        if lab == "freeze":
            frozen_same &= torch.equal(a, c) and torch.equal(b, c)
        else:
            d_trained = max(d_trained, float((a - b).abs().max()))
    return loss, plain_loss, d_trained, frozen_same


def _yolo_grads(torch, darknet, p, s, batch, dtype):
    """The stage-1 loss and its gradient leaves, straight through
    ``Darknet.apply(train=True, compute_dtype=dtype)`` and ``yolo_loss``
    on the trees' and the batch's device, in ``dtype``."""
    from millieye_torch.models.yolo_head import yolo_loss
    from millieye_torch.train.optim import tree_leaves, tree_map
    dev = batch["images"].device
    p = tree_map(lambda t: t.to(dev, dtype).requires_grad_(True), p)
    s = tree_map(lambda t: t.to(dev, dtype), s)
    out = darknet.apply(p, s, batch["images"].to(dtype), train=True,
                        compute_dtype=dtype)
    loss, _ = yolo_loss(out["preds"], darknet.anchors_per_scale,
                        batch["images"].shape[1], batch["targets"].to(dtype),
                        batch["tmask"])
    return float(loss.detach()), [g.double().cpu() for g in torch.autograd.grad(
        loss, tree_leaves(p))]


def yolo_step_vs_cpu(torch, darknet, p0, s0, batch, dev="cuda"):
    """(d)'s first step on the card and on the CPU from the seed-0 init,
    and the same gradient in float64 on the CPU: the loss of the two
    steps within ``YOLO_CPU_TOL["loss"]``; the card's gradient (the
    accumulated gradient after one step at every_k 2 is that step's) no
    farther from the float64 one, at its worst leaf element, than
    ``YOLO_CPU_TOL["f64"]`` times the CPU's (float32 in both, TF32 off on
    the card). Returns the numbers."""
    from millieye_torch.io.checkpoint import to_device
    from millieye_torch.train.optim import frozen_adam, tree_leaves
    from millieye_torch.train.steps import (init_train_state,
                                            make_yolo_train_step)
    out = []
    for d in (dev, "cpu"):
        p, s = to_device(p0, d), to_device(s0, d)
        tx = frozen_adam(p, lr=TRAIN_LR, every_k=2)
        step = make_yolo_train_step(darknet, tx)
        b = {k: batch[k].to(d) for k in ("images", "targets", "tmask")}
        ts, m = step(init_train_state(p, s, tx), b)
        out.append((float(m["loss"]), [
            g.double().cpu() for g in tree_leaves(ts.opt_state.acc_grads)]))
    ref_loss, ref = _yolo_grads(torch, darknet, p0, s0, {
        k: batch[k].cpu() for k in ("images", "targets", "tmask")},
        torch.float64)
    top = max(float(g.abs().max()) for g in ref)
    err = {"card": [], "cpu": []}
    for gc, gh, gr in zip(out[0][1], out[1][1], ref):
        err["card"].append(float((gc - gr).abs().max()))
        err["cpu"].append(float((gh - gr).abs().max()))
    r = {"loss": out[0][0], "cpu_loss": out[1][0], "f64_loss": ref_loss,
         "worst_card_err_of_tree_max": max(err["card"]) / top,
         "worst_cpu_err_of_tree_max": max(err["cpu"]) / top,
         "card_vs_cpu_err_of_tree_max": max(float((a - b).abs().max())
                                            for a, b in zip(out[0][1],
                                                            out[1][1])) / top,
         "tf32": {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                  "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                  "cudnn.conv.fp32_precision": getattr(getattr(
                      torch.backends.cudnn, "conv", None), "fp32_precision",
                      None)}}
    log(f"  yolo first step against float64: {r}")
    if abs(r["loss"] - r["cpu_loss"]) > YOLO_CPU_TOL["loss"] * abs(
            r["cpu_loss"]) or max(err["card"]) > YOLO_CPU_TOL["f64"] * max(
            err["cpu"]):
        raise AssertionError(f"P21 yolo: the card's first step beyond "
                             f"{YOLO_CPU_TOL} of the CPU's: {r}")
    return r


def train_phase(torch, cuda_lib, zero_counts, counts, card, dev="cuda"):
    """P21: ``cli.train.main`` in this process on ``SyntheticScenes(64,
    seed=777)`` at 416 px, batch 8, every_k 2, one epoch (8 steps) each:
    (a) stage 3 ``--fold_frozen`` from the tracked checkpoint, (b) stage 3
    unfolded, (c) stage 2 from the checkpoint's Darknet and score-map
    stack (seed-0 heads), (d) stage 1 from the seed-0 init. Every step's
    launches are read around it and must be the run's kernels once each
    (``TRAIN_EXPECT``); every metric finite and ``nonfinite_reverted`` 0;
    the frozen leaves (and the Darknet's BN statistics) bit-identical
    after the run and the trained ones moved. (a) again inside
    ``plain_versions(keep=K15)``: its frozen forward
    (``fold_forward_vs_plain``) and its first two steps (``fold_step_vs_plain``); (d)'s first step
    against the CPU's (``yolo_step_vs_cpu``). Returns (summary, {run:
    launches})."""
    import tempfile
    from millieye_torch.cli import train as tcli
    from millieye_torch.cli._common import (TRAIN_FOLD, build_darknet,
                                            build_fusion, build_refine)
    from millieye_torch.io.checkpoint import (load_checkpoint,
                                              save_checkpoint, to_device)
    from millieye_torch.train import recipes
    from millieye_torch.train.optim import (STAGE2_FROZEN, STAGE3_FROZEN,
                                            tree_leaves)
    from millieye_torch.train.steps import generator_draw
    tmp = tempfile.TemporaryDirectory()
    train_args = ["--synthetic", str(TRAIN_SCENES), "--seed", "777",
                  "--img_size", str(TRAIN_SIZE), "--batch_size",
                  str(TRAIN_BATCH), "--grad_accum", "2", "--epochs", "1",
                  "--device", dev]
    darknet = build_darknet(img_size=TRAIN_SIZE)
    p0, s0 = darknet.init(torch.Generator().manual_seed(0))
    yolo_init = f"{tmp.name}/yolo_seed0.npz"
    save_checkpoint(yolo_init, {"params": p0, "state": s0})
    runs = {"fusion_fold": ["--stage", "fusion", "--fold_frozen",
                            "--checkpoint", CKPT],
            "fusion": ["--stage", "fusion", "--checkpoint", CKPT],
            "refine": ["--stage", "refine", "--pretrained", CKPT],
            "yolo": ["--stage", "yolo", "--checkpoint", yolo_init]}
    summary, launches = {}, {}
    for name, argv in runs.items():
        t = time.time()
        zero_counts()
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with step_probe(torch, recipes, counts) as rec:
            trainer = tcli.main(argv + train_args + [
                "--checkpoint_dir", f"{tmp.name}/{name}"])
        wall = time.time() - t
        launches[f"train {name}"] = counts()
        peak_mb = (torch.cuda.max_memory_allocated() / 2 ** 20
                   if dev == "cuda" else 0.0)
        n = len(rec["s"])
        if n != TRAIN_SCENES // TRAIN_BATCH or trainer.ts.step != n:
            raise AssertionError(f"P21 {name}: {n} steps")
        want = TRAIN_EXPECT[name]
        for i, got in enumerate(rec["launches"]):
            if {k: v for k, v in got.items() if v} != want:
                raise AssertionError(f"P21 {name} step {i}: launched {got}, "
                                     f"expected {want}")
        for i, m in enumerate(rec["metrics"]):
            if not all(np.isfinite(v) for k, v in m.items()
                       if k not in TRAIN_OUTSIDE_TOTAL.get(name, ())) \
                    or m["nonfinite_reverted"]:
                raise AssertionError(f"P21 {name} step {i}: metrics {m}")
        params, state = trainer.ts.params, trainer.ts.state
        if name.startswith("fusion"):
            start = to_device(load_checkpoint(CKPT, {"params": params,
                                                     "state": state}), dev)
            ok = (_frozen_identical(torch, params, start["params"],
                                    STAGE3_FROZEN)
                  and all(torch.equal(a, b) for a, b in zip(
                      tree_leaves(state["darknet"]),
                      tree_leaves(start["state"]["darknet"]))))
            moved = {k: _leaves_moved(torch, v, w) for k, v, w in (
                ("radar_enc", params["radar_enc"],
                 start["params"]["radar_enc"]),
                ("refine.radar_net", params["refine"]["radar_net"],
                 start["params"]["refine"]["radar_net"]),
                ("ensemble", params["ensemble"],
                 start["params"]["ensemble"]))}
        elif name == "refine":
            _, rp, rs = build_refine(CKPT, img_size=TRAIN_SIZE, device=dev)
            ok = (_frozen_identical(torch, params, rp, STAGE2_FROZEN)
                  and all(torch.equal(a, b) for a, b in zip(
                      tree_leaves(state["darknet"]),
                      tree_leaves(rs["darknet"]))))
            # module2 trains on its image proposals alone: only a run
            # whose proposals met a target (IoU above 0.7) has a loss
            if sum(m["true"] for m in rec["metrics"]):
                moved = {k: _leaves_moved(torch, params[k], rp[k])
                         for k in ("fcn", "refine", "ensemble")}
            else:
                moved = {"no positives in the run": True}
        else:
            ok = True
            moved = {"darknet": _leaves_moved(torch, params,
                                              to_device(p0, dev))}
        if not ok or not all(moved.values()):
            raise AssertionError(f"P21 {name}: frozen leaves identical "
                                 f"{ok}, trained ones moved {moved}")
        draw = generator_draw(torch.Generator(device=dev).manual_seed(1))
        busy, pwall, _, _ = profile_run(torch, lambda: rec["step_fn"](
            trainer.ts, rec["batch"], draw))
        r = {"steps": n, "wall_s": wall,
             "steps_per_s_after_first": (n - 1) / sum(rec["s"][1:]),
             "first_step_s": rec["s"][0],
             "device_ms_per_step": busy, "profiled_step_wall_ms": pwall,
             "busy_share": busy / pwall, "peak_mb": peak_mb,
             "loss_first_last": (rec["metrics"][0]["loss"],
                                 rec["metrics"][-1]["loss"]),
             "launches_per_step": want, "moved": moved}
        if name == "fusion_fold":
            model, fp_, fs_ = build_fusion(CKPT, TRAIN_FOLD,
                                           img_size=TRAIN_SIZE, device=dev)
            r["frozen_forward_vs_plain"] = fold_forward_vs_plain(
                torch, cuda_lib, model, fp_, fs_, rec["batch"]["images"],
                zero_counts, counts)
            twin = recipes.fusion_trainer(model, fp_, fs_,
                                          f"{tmp.name}/twin",
                                          lr=TRAIN_LR, every_k=2,
                                          fold_frozen=True)
            loss, plain_loss, d_tr, frozen_same = fold_step_vs_plain(
                torch, cuda_lib, twin, rec["batch"], dev)
            if not (abs(loss - plain_loss) <= TRAIN_LOSS_RTOL
                    * abs(plain_loss) and frozen_same
                    and d_tr <= 2 * TRAIN_LR + 1e-6):
                raise AssertionError(
                    f"P21 fold step against plain: loss {loss} / "
                    f"{plain_loss}, trained leaves {d_tr} apart, frozen "
                    f"identical {frozen_same}")
            r["step_vs_plain"] = {"loss": loss, "plain_loss": plain_loss,
                                  "trained_leaves_max_diff": d_tr}
            del model, fp_, fs_, twin
        if name == "yolo":
            r["first_step_vs_cpu"] = yolo_step_vs_cpu(
                torch, darknet, p0, s0, rec["batch"], dev)
        log(f"P21 {name} ({card}): {n} steps, "
            f"{r['steps_per_s_after_first']:.2f} steps/s after the first "
            f"(host clock, synchronised; first step {rec['s'][0]:.2f} s), "
            f"device {busy:.2f} ms of {pwall:.2f} ms a profiled step (busy "
            f"{100 * busy / pwall:.1f}%), peak {peak_mb:.0f} MB allocated, "
            f"launches a step {want or 'none'}, loss {r['loss_first_last']}"
            f", trained leaves moved {moved}; {wall:.1f} s")
        for k in ("frozen_forward_vs_plain", "step_vs_plain",
                  "first_step_vs_cpu"):
            if k in r:
                log(f"  {k}: {r[k]}")
        summary[name] = r
        del trainer, rec
        torch.cuda.empty_cache()
    tmp.cleanup()
    return summary, launches


# phase P22: the live path, cli.realtime over P15's recorded session
# (the radar as a TI UART byte stream, the camera as a capture of the
# recorded frames), and cli.prepare_data on the same recording
LIVE_CFG = ("% the contract's cfg (tests/test_collection.py:57-71)",
            "sensorStop",
            "profileCfg 0 60 7 3 24 0 0 166 1 256 12500 0 0 30",
            "frameCfg 0 2 16 0 55 1 0", "sensorStart")
LIVE_PROFILED = 24             # frames of P22's profiled run
# the launches of each live frame at pallas_max_s01: K14 on the 11 plain
# convolutions the stem pair leaves (folded, bfloat16, their bias too);
# K15 on the one of them in float32 (stage 4)
LIVE_LAUNCHES = {"stem_pair": 1, "nms": 1, "ps_roi_align": 1, "roi_align": 1,
                 "nms_full": 1, "conv_epilogue": 11, "conv2d_nhwc": 1}


def tlv_packet(frame_no, xyzv):
    """One TI demo-protocol packet of ``xyzv`` [n, 4] float32 rows: the
    40-byte header and one type-1 (detected points) TLV, the layout of
    tests/test_collection.py:17-27."""
    import struct
    payload = np.ascontiguousarray(xyzv, np.float32).tobytes()
    tlv = struct.pack("<II", 1, len(payload)) + payload
    header = bytes([2, 1, 4, 3, 6, 5, 8, 7]) + struct.pack(
        "<IIIIIIII", 0x0A0B0C0D, 40 + len(tlv), 0x68430000, frame_no,
        12345, len(xyzv), 1, 0)
    return header + tlv


def radar_stream(rec, seed=11):
    """The recording's radar frames (``pointcloud.pkl``) as the sensor's
    data port would send them: 61 bytes of garbage (no magic word), then
    one packet a frame. Returns (stream, the end offset of each packet,
    each frame's float32 [n, 4] xyzv rows)."""
    import os
    import pickle
    with open(os.path.join(rec, "pointcloud.pkl"), "rb") as f:
        records = pickle.load(f)
    rows = [np.stack([r["Data"][k] for k in ("x", "y", "z", "velocity")],
                     1).astype(np.float32) for r in records]
    stream = bytearray(np.random.default_rng(seed).integers(
        9, 256, 61, np.uint8).tobytes())
    ends = []
    for r, xyzv in zip(records, rows):
        stream += tlv_packet(r["Frame_ID"], xyzv)
        ends.append(len(stream))
    return bytes(stream), ends, rows


class SerialReplay:
    """A data port that replays a byte stream as a serial port hands it
    over: bytes become readable when ``release_to(offset)`` is called (the
    sensor sent them), a read returns at most the next of a seeded run of
    uneven chunk sizes (1-700 bytes), and a read with nothing to return
    waits up to ``timeout`` s (pyserial's ``timeout=0.1``) and returns
    b""."""

    def __init__(self, stream, seed=12, timeout=0.1):
        import threading
        self.stream, self.timeout = stream, timeout
        self.pos = self.limit = 0
        self.sizes = np.random.default_rng(seed).integers(1, 701, 1 << 16)
        self.reads = 0
        self.cond = threading.Condition()

    def release_to(self, end):
        with self.cond:
            self.limit = max(self.limit, end)
            self.cond.notify_all()

    def read(self, size):
        with self.cond:
            if self.pos >= self.limit:
                self.cond.wait(self.timeout)
            k = min(size, int(self.sizes[self.reads % len(self.sizes)]),
                    self.limit - self.pos)
            if k <= 0:
                return b""
            self.reads += 1
            chunk = self.stream[self.pos:self.pos + k]
            self.pos += k
            return chunk


class ReplayCapture:
    """A camera (``cv2.VideoCapture``'s ``read``/``release``) over
    recorded RGB frames: each read returns a BGR copy of the next frame
    and lets the radar port deliver that frame's packet, so radar and
    camera run at one rate, as in the recording; ``on_read(i)`` is called
    before frame i is returned."""

    def __init__(self, frames, port, ends, on_read=None):
        self.frames, self.port, self.ends = frames, port, ends
        self.on_read = on_read
        self.i = 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        i, self.i = self.i, self.i + 1
        if i < len(self.ends):
            self.port.release_to(self.ends[i])
        if self.on_read:
            self.on_read(i)
        return True, np.ascontiguousarray(self.frames[i][1][:, :, ::-1])

    def release(self):
        pass


def live_phase(torch, eng, rec, frames, calib_path, counts=None,
               zero_counts=None, dev="cuda", profile=True):
    """P22: ``cli.realtime.main`` in this process over a recorded session:
    ``frames`` through a ``ReplayCapture``, the radar frames of ``rec`` as
    a UART byte stream (``radar_stream``) through the port's
    ``RadarReader`` over a ``SerialReplay`` data port, a headless display
    that keeps each frame's record, and ``eng`` (built by the caller).
    Checks: the native frame parser answered every packet (in the loop's
    reader, and over the whole stream, each frame the recording's float32
    points); the radar thread stopped when ``main`` returned; each frame's
    ``boxes`` and ``valid`` bit-identical to ``eng.infer`` on the points
    that frame consumed, replayed through a second ``RadarPipeline`` with
    the loop's parameters in the loop's order; and, with ``counts`` (the
    kernel wrappers' launch counts), K4, K1, K2, K3 and K5 launched once
    in each frame and nothing else (set to 0 by ``zero_counts`` before
    the run, read after it). Returns the phase's numbers: host ms
    a frame (from the capture's read to the display), frames/s, and with
    ``profile`` the device's busy share over a run of its first
    ``LIVE_PROFILED`` frames."""
    import io
    import os
    import threading
    from millieye_torch.cli import realtime
    from millieye_torch.collection.uart import FrameAssembler, RadarReader
    from millieye_torch.radar.pipeline import RadarParams, RadarPipeline
    from millieye_torch.radar.projection import load_calib
    cfg = os.path.join(rec, "radar.cfg")
    with open(cfg, "w") as f:
        f.write("\n".join(LIVE_CFG) + "\n")
    stream, ends, rows = radar_stream(rec)
    w, h = eng.frame_size
    argv = ["--calib", calib_path, "--cfg", cfg, "--frame_w", str(w),
            "--frame_h", str(h), "--mode", "0", "--device", dev]

    # the whole stream through a reader: every packet, by the native branch
    port = SerialReplay(stream)
    port.release_to(len(stream))
    FrameAssembler.backends.clear()
    reader = RadarReader(cfg, cli=io.BytesIO(), data=port)
    parsed = []
    while port.pos < len(stream):
        parsed += reader.poll()
    if [n for n, _ in parsed] != list(range(len(rows))) or not all(
            np.array_equal(p, r) for (_, p), r in zip(parsed, rows)) \
            or dict(FrameAssembler.backends) != {"native": len(rows)}:
        raise AssertionError(f"live: the stream parsed to {len(parsed)} of "
                             f"{len(rows)} frames, backends "
                             f"{dict(FrameAssembler.backends)}")

    def run(n_frames, shown, marks):
        port = SerialReplay(stream)
        cli = io.BytesIO()

        def on_read(i):
            marks.append([time.perf_counter(), counts() if counts else None])

        def display(bgr, frame):
            marks[-1] += [time.perf_counter(), counts() if counts else None]
            shown.append(dict(frame, shape=bgr.shape))

        rc = realtime.main(
            argv, capture=ReplayCapture(frames[:n_frames], port, ends,
                                        on_read),
            reader=RadarReader(cfg, cli=cli, data=port), display=display,
            engine=eng)
        alive = [t for t in threading.enumerate()
                 if t.name == "realtime-radar"]
        if rc != 0 or alive or len(shown) != n_frames \
                or b"sensorStart" not in cli.getvalue():
            raise AssertionError(f"live: main returned {rc}, {len(shown)} of "
                                 f"{n_frames} frames shown, radar threads "
                                 f"alive after it {alive}, or the cfg was "
                                 f"not sent")
        return port

    FrameAssembler.backends.clear()
    shown, marks = [], []
    if counts:
        zero_counts()
    port = run(len(frames), shown, marks)
    launches = counts() if counts else None
    backends = dict(FrameAssembler.backends)
    if backends.get("numpy") or not backends.get("native"):
        raise AssertionError(f"live: the loop's parser backends {backends}")
    radar = RadarPipeline(load_calib(calib_path),
                          RadarParams(frame_size=eng.frame_size))
    differ, with_points, with_props = [], 0, 0
    for i, ((_, f), got) in enumerate(zip(frames, shown)):
        r = radar.process(got["pts"])
        want = eng.infer(f, r["points_uvzv"], r["proposals"], 0)
        if got["shape"] != f.shape or not same_answer(
                (got["boxes"], got["valid"]), want):
            differ.append(i)
        with_points += got["pts"].shape[1] > 0
        with_props += len(r["proposals"]) > 0
    if differ:
        raise AssertionError(f"live: frames {differ} differ from "
                             f"FusionEngine.infer on the points they "
                             f"consumed")
    per_frame = None
    if counts:
        per_frame = [{k: b[k] - a[k] for k in a if b[k] != a[k]}
                     for _, a, _, b in marks]
        want = LIVE_LAUNCHES
        bad = [i for i, c in enumerate(per_frame) if c != want]
        if bad:
            raise AssertionError(f"live: frames {bad} launched "
                                 f"{[per_frame[i] for i in bad[:3]]}, want "
                                 f"{want} each")
    frame_ms = [(b - a) * 1e3 for a, _, b, _ in marks]
    out = {"frames": len(shown), "frames_with_points": int(with_points),
           "frames_with_proposals": int(with_props),
           "frame_host_ms_mean": float(np.mean(frame_ms)),
           "frame_host_ms_p50": float(np.median(frame_ms)),
           "frame_host_ms_max": float(max(frame_ms)),
           "frames_per_s": len(shown) / (marks[-1][2] - marks[0][0]),
           "port_reads": port.reads,
           "native_frames_loop": backends["native"],
           "native_frames_stream": len(parsed),
           "launches_per_frame": per_frame[0] if per_frame else None,
           "launches": launches}
    if profile:
        n_prof = min(LIVE_PROFILED, len(frames))
        busy, wall, _, _ = profile_run(torch, lambda: run(n_prof, [], []))
        out["profiled"] = {"frames": n_prof, "device_busy_ms": busy,
                           "wall_ms": wall, "busy_share": busy / wall}
    return out


def prepare_data_check(rec, calib_path, out_dir, scene=""):
    """``cli.prepare_data.main`` on a recording, against an in-process
    ``RadarPipeline`` (the CLI's ``RadarParams()`` and calibration) fed
    the same matches and overlay: the stems every 5th frame, the
    ``dataset.txt`` lines, and each kept frame's ``radar_point`` and
    ``radar_box`` pickles equal (dtype, shape and values). Returns the
    stems."""
    import os
    import pickle
    from millieye_torch.cli import prepare_data
    from millieye_torch.collection.sync import (load_pointcloud,
                                                load_timestamps,
                                                match_frames)
    from millieye_torch.radar.pipeline import RadarParams, RadarPipeline
    from millieye_torch.radar.projection import load_calib
    prepare_data.main(["--recording", rec, "--out", out_dir, "--calib",
                       calib_path] + (["--scene", scene] if scene else []))
    params = RadarParams()
    vt = load_timestamps(os.path.join(rec, "timestamps.txt"))
    rt, rf = load_pointcloud(os.path.join(rec, "pointcloud.pkl"))
    matches = match_frames(vt, rt, params.num_nearest)
    n = min(len(matches), len(os.listdir(os.path.join(rec, "frames"))))
    radar = RadarPipeline(load_calib(calib_path), params)
    overlay, stems = [], []
    for i in range(n):
        overlay = (overlay + [rf[j] for j in matches[i]])[
            -params.overlay_num:]
        r = radar.process(np.concatenate(overlay, 1) if overlay
                          else np.zeros((4, 0)))
        if i % 5:
            continue
        stem = f"{scene}{i:06d}"
        stems.append(stem)
        for sub, want in (("radar_point", r["points_uvzv"]),
                          ("radar_box", r["proposals"])):
            with open(os.path.join(out_dir, sub, stem + ".pkl"), "rb") as f:
                got = pickle.load(f)
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(f"prepare_data: {sub}/{stem} differs "
                                     f"from the in-process pipeline")
    with open(os.path.join(out_dir, "dataset.txt")) as f:
        listed = f.read().splitlines()
    images = sorted(os.listdir(os.path.join(out_dir, "image")))
    if listed != [os.path.join(out_dir, "image", s + ".jpg")
                  for s in stems] or images != [s + ".jpg" for s in stems]:
        raise AssertionError(f"prepare_data: dataset.txt {len(listed)} "
                             f"lines, images {len(images)}, want the stems "
                             f"{stems}")
    return stems


_SERVE = r"""
import json, sys, time
import numpy as np
import torch
import chip_smoke
from millieye_torch.io.export import load_serving
from millieye_torch.ops import cuda_lib, library
t0 = time.perf_counter()
step = load_serving(open(sys.argv[1], "rb").read())
load_s = time.perf_counter() - t0
if "millieye_torch.models" in sys.modules:
    raise SystemExit("load_serving imported millieye_torch.models")
z = np.load(sys.argv[2])
ins = [tuple(torch.from_numpy(z[f"{k}{i}"]).cuda()
             for k in ("imgs", "maps", "rb", "rm"))
       for i in range(int(z["n"]))]
step(*ins[0])                              # first call: builds the kernels
fns = {n: op.wrapper for n, op in library.OPS.items()}
for f in fns.values():
    f.launches = 0
outs = [step(*x) for x in ins]
torch.cuda.synchronize()
launches = {n: f.launches for n, f in fns.items() if f.launches}
for f in fns.values():
    f.launches = 0
with cuda_lib.plain_versions():
    plain = step(*ins[0])
torch.cuda.synchronize()
plain_launches = {n: f.launches for n, f in fns.items() if f.launches}
dev_ms = chip_smoke.device_ms(torch, lambda: step(*ins[0]))
host = chip_smoke.host_ms(torch, lambda: step(*ins[0]))
res = {f"boxes{i}": o["boxes"].cpu().numpy() for i, o in enumerate(outs)}
res.update({f"valid{i}": o["valid"].cpu().numpy()
            for i, o in enumerate(outs)})
res.update(plain_boxes=plain["boxes"].cpu().numpy(),
           plain_valid=plain["valid"].cpu().numpy())
np.savez(sys.argv[3], **res)
print(json.dumps({"load_s": load_s, "launches": launches,
                  "plain_launches": plain_launches, "meta": step.meta,
                  "device_ms": dev_ms[0], "device_records": dev_ms[1],
                  "host_ms": host, "calls": len(ins),
                  "models_imported": "millieye_torch.models" in sys.modules}))
"""


def p1_inputs(eng, reqs):
    """What ``FusionNetwork.apply`` gets from ``FusionEngine.infer`` for
    each request: (images, radar maps, radar boxes, mask), batch 1."""
    seen, real = [], eng.model.apply

    def record(params, state, *args, **kw):
        seen.append(tuple(t.clone() for t in args[:4]))
        return real(params, state, *args, **kw)

    eng.model.apply = record
    try:
        for r in reqs:
            eng.infer(*r)
    finally:
        del eng.model.apply
    return seen


def export_phase(torch, cuda_lib, engines, reqs, p1_host_ms):
    """P20: ``cli.export.main --verify`` on the card at pallas_max_s01 b1,
    pallas_max4 b8 and f32 b1; each blob served by ``load_serving`` in a
    process of its own that imports no model code, on P1's letterboxed
    inputs (the 8 requests, as 8 calls at b1 or one at b8): its answers
    bit-identical to the live ``FusionNetwork.apply``, its launches the
    preset's kernels once a call, and, inside ``plain_versions()``, the
    plain versions (no launch, K15's too, bit-identical to the live
    graph's plain run); then what a custom op costs the host
    against a direct launch.
    Returns (summary, {label: launches})."""
    import io
    import os
    import tempfile
    from millieye_torch.cli import export
    from millieye_torch.ops import library, nms_kernel

    summary, launches_by_run = {}, {}
    cases = (("pallas_max_s01", 1, _RIGHT_PAIR),
             ("pallas_max4", 8, _RIGHT_PAIR + ("stem_stage",)),
             ("f32", 1, ("nms",)))
    d = tempfile.TemporaryDirectory()
    for preset, batch, must in cases:
        label = f"export@{preset}_b{batch}"
        eng = engines[preset]
        per_req = p1_inputs(eng, reqs)
        calls = (per_req if batch == 1 else
                 [tuple(torch.cat(ts) for ts in zip(*per_req))])
        blob = os.path.join(d.name, f"{preset}.pt2")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = export.main(["--out", blob, "--serving", preset,
                               "--weights", CKPT, "--batch", str(batch),
                               "--verify"])
        if not res["verify_bit_identical"]:
            raise AssertionError(f"{label}: --verify: the artifact differs "
                                 f"from the live graph: {out.getvalue()}")
        ins = os.path.join(d.name, f"{preset}_in.npz")
        arrays = {"n": len(calls)}
        for i, c in enumerate(calls):
            arrays.update({f"{k}{i}": t.cpu().numpy() for k, t in
                           zip(("imgs", "maps", "rb", "rm"), c)})
        np.savez(ins, **arrays)
        got_path = os.path.join(d.name, f"{preset}_out.npz")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _SERVE, blob, ins,
                               got_path], capture_output=True, text=True)
        proc_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"{label}: the serving process failed:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        got = np.load(got_path)
        with torch.inference_mode():
            live = [eng.model.apply(eng.params, eng.state, *c) for c in calls]
            with cuda_lib.plain_versions():
                live_plain = eng.model.apply(eng.params, eng.state, *calls[0])
        same, gap, fl = 0, 0.0, 0
        for i, o in enumerate(live):
            g = (got[f"boxes{i}"], got[f"valid{i}"])
            w = (o["boxes"].cpu().numpy(), o["valid"].cpu().numpy())
            if np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]):
                same += 1
                continue
            for j in range(len(g[0])):
                ok, db, ds, f = rows_match((g[0][j], g[1][j]),
                                           (w[0][j], w[1][j]), PAIR_PATH_TOL)
                gap, fl = max(gap, db, ds), fl + f
                if not ok:
                    raise AssertionError(
                        f"{label} call {i}: the artifact's answer differs "
                        f"from the live graph's beyond {PAIR_PATH_TOL} "
                        f"(box {db}, score {ds}, {f} rows on one side only)")
        if not (np.array_equal(got["plain_boxes"],
                               live_plain["boxes"].cpu().numpy())
                and np.array_equal(got["plain_valid"],
                                   live_plain["valid"].cpu().numpy())):
            raise AssertionError(f"{label}: the artifact inside "
                                 f"plain_versions() differs from the live "
                                 f"graph's plain run")
        short = {k: rep["launches"].get(k, 0) for k in must
                 if rep["launches"].get(k, 0) != len(calls)}
        if short or rep["plain_launches"] or rep["models_imported"]:
            raise AssertionError(f"{label}: replay launches {rep['launches']}"
                                 f" (need {must} once a call), inside "
                                 f"plain_versions() {rep['plain_launches']}")
        with torch.inference_mode():
            def live_call():
                return eng.model.apply(eng.params, eng.state, *calls[0])
            live_dev = device_ms(torch, live_call)
            live_host = host_ms(torch, live_call)
        launches_by_run[label] = rep["launches"]
        summary[label] = {
            "blob_mb": res["bytes"] / 1e6, "export_s": res["export_s"],
            "load_s": rep["load_s"], "serve_process_s": proc_s,
            "calls": len(calls), "bit_identical": same,
            "max_gap": gap, "rows_on_one_side": fl,
            "launches": rep["launches"],
            "device_ms": rep["device_ms"], "live_device_ms": live_dev[0],
            "host_ms": rep["host_ms"], "live_host_ms": live_host}
        log(f"{label}: blob {res['bytes'] / 1e6:.1f} MB, export "
            f"{res['export_s']:.2f} s, load {rep['load_s']:.2f} s in a "
            f"process of its own ({proc_s:.1f} s in all; no model code "
            f"imported); {same} of {len(calls)} calls bit-identical to the "
            f"live FusionNetwork.apply on P1's inputs"
            + ("" if same == len(calls) else
               f" (the rest within PAIR_PATH_TOL, gap {gap:.3g}, {fl} rows "
               f"on one side only)")
            + f"; launches {rep['launches']}; inside plain_versions() no "
            f"launch, bit-identical to the live plain run; device "
            f"{rep['device_ms']:.4f} ms a call ({rep['device_records']} "
            f"profiler records) against the live step's {live_dev[0]:.4f} "
            f"ms; host {rep['host_ms']:.3f} ms a call against the live "
            f"step's {live_host:.3f} ms")
    d.cleanup()

    # the custom op's cost on the host: K1 at P1's shape through its op
    # (the wrapper) against a direct launch of its kernel
    boxes, valid = (torch.tensor(a, device="cuda")
                    for a in nms_inputs(np.random.default_rng(3), 1, 128))
    op = library.OPS["nms"]
    via_op = host_ms(torch, lambda: nms_kernel.nms_keep_mask_blocked(
        boxes, valid, 0.5), calls=200)
    direct = host_ms(torch, lambda: op.launch(boxes, valid, 0.5), calls=200)
    summary["dispatch"] = {"op_host_ms": via_op, "direct_host_ms": direct,
                           "p1_host_ms": p1_host_ms}
    log(f"custom-op dispatch: K1 at b1, K 128 through millieye::nms "
        f"{via_op * 1e3:.1f} us a call on the host, a direct launch "
        f"{direct * 1e3:.1f} us ({(via_op - direct) * 1e3:.1f} us more; P1 "
        f"makes 5 such calls a request, whose host time is "
        f"{p1_host_ms:.2f} ms, p50)")
    return summary, launches_by_run


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


# phase P23: parallel/ on gloo ranks that share the card (the mesh,
# sharded evaluation, data- and tensor-parallel training, a sharded
# engine window and entry.dryrun_multichip)
PAR_RANKS = 4
PAR_TRAIN_SCENES = 32          # 4 steps of batch 8, 2 images a rank
PAR_TRAIN_ARGS = ["--stage", "fusion", "--fold_frozen", "--checkpoint",
                  CKPT, "--synthetic", str(PAR_TRAIN_SCENES), "--seed",
                  "777", "--img_size", "416", "--batch_size", "8",
                  "--grad_accum", "1", "--epochs", "1"]
PAR_MESH_ARGS = ["--data_parallel", "2", "--model_parallel", "2"]
PAR_EVAL_MAP_TOL = 1e-4        # f32: the mesh's mAP against one process
# the mesh's training against one process, both on the card. The ranks
# run the frozen forward at 2 images a call, one process at 8: cuDNN's
# bf16 convolutions may pick other algorithms and K1 other keep
# decisions, and the sums run in another order. Adam's step is
# lr m / sqrt(v) a step, about lr where the gradient's sign holds, so an
# element whose gradient is rounding noise in both runs may end up to a
# few lr apart. The limits (set from a first card run, which measured a
# step's loss 9.3e-5 relative apart, the trained parameters 1.9 lr, and
# 1.25e-5 of the checkpoint's elements beyond the CPU contract):
# * loss_rtol: each step's loss;
# * trained_lr: each trained parameter element, in lr;
# * bn_fed_lr_a_step: the conv biases that feed a train-mode BN
#   (PAR_BN_FED): their exact gradient is 0, so both runs step them by
#   rounding noise, each at most lr (1 - b1) / sqrt(1 - b2) ~ 3.17 lr a
#   step; nothing else holds them;
# * share: the least share of the checkpoint's elements within the CPU
#   contract's rtol 2e-4 / atol 2e-5;
# * bn_rel: the heads' BN statistics, relative to the leaf's largest.
# The frozen leaves and the frozen Darknet's BN state are bit-equal.
PAR_TRAIN_TOL = dict(loss_rtol=5e-4, trained_lr=3.0,
                     bn_fed_lr_a_step=2 * 3.17, share=1 - 1e-4,
                     bn_rel=2e-2)
PAR_BN_FED = {"params/radar_enc/0/b", "params/radar_enc/1/b",
              "params/radar_enc/2/b", "params/refine/radar_net/conv7/b"}
PAR_WORLD_TIMEOUT = 600
# the kernels each part must launch on every rank (a batch, a step, the
# window), and nothing else
# (K15: the float32 plain convolutions, 13 at f32 with their tails in
# its store, stage 4 at pallas_max_s01; K14: the 11 tails the stem pair
# leaves at pallas_max_s01 (bfloat16) and the 10 the pair and K9 leave at
# pallas_max4; with --fold_frozen, TRAIN_EXPECT's 11)
PAR_NEED = {"eval@f32": {"nms": 1, "conv2d_nhwc": 13},
            "eval@pallas_max_s01": dict(dict.fromkeys(_RIGHT_PAIR, 1),
                                        conv_epilogue=11, conv2d_nhwc=1),
            "train": TRAIN_EXPECT["fusion_fold"],
            "window": dict(dict.fromkeys(("stem_stage", "stem_pair", "nms",
                                          "ps_roi_align", "roi_align",
                                          "nms_full"), 1), conv_epilogue=10)}


def rank_counts():
    """This process's launch counts, every wrapper of ``ops/library.py``."""
    from millieye_torch.ops.library import OPS
    return {n: op.wrapper.launches for n, op in OPS.items()}


def zero_rank_counts():
    from millieye_torch.ops.library import OPS
    for op in OPS.values():
        op.wrapper.launches = 0


def _total(counts_list):
    """The launch counts of several ranks (or steps) added up."""
    out = {}
    for c in counts_list:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


class ParEvalProbe:
    """``cli.evaluate.main``'s probe: in each rank, the launch counts set
    to 0 around the evaluation and read after it, and each batch's
    answer (the rank's slice)."""

    @contextlib.contextmanager
    def around(self):
        from millieye_torch.eval import harness
        zero_rank_counts()
        with eval_records(harness) as (seen, _):
            yield
        self.launches = rank_counts()
        self.rows = [_np_out(r["out"]) for r in seen]

    def report(self):
        return {"launches": self.launches, "rows": self.rows}


def _digest(torch, leaves):
    import hashlib
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class ParTrainProbe:
    """``cli.train.main``'s probe: in each rank, the launch counts from 0
    at the start, each step's launches, loss and the digest of the
    replicated leaves (parameters and BN state) after it, and the digest
    of the frozen leaves at the start and the end. With ``save_dir``,
    ``report`` has every rank write the mesh's ``TrainState`` there with
    ``save_sharded`` and adds the save's wall seconds and the digest of
    each of the rank's tensors (its slices and its replicated leaves)."""

    def __init__(self, save_dir=None):
        self.save_dir = save_dir

    def start(self, trainer):
        self.mesh = trainer.mesh
        self.losses, self.launches, self.digests = [], [], []
        self.frozen0 = self._frozen(trainer.ts.params)
        zero_rank_counts()
        self.prev = rank_counts()

    def _frozen(self, params):
        from millieye_torch.io.checkpoint import leaf_items
        from millieye_torch.train.optim import STAGE3_FROZEN, label_tree
        import torch
        labels = dict(leaf_items(label_tree(params, STAGE3_FROZEN)))
        return _digest(torch, [x for k, x in leaf_items(params)
                               if labels[k] == "freeze"])

    def __call__(self, step_no, ts, metrics):
        import torch
        from millieye_torch.io.checkpoint import leaf_items
        now = rank_counts()
        self.launches.append({k: now[k] - self.prev[k] for k in now
                              if now[k] != self.prev[k]})
        self.prev = now
        self.losses.append(float(metrics["loss"]))
        sharded = self.mesh.sharded if self.mesh is not None else ()
        self.digests.append(_digest(torch, [
            x for k, x in leaf_items({"p": ts.params, "s": ts.state})
            if tuple(k.split("/")[1:]) not in sharded or k[0] == "s"]))

    def report(self, trainer):
        out = {"losses": self.losses, "launches": self.launches,
               "digests": self.digests,
               "frozen_same": self._frozen(trainer.ts.params)
               == self.frozen0}
        if self.save_dir is not None:
            import torch
            from millieye_torch.io.checkpoint import leaf_items, save_sharded
            t0 = time.perf_counter()
            save_sharded(self.save_dir, trainer.ts, mesh=trainer.mesh)
            out["sharded"] = {
                "save_s": time.perf_counter() - t0,
                "digests": {k: _digest(torch, [x])
                            for k, x in leaf_items(trainer.ts)
                            if isinstance(x, torch.Tensor)}}
        return out


def par_window_rank(rank, dev, reqs):
    """P23(c) in a rank: the ``pallas_max4`` engine's window of this
    rank's frames of ``reqs`` (its "data" slice), launches counted around
    the counted call (after a warm-up)."""
    import torch
    from millieye_torch import parallel
    from millieye_torch.cli._common import build_fusion
    from millieye_torch.runtime.engine import FusionEngine
    t0 = time.perf_counter()
    mesh = parallel.make_mesh(PAR_RANKS, model_axis=1,
                              devices=[str(dev)] * PAR_RANKS)
    model, params, state = build_fusion(CKPT, "pallas_max4", device=dev)
    eng = FusionEngine(model, params, state, frame_size=FRAME, device=dev)
    tens = window_tensors(torch, eng, reqs, dev)
    mine = list(parallel.shard_batch(
        mesh, {str(i): t for i, t in enumerate(tens)}).values())
    step = eng.batched_step_fn(0)
    build_s = time.perf_counter() - t0
    step(*mine)                                   # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0 - build_s
    zero_rank_counts()
    t0 = time.perf_counter()
    rows = [a.cpu().numpy() for a in step(*mine)]
    ms = (time.perf_counter() - t0) * 1e3
    return {"rows": rows, "launches": rank_counts(), "ms": ms,
            "index": mesh.index("data"), "build_s": build_s,
            "warm_s": warm_s}


def _slice_batch(batch, lo, hi):
    """Images [lo, hi) of a device batch (its host copy too)."""
    size = batch["images"].shape[0]

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if hasattr(x, "shape") and len(x.shape) and x.shape[0] == size:
            return x[lo:hi]
        return x

    return {k: v if k in ("_n", "brightness") else cut(v)
            for k, v in batch.items()}


def slice_flips(torch, cuda_lib, rec, lo, hi, rank_rows, tol):
    """A rank's answer for images [lo, hi) of a batch (the rank ran them
    at batch hi - lo) beyond ``tol`` of the one-process answer (batch 8):
    prove that NMS decisions alone make the difference. The slice again
    here must repeat the rank's answer bit for bit; each run's pre-merge
    NMS must be the plain NMS of its own detections and have kept other
    anchors; and each run under the other's decisions must meet the
    other's answer within ``tol``, image by image. Returns the anchors
    kept by one run only."""
    forward, batch = rec["forward"], rec["batch"]
    part = _slice_batch(batch, lo, hi)

    def cut(recs):
        return [dict(r, pred=r["pred"][lo:hi], out=r["out"][lo:hi],
                     valid=r["valid"][lo:hi], anchors=r["anchors"][lo:hi])
                for r in recs]

    def put(full, part_recs):
        out = []
        for f, p in zip(full, part_recs):
            valid, anchors = f["valid"].clone(), f["anchors"].clone()
            valid[lo:hi], anchors[lo:hi] = p["valid"], p["anchors"]
            out.append(dict(f, valid=valid, anchors=anchors))
        return out

    with torch.inference_mode():
        with pre_merge_nms(torch) as got_nms:
            got = _np_out(forward(part))
        with pre_merge_nms(torch) as want_nms:
            want = _np_out(forward(batch))
        if not all(np.array_equal(a, b) for a, b in zip(got, rank_rows)):
            raise AssertionError("a rank's slice did not repeat here")
        anchors = pre_merge_is_nms(torch, cuda_lib, got_nms, cut(want_nms))
        if not anchors:
            raise AssertionError("a rank's slice differs beyond its bound "
                                 "with the same NMS decisions")
        with pre_merge_nms(torch, inject=cut(want_nms)):
            got2 = _np_out(forward(part))
        with pre_merge_nms(torch, inject=put(want_nms, got_nms)):
            want2 = _np_out(forward(batch))
    want = tuple(a[lo:hi] for a in want)
    want2 = tuple(a[lo:hi] for a in want2)
    for a, b in ((got2, want), (got, want2)):
        for i in range(len(a[0])):
            ok, db, ds, fl = rows_match((a[0][i], a[1][i]),
                                        (b[0][i], b[1][i]), tol)
            if not ok:
                raise AssertionError(
                    f"a rank's slice under the one-process run's NMS "
                    f"decisions differs beyond {tol} (image {lo + i}: box "
                    f"{db}, score {ds}, {fl} rows on one side only)")
    return anchors


def _eval_part(torch, cuda_lib, evaluate, preset, one, dev):
    """P23(a) at one preset: ``cli.evaluate.main --data_parallel 4``
    against P19's one-process run of the same arguments (``one``: its
    mAP and records)."""
    m_one, seen = one
    probe = ParEvalProbe()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        m_ap = evaluate.main(EVAL_ARGS + [
            "--what", "fusion", "--serving", preset, "--data_parallel",
            str(PAR_RANKS), "--device", dev], probe=probe,
            timeout=PAR_WORLD_TIMEOUT)
    wall = time.perf_counter() - t0
    n_b = len(seen)
    per = EVAL_BATCH // PAR_RANKS
    need = {k: v * n_b for k, v in PAR_NEED[f"eval@{preset}"].items()}
    d_box = d_score = 0.0
    flips = anchors = 0
    for r, rep in enumerate(probe.reports):
        short = {k: rep["launches"][k] for k, v in need.items()
                 if rep["launches"][k] != v}
        other = {k: v for k, v in rep["launches"].items()
                 if v and k not in need}
        if len(rep["rows"]) != n_b or short or other:
            raise AssertionError(
                f"P23 eval {preset}: rank {r} ran {len(rep['rows'])} "
                f"batches, launches {rep['launches']} (need {need} and "
                f"nothing else)")
        for j, (rec, got) in enumerate(zip(seen, rep["rows"])):
            lo, hi = r * per, (r + 1) * per
            want = _np_out(rec["out"])
            beyond = False
            for i in range(per):
                ok, db, ds, fl = rows_match(
                    (got[0][i], got[1][i]),
                    (want[0][lo + i], want[1][lo + i]), PAIR_PATH_TOL)
                d_box, d_score = max(d_box, db), max(d_score, ds)
                flips += fl
                beyond |= not ok
            if beyond and preset != "f32":
                anchors += slice_flips(torch, cuda_lib, rec, lo, hi, got,
                                       PAIR_PATH_TOL)
            elif beyond:
                raise AssertionError(f"P23 eval f32: rank {r} batch {j} "
                                     f"beyond PAIR_PATH_TOL")
    if preset == "f32" and abs(m_ap - m_one) > PAR_EVAL_MAP_TOL:
        raise AssertionError(f"P23 eval f32: mAP {m_ap} over {PAR_RANKS} "
                             f"ranks, {m_one} in one process")
    return {"mAP": m_ap, "one_process_mAP": m_one, "wall_s": wall,
            "batches_a_rank": n_b, "images_a_rank_a_batch": per,
            "launches_a_rank": [
                {k: v for k, v in rep["launches"].items() if v}
                for rep in probe.reports],
            "against_one_process": {"max_box_diff": d_box,
                                    "max_score_diff": d_score,
                                    "rows_on_one_side": flips,
                                    "nms_anchors_on_one_side": anchors},
            "launches_total": _total(rep["launches"]
                                     for rep in probe.reports)}


def _train_part(torch, tcli, tmp, dev):
    """P23(b): ``cli.train.main`` at dp 2 x mp 2 against one process."""
    from millieye_torch.io.checkpoint import leaf_items
    from millieye_torch.train.optim import STAGE3_FROZEN, label_tree
    one = ParTrainProbe()
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        trainer = tcli.main(PAR_TRAIN_ARGS + ["--device", dev,
                                              "--checkpoint_dir",
                                              f"{tmp}/one"], probe=one)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = tcli.main(PAR_TRAIN_ARGS + PAR_MESH_ARGS + [
            "--device", dev, "--checkpoint_dir", f"{tmp}/mesh"],
            probe=ParTrainProbe(f"{tmp}/sharded"),
            timeout=PAR_WORLD_TIMEOUT)
        wall = time.perf_counter() - t0
    steps = PAR_TRAIN_SCENES // 8
    reps = [o["report"] for o in out]
    for r, rep in enumerate(reps):
        bad = [s for s in rep["launches"] if s != PAR_NEED["train"]]
        if len(rep["launches"]) != steps or bad or not rep["frozen_same"]:
            raise AssertionError(
                f"P23 train: rank {r}: launches a step {rep['launches']} "
                f"(want K4 and K1 once, {steps} steps), frozen leaves "
                f"unchanged {rep['frozen_same']}")
        for a, b in zip(rep["losses"], one.losses):
            if abs(a - b) > PAR_TRAIN_TOL["loss_rtol"] * abs(b):
                raise AssertionError(f"P23 train: rank {r} loss {a}, one "
                                     f"process {b}")
    for s in range(steps):
        if len({rep["digests"][s] for rep in reps}) != 1:
            raise AssertionError(f"P23 train: the replicated leaves differ "
                                 f"across ranks after step {s + 1}")
    with np.load(f"{tmp}/one/module3_ckpt_final.npz") as z1, \
            np.load(f"{tmp}/mesh/module3_ckpt_final.npz") as zm:
        keys = sorted(z1.files)
        if keys != sorted(zm.files):
            raise AssertionError("P23 train: checkpoint keys differ")
        labels = dict(leaf_items({"params": label_tree(
            trainer.ts.params, STAGE3_FROZEN)}))
        worst, worst_bn_fed, n_in, n_all = 0.0, 0.0, 0, 0
        for k in keys:
            a, b = z1[k].astype(np.float64), zm[k].astype(np.float64)
            name = k.split("|", 1)[1]
            d = np.abs(a - b)
            n_in += int((d <= 2e-5 + 2e-4 * np.abs(a)).sum())
            n_all += a.size
            if labels.get(name) == "freeze" or name.startswith(
                    "state/darknet/"):
                ok = bool((d == 0).all())
            elif name in PAR_BN_FED:
                ok = bool((d <= PAR_TRAIN_TOL["bn_fed_lr_a_step"] * steps
                           * TRAIN_LR).all())
                worst_bn_fed = max(worst_bn_fed, float(d.max()))
            elif name.startswith("params/"):
                ok = bool((d <= PAR_TRAIN_TOL["trained_lr"]
                           * TRAIN_LR).all())
                worst = max(worst, float(d.max()))
            else:
                ok = bool((d <= PAR_TRAIN_TOL["bn_rel"]
                           * max(np.abs(a).max(), 1e-12)).all())
            if not ok:
                raise AssertionError(f"P23 train: {name} of the mesh's "
                                     f"checkpoint beyond PAR_TRAIN_TOL "
                                     f"(largest {d.max()})")
    if n_in < PAR_TRAIN_TOL["share"] * n_all:
        raise AssertionError(f"P23 train: {n_all - n_in} of {n_all} "
                             f"checkpoint elements beyond the CPU "
                             f"contract (share {n_in / n_all})")
    sharded = _sharded_part(torch, tmp, out)
    return {"wall_s": wall, "sharded": sharded, "one_process_s": one_s,
            "steps": steps,
            "losses": reps[0]["losses"], "one_process_losses": one.losses,
            "launches_a_step_a_rank": reps[0]["launches"][0],
            "launches_total": _total(c for rep in reps
                                     for c in rep["launches"]),
            "max_trained_param_diff": worst,
            "max_trained_param_diff_lr": worst / TRAIN_LR,
            "max_bn_fed_bias_diff_lr": worst_bn_fed / TRAIN_LR,
            "max_loss_rdiff": max(abs(a - b) / abs(b) for rep in reps
                                  for a, b in zip(rep["losses"],
                                                  one.losses)),
            "share_within_cpu_contract": n_in / n_all}


def _sharded_part(torch, tmp, out):
    """P23(b)'s sharded checkpoint: the directory every rank wrote, read
    here by ``load_sharded``: its parameters and BN state bit-identical
    to the gathered ``.npz`` the CLI wrote, each rank's tensors to the
    loaded tree cut by ``parallel/mesh.py:_shard``'s rule (the parameters
    and optimizer slots; the BN state is replicated), and a leaf sliced
    over "model" whose two slices differ."""
    from millieye_torch import parallel
    from millieye_torch.io.checkpoint import (leaf_items, load_checkpoint,
                                              load_sharded)
    from millieye_torch.parallel.mesh import _shard
    t0 = time.perf_counter()
    got = load_sharded(f"{tmp}/sharded")
    load_s = time.perf_counter() - t0
    pair = {"params": got["params"], "state": got["state"]}
    if not same_tree(torch, pair, load_checkpoint(
            f"{tmp}/mesh/module3_ckpt_final.npz", pair)):
        raise AssertionError("P23 sharded: the loaded parameters and BN "
                             "state differ from the gathered .npz")
    mesh = parallel.make_mesh(PAR_RANKS, model_axis=2,
                              devices=["cpu"] * PAR_RANKS)
    tensors = [(k, x) for k, x in leaf_items(got)
               if isinstance(x, torch.Tensor)]
    sliced = set()
    for o in out:
        digests = o["report"]["sharded"]["digests"]
        if sorted(digests) != sorted(k for k, _ in tensors):
            raise AssertionError(f"P23 sharded: rank {o['rank']}'s leaves "
                                 f"are not the loaded tree's")
        for k, x in tensors:
            cut = (_shard(mesh, x, o["model"])
                   if k.split("/")[0] in ("params", "opt_state") else x)
            if _digest(torch, [cut]) != digests[k]:
                raise AssertionError(f"P23 sharded: {k} of the loaded tree, "
                                     f"cut for rank {o['rank']}, differs "
                                     f"from that rank's")
            if cut.shape != x.shape:
                sliced.add(k)
    full = dict(tensors)
    differ = sorted(k for k in sliced if not torch.equal(
        _shard(mesh, full[k], 0), _shard(mesh, full[k], 1)))
    if not differ:
        raise AssertionError(f"P23 sharded: no leaf sliced over 'model' "
                             f"whose slices differ ({sorted(sliced)})")
    return {"save_s_by_rank": [o["report"]["sharded"]["save_s"]
                               for o in out],
            "load_s": load_s,
            "dir_mb": path_bytes(f"{tmp}/sharded") / 2 ** 20,
            "tensors": len(tensors), "sliced": sorted(sliced),
            "sliced_differ": differ}


def parallel_phase(torch, cuda_lib, eng4, reqs, eval_keep, dev="cuda"):
    """P23: four ranks over gloo on the card, in four parts: (a) the
    evaluation over 4 ranks, (b) training at dp 2 x mp 2, (c) a sharded
    engine window, (d) ``entry.dryrun_multichip(4)``. Returns the
    summary."""
    import tempfile
    from millieye_torch.cli import evaluate
    from millieye_torch.cli import train as tcli
    from millieye_torch.entry import dryrun_multichip
    from millieye_torch.parallel import world
    summary = {"ranks": PAR_RANKS, "device_count": torch.cuda.device_count()}
    for preset in ("f32", "pallas_max_s01"):
        summary[f"eval@{preset}"] = _eval_part(
            torch, cuda_lib, evaluate, preset,
            eval_keep[f"fusion@{preset}"], dev)
    with tempfile.TemporaryDirectory() as tmp:
        summary["train"] = _train_part(torch, tcli, tmp, dev)
    t0 = time.perf_counter()
    out = world.launch(par_window_rank, PAR_RANKS, dev, (reqs,),
                       timeout=PAR_WORLD_TIMEOUT)
    wall = time.perf_counter() - t0
    step = eng4.batched_step_fn(0)
    per = N_REQUESTS // PAR_RANKS
    want_k = PAR_NEED["window"]
    for o in out:
        d = o["index"]
        tens = window_tensors(torch, eng4, reqs[d * per:(d + 1) * per], dev)
        want = [a.cpu().numpy() for a in step(*tens)]
        if not all(np.array_equal(a, b) for a, b in zip(o["rows"], want)):
            raise AssertionError(f"P23 window: rank {d}'s sub-window is not "
                                 f"bit-identical to batched_step_fn over "
                                 f"its frames in one process")
        got = {k: v for k, v in o["launches"].items() if v}
        if got != want_k:
            raise AssertionError(f"P23 window: rank {d} launches "
                                 f"{o['launches']}")
    summary["window@pallas_max4"] = {
        "wall_s": wall, "frames_a_rank": per,
        "rank_ms": [o["ms"] for o in out],
        "rank_build_s": [o["build_s"] for o in out],
        "rank_warm_up_s": [o["warm_s"] for o in out],
        "launches_a_rank": {k: v for k, v in out[0]["launches"].items()
                            if v},
        "launches_total": _total(o["launches"] for o in out)}
    t0 = time.perf_counter()
    dry = dryrun_multichip(PAR_RANKS, device=dev, timeout=PAR_WORLD_TIMEOUT)
    summary["dryrun_multichip"] = {"wall_s": time.perf_counter() - t0,
                                   "mesh": dry[0]["mesh"],
                                   "loss": dry[0]["loss"],
                                   "window_rows": dry[0]["window_rows"]}
    return summary


def darknet_forward(torch, defs, size, b=8):
    """One forward of the Darknet ``defs`` at ``size`` px, batch ``b``,
    float32 eval on the card from the seed-0 init, as the benchmark's
    ``d53-416-b8`` and ``yolov4-608-b8`` run them: so that a running
    ``ConvShapes`` holds the network's convolutions and the tails in
    K15's store. Raises unless the detections are finite."""
    from millieye_torch.models.darknet import Darknet
    dev = torch.device("cuda")
    model = Darknet(defs, img_size=size)
    params, state = model.init(torch.Generator().manual_seed(0))
    params = [{k: v.to(dev) for k, v in p.items()} for p in params]
    state = [{k: v.to(dev) for k, v in s.items()} for s in state]
    images = torch.rand((b, size, size, 3),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        det = model.apply(params, state, images)["detections"]
    if not bool(torch.isfinite(det).all()):
        raise AssertionError(f"Darknet forward at {size} px: detections "
                             f"not finite")
    del params, state, images, det
    torch.cuda.empty_cache()


def window_tensors(torch, engine, reqs, device="cuda"):
    """The requests as one window's tensors on the card."""
    packed = [engine.pack_radar(pts, props) for _, pts, props in reqs]
    return [torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(device)
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
    from millieye_torch.ops import (cuda_lib, epilogue, nms_kernel, quantize,
                                    roi_kernel, stem)
    from millieye_torch.ops import conv as kconv
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
        "conv_epilogue": (epilogue.conv_epilogue,
                          "millieye_torch/csrc/epilogue.cu",
                          "none (XLA fused this tail on the TPU)"),
        "conv2d_nhwc": (kconv.conv2d_nhwc, "millieye_torch/csrc/conv.cu",
                        "none (XLA ran these convolutions on the TPU)"),
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
    for b in (8, 32):     # the f32 engine's weights are folded, float32
        checks.stem_pair_f32(b, engines["f32"].params["darknet"])
    w12 = engines["f32"].params["darknet"][12]["w"]
    checks.quantize(w12)
    checks.epilogue()
    checks.conv()
    torch.cuda.empty_cache()
    recs = [r for rs in checks.records.values() for r in rs]
    bounded = [r for r in recs if r["tol"] is not None]
    log(f"kernel phase: {len(recs) - len(bounded)} cases bit-equal to their "
        f"plain versions, {len(bounded)} (the tensor-core kernels at "
        f"'default' within {stem.PAIR_DEFAULT_TOL:.3g}, K15 within 1e-5) of "
        f"their plain versions' largest output, at worst 2^"
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

    # every convolution K15 runs at from here to P22 is held to its plain
    # version after P22 (the paths keep K15 in their plain runs)
    conv_shapes = ConvShapes(kconv)
    conv_shapes.start()
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
        with cuda_lib.plain_versions(keep=K15):
            ref = call()
        same = (np.array_equal(boxes, ref[0])
                and np.array_equal(valid, ref[1]))
        if path not in tc_paths:
            if not same:
                raise AssertionError(
                    f"{path}: kernels and plain versions disagree\n"
                    f"{boxes[valid]}\n{ref[0][ref[1]]}")
            return same, 0.0, 0.0, 0, (0, 0)
        with cuda_lib.plain_versions(keep=tc_kernels + K15):
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
                "cuda_lib.plain_versions(keep=K15)")
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
        with cuda_lib.plain_versions(keep=K15):
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
    with cuda_lib.plain_versions(keep=tc_kernels + K15):
        krows, kvalid = step(*tens)
    if not (np.array_equal(wrows, krows.cpu().numpy())
            and np.array_equal(wvalid, kvalid.cpu().numpy())):
        raise AssertionError("batched window: differs from its run with only "
                             "the tensor-core kernels launched")
    with cuda_lib.plain_versions(keep=K15):
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
    with cuda_lib.plain_versions(keep=K15):
        prows, pvalid = (a.cpu().numpy() for a in fstep(*ftens))
    if not (np.array_equal(frows, prows) and np.array_equal(fvalid, pvalid)):
        raise AssertionError("f32 window: differs from the same window "
                             "inside cuda_lib.plain_versions(keep=K15)")
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
        f"the same window inside cuda_lib.plain_versions(keep=K15), its "
        f"post-merge NMS one K5 launch, bit-identical to it frame by frame; against the "
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
        with cuda_lib.plain_versions(keep=tc_kernels + K15):
            kr, kv = (a.cpu().numpy() for a in step(*tens))
        if not same_answer((wr, wv), (kr, kv)):
            raise AssertionError("stream windows: differ from the run with "
                                 "only the tensor-core kernels launched")
        with cuda_lib.plain_versions(keep=K15):
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

    # P17: the weights in every format, written from the tracked
    # checkpoint with the port's writers into a temporary directory,
    # each loaded on the host and served at pallas_max_s01 on P1's
    # requests; then cli.demo on P15's recording from disk
    import os
    from millieye_torch.cli import demo
    from millieye_torch.cli._common import load_fusion, load_weights_any
    from millieye_torch.io.torch_ckpt import load_ultralytics_pt
    t = time.time()
    wdir = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    model, ck_p, ck_s = build_fusion(CKPT, "pallas_max_s01", device="cpu")
    build_ms = (time.perf_counter() - t0) * 1e3     # the init + the load
    files = write_weight_files(torch, wdir.name, model, ck_p, ck_s)
    with np.load(CKPT) as z0, np.load(files["npz"]) as z1:
        if sorted(z0.files) != sorted(z1.files) or not all(
                z0[k].dtype == z1[k].dtype and z0[k].shape == z1[k].shape
                and z0[k].tobytes() == z1[k].tobytes() for k in z0.files):
            raise AssertionError("weights: save_checkpoint's .npz differs "
                                 "from the tracked checkpoint")
    # the sharded directory (the JAX package's save_orbax): written from
    # the tree's CUDA tensors (DCP imported first: its import is not the
    # save's), read back on the host by its loader below
    import torch.distributed.checkpoint  # noqa: F401
    from millieye_torch.io.checkpoint import (load_sharded, save_sharded,
                                              to_device)
    files["sharded"] = os.path.join(wdir.name, "fusion.sharded")
    on_card = to_device({"params": ck_p, "state": ck_s}, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_sharded(files["sharded"], on_card)
    sharded_save_ms = (time.perf_counter() - t0) * 1e3
    del on_card
    t0 = time.perf_counter()
    init_p, init_s = model.init(torch.Generator().manual_seed(0))
    init_ms = (time.perf_counter() - t0) * 1e3

    def with_darknet(tree):
        dp, ds = tree[:2]
        return dict(ck_p, darknet=dp), dict(ck_s, darknet=ds)

    loaders = {   # format -> (load, the tree it must give)
        "npz": (lambda: load_weights_any(model, init_p, init_s,
                                         files["npz"]), (ck_p, ck_s)),
        "weights": (lambda: load_fusion(model, ck_p, ck_s,
                                        files["weights"]), (ck_p, ck_s)),
        "pth": (lambda: load_weights_any(model, init_p, init_s,
                                         files["pth"]), (ck_p, ck_s)),
        "pt": (lambda: with_darknet(load_weights_any(
            model.darknet, init_p["darknet"], init_s["darknet"],
            files["pt"])), (ck_p, ck_s)),
        "pt positional": (lambda: with_darknet(load_ultralytics_pt(
            model.darknet, init_p["darknet"], init_s["darknet"],
            files["pt"])), (ck_p, ck_s)),
        "yolov3-tiny.conv.15": (lambda: load_fusion(
            model, init_p, init_s, files["tiny15"]), None),
        "sharded": (lambda: (lambda t: (t["params"], t["state"]))(
            load_sharded(files["sharded"])), (ck_p, ck_s))}
    loader_ms, weight_paths = {}, {}
    for fmt, (load, want) in loaders.items():
        t0 = time.perf_counter()
        lp, ls = load()
        loader_ms[fmt] = (time.perf_counter() - t0) * 1e3
        if want is None:     # blocks 0-14 the checkpoint's, the rest init
            want = (dict(init_p, darknet=ck_p["darknet"][:15]
                         + init_p["darknet"][15:]),
                    dict(init_s, darknet=ck_s["darknet"][:15]
                         + init_s["darknet"][15:]))
        if not same_tree(torch, (lp, ls), want):
            raise AssertionError(f"weights {fmt}: the loaded tree differs "
                                 f"from the one written")
        if fmt == "pt positional":
            continue                    # the same tree as "pt"
        path = f"weights {fmt}@pallas_max_s01"
        weight_paths[fmt] = path
        eng = engines[path] = FusionEngine(model, lp, ls, frame_size=FRAME)
        drive(path, infer_calls(eng), rows(eng),
              one(("nms", "ps_roi_align", "roi_align", "stem_pair",
                   "nms_full"), 1))
        if fmt != "yolov3-tiny.conv.15" and not all(
                same_answer(g, w) for g, w in zip(
                    answers_by_path[path], answers_by_path["pallas_max_s01"])):
            raise AssertionError(f"{path}: answers differ from P1's")
    calib_path = write_demo_inputs(rec, frames)
    demo_runs, saver = {}, demo._make_saver
    for name, w in (("pth", files["pth"]), ("npz", files["npz"]),
                    ("init", None)):
        got = {}
        # each delivered frame is caught where --save_dir's saver writes it
        demo._make_saver = lambda args, got=got: collect(got)
        zero_counts()
        t0 = time.time()
        try:
            report = demo.main(["--recording", rec, "--calib", calib_path,
                                "--serving", "pallas_max_s01", "--save_dir",
                                os.path.join(wdir.name, "demo")]
                               + (["--weights", w] if w else []))
        finally:
            demo._make_saver = saver
        launches = counts()
        launches_by_path[f"demo {name}@pallas_max_s01"] = launches
        # the demo runs live: a frame that finds the queue full is dropped
        short = {k: launches[k] for k in ("stem_pair", "nms", "ps_roi_align",
                                          "roi_align", "nms_full")
                 if launches[k] < len(got)}
        if report["frames"] + report["dropped"] != n_frames or len(
                got) != report["frames"] or not got or short:
            raise AssertionError(f"demo --weights {w}: {report['frames']} "
                                 f"frames + {report['dropped']} dropped, "
                                 f"kernels launched fewer times than "
                                 f"frames: {short}")
        if any(not np.isfinite(b).all() or b.shape != rows(engines[
                "pallas_max_s01"]) for b, _ in got.values()):
            raise AssertionError(f"demo --weights {w}: an answer is not "
                                 f"finite or of the wrong shape")
        demo_runs[name] = (got, report, time.time() - t0)
    both = sorted(set(demo_runs["pth"][0]) & set(demo_runs["npz"][0]))
    differ = [i for i in both if not same_answer(demo_runs["pth"][0][i],
                                                 demo_runs["npz"][0][i])]
    if not both or differ:
        raise AssertionError(f"demo: frames {differ} of the {len(both)} "
                             f"both runs delivered differ between --weights "
                             f".pth and .npz")
    file_bytes = {k: path_bytes(v) for k, v in files.items()}
    log(f"weights ({card}): save_checkpoint's .npz byte-equal to "
        f"{CKPT} under the same keys; save_sharded's directory written "
        f"from the card in {sharded_save_ms:.3f} host ms "
        f"({file_bytes['sharded'] / 2 ** 20:.3f} MB), read back by "
        f"load_sharded on the host; every format's tree equal to the "
        f"one written (yolov3-tiny.conv.15: blocks 0-14 the checkpoint's, "
        f"the rest FusionNetwork.init's); host ms the seed-0 init "
        f"{init_ms:.3f}, build_fusion of {CKPT} (that init, then the load) "
        f"{build_ms:.3f}, a load into the init "
        f"{ {k: round(v, 3) for k, v in loader_ms.items()} } (file sizes "
        f"{file_bytes} bytes); "
        f"{', '.join(p for f, p in weight_paths.items() if 'tiny' not in f)}"
        f": answers bit-identical to P1's; cli.demo on the recording "
        f"({n_frames} frames from disk, live: frames delivered "
        f"{ {k: r[1]['frames'] for k, r in demo_runs.items()} }, the rest "
        f"dropped): --weights .pth and .npz bit-identical on the "
        f"{len(both)} frames both delivered, e2e_fps "
        f"{ {k: r[1]['e2e_fps'] for k, r in demo_runs.items()} }, seconds "
        f"{ {k: round(r[2], 2) for k, r in demo_runs.items()} } (no "
        f"--weights: the seed-0 init); {time.time() - t:.1f} s")
    summary["weights"] = {
        "init_host_ms": init_ms, "build_fusion_npz_host_ms": build_ms,
        "loader_host_ms": loader_ms,
        "sharded_save_host_ms": sharded_save_ms,
        "file_bytes": file_bytes,
        "paths": weight_paths,
        "demo": {k: {"frames": r[1]["frames"], "dropped": r[1]["dropped"],
                     "e2e_fps": r[1]["e2e_fps"], "seconds": r[2]}
                 for k, r in demo_runs.items()},
        "demo_frames_compared": len(both)}

    # P18: the full YOLOv3 (Darknet-53) from a .cfg
    t = time.time()
    zero_counts()
    summary["yolov3"], stem_refusal, limits = yolov3_phase(
        torch, cuda_lib, wdir.name)
    launches_by_path["yolov3@f32"] = counts()
    y = summary["yolov3"]
    log(f"yolov3 ({card}): Darknet-53 from a .cfg ({y['blocks']} blocks, "
        f"{y['weights']} weights and statistics; a stem preset refused: "
        f"{stem_refusal!r}); Darknet.init on the card equal to the CPU's "
        f"moved there; forward b8 on the card, all 8 images held to the "
        f"CPU's forward (TF32 off): max errors {y['max_err_vs_cpu']} within {limits}; "
        f"batched_nms on 8 x 10647 detections (pre_top_k 512): K1 once, "
        f"bit-identical to its plain version, {y['nms_rows_kept_b8']} rows "
        f"kept over 8 images; device ms a forward {y['device_ms']} (ms, "
        f"profiler records), bound {y['bound_ms']} ({y['flops_per_image']} "
        f"flops an image, float32 at {F32_FLOP_S:.3g}/s); CPU "
        f"forward b8 {y['cpu_b8_ms']:.0f} ms (host clock); .weights round "
        f"trip of {y['weights_floats']} floats leaf for leaf (load "
        f"{y['weights_load_host_ms']:.0f} ms on the host), "
        f"darknet53.conv.74 the first 75 blocks; {time.time() - t:.1f} s")
    # P19: the evaluation path, cli.evaluate on the card
    t = time.time()
    eval_keep = dict.fromkeys(("fusion@f32", "fusion@pallas_max_s01"))
    summary["eval"], eval_launches = eval_phase(
        torch, cuda_lib, files["weights"], zero_counts, counts,
        keep=eval_keep)
    launches_by_path.update({f"eval {k}": {n: v.get(n, 0) for n in kernels}
                             for k, v in eval_launches.items()})
    log(f"eval phase ({card}): {time.time() - t:.1f} s")

    # P20: the export path, cli.export and the artifact in its own process
    t = time.time()
    summary["export"], export_launches = export_phase(
        torch, cuda_lib, engines, reqs, summary["pallas_max_s01"]["p50_ms"])
    launches_by_path.update({k: {n: v.get(n, 0) for n in kernels}
                             for k, v in export_launches.items()})
    log(f"export phase ({card}): {time.time() - t:.1f} s")

    # P21: the training path, cli.train on the card, four stages
    t = time.time()
    summary["train"], train_launches = train_phase(
        torch, cuda_lib, zero_counts, counts, card)
    launches_by_path.update({k: {n: v.get(n, 0) for n in kernels}
                             for k, v in train_launches.items()})
    log(f"train phase ({card}): {time.time() - t:.1f} s")

    # P22: the live path, cli.realtime in this process over P15's
    # recording (radar as a UART byte stream, camera as a capture of its
    # frames) on P15's engine; then cli.prepare_data on the recording
    t = time.time()
    eng = engines["pallas_max_s01"]
    live = live_phase(torch, eng, rec, frames, calib_path, counts=counts,
                      zero_counts=zero_counts)
    launches = live.pop("launches")
    launches_by_path["realtime@pallas_max_s01"] = launches
    stems = prepare_data_check(rec, calib_path,
                               os.path.join(wdir.name, "dataset"))
    live["prepare_data_stems"] = len(stems)
    summary["realtime@pallas_max_s01"] = live
    p = live["profiled"]
    log(f"P22 realtime@pallas_max_s01 ({card}): cli.realtime.main over "
        f"{live['frames']} frames of 640x480, the radar's {n_frames} "
        f"frames as a TI UART byte stream ({live['port_reads']} uneven "
        f"reads in the loop): the native parser answered every packet "
        f"({live['native_frames_stream']} of the whole stream, "
        f"{live['native_frames_loop']} in the loop, numpy none); each frame "
        f"bit-identical to FusionEngine.infer on the points it consumed "
        f"(points on {live['frames_with_points']} frames, proposals on "
        f"{live['frames_with_proposals']}); launches a frame "
        f"{live['launches_per_frame']} on every frame, the run's "
        f"{ {k: v for k, v in launches.items() if v} } (the warm-up's "
        f"included); host ms a frame {live['frame_host_ms_mean']:.3f} "
        f"(p50 {live['frame_host_ms_p50']:.3f}, max "
        f"{live['frame_host_ms_max']:.3f}), {live['frames_per_s']:.2f} "
        f"frames/s; profiled run of {p['frames']} frames: device busy "
        f"{p['device_busy_ms']:.2f} ms of {p['wall_ms']:.2f} ms wall "
        f"({100 * p['busy_share']:.1f}%); the radar thread stopped; "
        f"cli.prepare_data: {len(stems)} stems, every radar_point and "
        f"radar_box pickle equal to the in-process pipeline's; "
        f"{time.time() - t:.1f} s")
    wdir.cleanup()
    stream_dir.cleanup()

    # K15 against its plain version at every convolution the paths above
    # launched it at, and at Darknet-53's and YOLOv4's (the benchmark's
    # networks); each launch with a tail in its store against K15, then
    # K14, then the eager add
    from millieye_torch.models.zoo import yolov3_defs, yolov4_defs
    t = time.time()
    darknet_forward(torch, yolov3_defs(), 416)
    darknet_forward(torch, yolov4_defs(80, 608), 608)
    rows = checks.conv_paths(conv_shapes.stop())
    dims = [r[0] for r in rows]
    worst = max(rows, key=lambda r: r[2] / r[3])
    summary["k15_paths"] = [
        dict(dims=r[0], plain_err=r[1], err64=r[2:]) for r in rows]
    log(f"K15 at the paths' convolutions ({card}): {len(rows)} distinct "
        f"(batch, H, W, Cin, Cout, kh, kw, stride, pad) from P1-P22 and "
        f"the Darknet-53 and YOLOv4 forwards at b8: batches "
        f"{sorted({d[0] for d in dims})}, {sum(d[7] == 2 for d in dims)} "
        f"at stride 2, {sum(d[5] == 1 for d in dims)} 1x1, "
        f"{sum(d[4] % 4 != 0 for d in dims)} with Cout not a multiple of "
        f"4, {sum(d[3] % 4 != 0 for d in dims)} on the small-K route; "
        f"each within {K15_TOL} of its plain version's largest output (at "
        f"worst {max(r[1] for r in rows):.3g}) and against float64 at "
        f"worst {worst[2] / worst[3]:.3f} of cuDNN float32's error (at "
        f"{worst[0]}: K15 {worst[2]:.3g}, cuDNN {worst[3]:.3g}, the plain "
        f"product {worst[4]:.3g}); {time.time() - t:.1f} s")
    t = time.time()
    tails = sorted(conv_shapes.tails)
    summary["k15_tails"] = checks.conv_tail(tails)
    log(f"K15's store at the paths' tails ({card}): {len(tails)} distinct "
        f"launches with a tail (batches {sorted({d[0][0] for d in tails})}; "
        f"{sum(d[1] for d in tails)} batch norm + leaky, "
        f"{sum(not d[1] and d[2] == 1 for d in tails)} bias + leaky, "
        f"{sum(not d[1] and d[2] == 0 for d in tails)} bias + linear; "
        f"{sum(d[3] for d in tails)} with the add, "
        f"{sum(d[0][4] % 4 != 0 for d in tails)} with Cout not a multiple "
        f"of 4, {sum(d[0][3] % 4 != 0 for d in tails)} on the small-K "
        f"route), each bit-equal to K15, then K14, then the eager add; "
        f"{time.time() - t:.1f} s")

    # P23: parallel/ on 4 gloo ranks sharing the card
    t = time.time()
    par = parallel_phase(torch, cuda_lib, engines["pallas_max4"], reqs,
                         eval_keep)
    eval_keep.clear()
    summary["parallel"] = par
    for part in ("eval@f32", "eval@pallas_max_s01", "train",
                 "window@pallas_max4"):
        tot = par[part].pop("launches_total")
        launches_by_path[f"parallel {part}"] = {n: tot.get(n, 0)
                                                for n in kernels}
    sh = par["train"]["sharded"]
    log(f"P23 parallel ({card}): {par['ranks']} gloo ranks on "
        f"{par['device_count']} card(s); eval (4 x 1 mesh, 2 images a rank "
        f"a batch): f32 mAP {par['eval@f32']['mAP']:.6f} (one process "
        f"{par['eval@f32']['one_process_mAP']:.6f}), pallas_max_s01 "
        f"{par['eval@pallas_max_s01']['against_one_process']}; train (dp 2 "
        f"x mp 2, --fold_frozen, {par['train']['steps']} steps): launches "
        f"a step a rank {par['train']['launches_a_step_a_rank']}, losses "
        f"{par['train']['losses']} (one process "
        f"{par['train']['one_process_losses']}), largest trained-parameter "
        f"difference {par['train']['max_trained_param_diff_lr']:.3g} lr "
        f"(the BN-fed biases "
        f"{par['train']['max_bn_fed_bias_diff_lr']:.3g} lr), largest loss "
        f"difference {par['train']['max_loss_rdiff']:.3g} relative, share "
        f"within the CPU contract "
        f"{par['train']['share_within_cpu_contract']:.6f}; the sharded "
        f"checkpoint: every rank's save_sharded "
        f"{[round(x, 3) for x in sh['save_s_by_rank']]} s, load_sharded "
        f"here {sh['load_s']:.3f} s ({sh['dir_mb']:.3f} MB, "
        f"{sh['tensors']} tensors, {len(sh['sliced'])} sliced over "
        f"'model', {len(sh['sliced_differ'])} of them with slices that "
        f"differ), the parameters and BN state bit-identical to the "
        f"gathered .npz, each rank's leaves to the loaded tree cut by the "
        f"shape rule; window "
        f"bit-identical on every rank; dryrun_multichip(4) "
        f"{par['dryrun_multichip']['mesh']}; {time.time() - t:.1f} s")
    print("parallel " + json.dumps({
        "ranks": par["ranks"], "card": card,
        "meshes": {"eval": {"data": PAR_RANKS, "model": 1},
                   "train": {"data": 2, "model": 2},
                   "window": {"data": PAR_RANKS, "model": 1},
                   "dryrun": par["dryrun_multichip"]["mesh"]},
        "launches_a_rank": {
            "eval@f32": par["eval@f32"]["launches_a_rank"],
            "eval@pallas_max_s01":
                par["eval@pallas_max_s01"]["launches_a_rank"],
            "train_a_step": par["train"]["launches_a_step_a_rank"],
            "window": par["window@pallas_max4"]["launches_a_rank"]},
        "wall_s": {"eval@f32": par["eval@f32"]["wall_s"],
                   "eval@pallas_max_s01": par["eval@pallas_max_s01"]["wall_s"],
                   "train": par["train"]["wall_s"],
                   "train_sharded_save_by_rank": sh["save_s_by_rank"],
                   "train_sharded_load": sh["load_s"],
                   "train_one_process": par["train"]["one_process_s"],
                   "window": par["window@pallas_max4"]["wall_s"],
                   "dryrun": par["dryrun_multichip"]["wall_s"],
                   "phase": time.time() - t},
        "sharded": {"dir_mb": sh["dir_mb"], "tensors": sh["tensors"],
                    "sliced": len(sh["sliced"]),
                    "sliced_differ": len(sh["sliced_differ"])},
        "deviations": {
            "eval@f32_mAP": abs(par["eval@f32"]["mAP"]
                                - par["eval@f32"]["one_process_mAP"]),
            "eval@f32": par["eval@f32"]["against_one_process"],
            "eval@pallas_max_s01":
                par["eval@pallas_max_s01"]["against_one_process"],
            "train_max_param": par["train"]["max_trained_param_diff"],
            "train_max_param_lr": par["train"]["max_trained_param_diff_lr"],
            "train_max_bn_fed_bias_lr":
                par["train"]["max_bn_fed_bias_diff_lr"],
            "train_max_loss_rdiff": par["train"]["max_loss_rdiff"],
            "train_share_within_cpu_contract":
                par["train"]["share_within_cpu_contract"]}}), flush=True)

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
