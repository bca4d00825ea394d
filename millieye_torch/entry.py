"""The flagship forward as one callable (port of the JAX package's
``__graft_entry__.py:entry``).

``entry()`` returns ``(fn, example_args)``: ``fn(params, state, images,
radar_maps, radar_boxes, radar_mask) -> (boxes [1, 232, 7], valid
[1, 232])`` is the full fusion forward at batch 1 and 416 px (backbone ->
YOLO decode -> NMS -> score maps -> RoI crops -> refinement and ensemble
heads), float32, BN folded, NMS over the top 512 candidates through the
whole-matrix kernel K5 (``nms_use_blocked=False``), ``max_det`` 200 and 32
radar rows. Weights are arguments of ``fn``, as in the JAX package; they
come from the trained ``artifacts/stage3_final.npz`` (the JAX entry drew
random ones). The example inputs are that entry's: ``default_rng(0)``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from millieye_torch.cli._common import build_fusion
from millieye_torch.runtime.engine import fold_for_serving

CKPT = Path(__file__).resolve().parents[1] / "artifacts" / "stage3_final.npz"


def entry(device="cuda", img_size=416):
    """(fn, example_args) on ``device``, with the weights of the tracked
    stage-3 checkpoint."""
    s = img_size
    model, params, state = build_fusion(
        str(CKPT), "f32", img_size=s, device=device, max_det=200,
        max_radar=32, pre_nms_top_k=512, nms_use_blocked=False)
    params, state = fold_for_serving(model, params, state)

    @torch.no_grad()
    def fn(params, state, images, radar_maps, radar_boxes, radar_mask):
        out = model.apply(params, state, images, radar_maps, radar_boxes,
                          radar_mask, mode=0)
        return out["boxes"], out["valid"]

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(1, s, s, 3)).astype(np.float32)
    maps = rng.uniform(size=(1, s // 16, s // 16, 3)).astype(np.float32)
    rb = np.zeros((1, 32, 4), np.float32)
    rb[..., :2] = rng.uniform(0.1, 0.5, size=(1, 32, 2))
    rb[..., 2:] = rb[..., :2] + 0.2
    rmask = np.ones((1, 32), bool)
    dev = next(iter(params["ensemble"]["fc1"].values())).device
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (images, maps, rb, rmask))
    return fn, (params, state) + args


def dryrun_multichip(n_devices, device="cpu", timeout=600.0):
    """The multi-rank validation path (the JAX package's
    ``__graft_entry__.py:dryrun_multichip``), step for step, in a world of
    ``n_devices`` gloo ranks (``parallel/world.py``) on ``device``: a
    mesh with a "model" axis of 2 when ``n_devices`` is even; one sharded
    stage-3 train step at 128 px (finite loss); one sharded evaluation
    batch equal to the one-process evaluation of the same batch (rtol
    1e-5, atol 1e-6); one ``FusionEngine.batched_step_fn`` window sharded
    over "data"; and one step of the shard_map twin when the mesh is
    data-parallel only. The weights are the tracked stage-3 checkpoint's.
    Returns a dict for each rank; raises if a check fails in any rank."""
    from millieye_torch.parallel import world
    return world.launch(_dryrun_rank, n_devices, device, (n_devices,),
                        timeout=timeout)


def _dryrun_rank(rank, dev, n):
    from millieye_torch import parallel
    from millieye_torch.eval.harness import evaluate_fusion
    from millieye_torch.parallel import collectives as pc
    from millieye_torch.parallel import world
    from millieye_torch.parallel.mesh import gather_params
    from millieye_torch.parallel.shard_map_step import (
        make_shardmap_fusion_step)
    from millieye_torch.runtime.engine import FusionEngine
    from millieye_torch.train.optim import STAGE3_FROZEN, frozen_adam
    from millieye_torch.train.steps import (generator_draw, init_train_state,
                                            make_fusion_train_step)

    model_axis = 2 if n % 2 == 0 and n > 1 else 1
    mesh = parallel.make_mesh(n, model_axis=model_axis, devices=[
        str(world.rank_device(r, dev.type)) for r in range(n)])
    data_axis = n // model_axis
    s = 128
    model, params, state = build_fusion(
        str(CKPT), "f32", img_size=s, device=dev, max_det=16, max_radar=4,
        pre_nms_top_k=64, conf_thresh=0.05)
    tx = frozen_adam(params, lr=5e-4, frozen_prefixes=STAGE3_FROZEN,
                     every_k=2)
    ts = parallel.shard_train_state(mesh, init_train_state(params, state,
                                                           tx))

    b = 2 * data_axis
    rng = np.random.default_rng(0)
    rb = np.zeros((b, 4, 4), np.float32)
    rb[..., :2] = rng.uniform(0.1, 0.5, size=(b, 4, 2))
    rb[..., 2:] = rb[..., :2] + 0.3
    targets = np.zeros((b, 5, 5), np.float32)
    targets[..., 1:3] = rng.uniform(0.3, 0.7, size=(b, 5, 2))
    targets[..., 3:5] = rng.uniform(0.1, 0.2, size=(b, 5, 2))
    host = {
        "images": rng.uniform(size=(b, s, s, 3)).astype(np.float32),
        "radar_maps": rng.uniform(size=(b, s // 16, s // 16, 3)).astype(
            np.float32),
        "radar_boxes": rb, "rmask": np.ones((b, 4), bool),
        "targets": targets, "tmask": np.ones((b, 5), bool)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    batch["host"] = {k: host[k] for k in ("targets", "tmask")}

    step = parallel.sharded_step(make_fusion_train_step(
        model, tx, frozen_prefixes=STAGE3_FROZEN), mesh)
    draw = generator_draw(torch.Generator(device=dev).manual_seed(1))
    ts, metrics = step(ts, parallel.shard_batch(mesh, batch), draw)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss

    # one sharded EVAL batch (params replicated, the batch split over
    # "data") equal to the one-process evaluation of the same batch
    res_mesh = evaluate_fusion(model, ts.params, ts.state, [batch], mode=0,
                               mesh=mesh)
    with torch.no_grad(), mesh.active():
        full = gather_params(mesh, ts.params)
    res_one = evaluate_fusion(model, full, ts.state, [batch], mode=0)
    assert (res_mesh is None) == (res_one is None), (res_mesh, res_one)
    if res_mesh is not None:
        for a, b_ in zip(res_mesh[:5], res_one[:5]):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b_, np.float64),
                                       rtol=1e-5, atol=1e-6)

    # one streaming-engine window sharded over "data" (weights replicated)
    eng = FusionEngine(model, full, ts.state, frame_size=(2 * s, s),
                       max_points=32, device=dev)
    frames = rng.uniform(0, 255, (b, s, 2 * s, 3)).astype(np.uint8)
    pts = rng.uniform(0, 1, (b, 32, 4)).astype(np.float32)
    pts[..., 0] *= 2 * s
    pts[..., 1] *= s
    win = parallel.shard_batch(mesh, {
        str(i): torch.from_numpy(a).to(dev) for i, a in enumerate(
            (frames, pts, np.ones((b, 32), bool), rb, np.ones((b, 4), bool)))})
    merged, mvalid = eng.batched_step_fn(mode=0)(*win.values())
    with mesh.active():
        merged = pc.data_gather(merged)
    assert merged.shape[0] == b, merged.shape

    out = {"rank": rank, "mesh": dict(mesh.shape), "loss": loss,
           "eval_equal": True, "window_rows": tuple(merged.shape)}
    # ... and one step of the shard_map twin on a data-parallel mesh
    if model_axis == 1:
        sm_step = make_shardmap_fusion_step(model, tx, mesh)
        _, m2 = sm_step(ts, parallel.shard_batch(mesh, batch), 2)
        out["twin_loss"] = float(m2["loss"])
        assert np.isfinite(out["twin_loss"]), out["twin_loss"]
    return out
