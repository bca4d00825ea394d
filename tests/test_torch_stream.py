"""The port's streaming runtime on the CPU: ``StreamingPipeline`` (the
lossless and live modes of ``run``, ``run_batched`` host-fed and
``staged``), ``StageTimer`` and the trace hooks, ``cli.demo.main`` on a
written recording, and parity with the JAX package's
``StreamingPipeline`` on the same recording and weights.

The engine is tests/test_runtime.py's: the JAX ``FusionNetwork`` at
S = 128 initialised with ``PRNGKey(0)``, its arrays handed to the port
through ``io.checkpoint.convert``. Tolerances: against the JAX package,
valid masks equal and rows within tests/test_torch_fusion.py's
``TOL["f32"]`` (float32 summation order: 1e-4 on scores, 1e-3 px on
boxes), rows matched by box; the batched window against the per-frame
step, tests/test_runtime.py's contract (valid equal, rtol and atol 1e-4).
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from millieye_torch.cli import demo
from millieye_torch.cli._common import build_fusion
from millieye_torch.collection.prepare import iter_frames
from millieye_torch.radar.pipeline import RadarParams
from millieye_torch.radar.projection import load_calib
from millieye_torch.runtime.engine import FusionEngine
from millieye_torch.runtime.profiler import (StageTimer, device_trace,
                                             trace_annotation)
from millieye_torch.runtime.stream import StreamingPipeline
from millieye_tpu.models import Darknet, tiny_yolov3_defs
from millieye_tpu.models.fusion import FusionConfig, FusionNetwork
from millieye_tpu.radar.pipeline import RadarParams as JaxRadarParams
from millieye_tpu.runtime.engine import FusionEngine as JaxEngine
from millieye_tpu.runtime.stream import StreamingPipeline as JaxPipeline

torch.set_num_threads(1)

S = 128
FRAME = (64, 48)        # (w, h)
CFG = dict(conf_thresh=0.05, max_det=16, max_radar=4, pre_nms_top_k=64)
CALIB = np.array([40.0, 32.0, 40.0, 24.0,   # fx cx fy cy
                  0, 0, 0, 0, 0,            # no distortion
                  0, 0, 0], np.float64)     # no translation
TOL_F32 = dict(score=1e-4, box=1e-3)
CKPT = "artifacts/stage3_final.npz"
PARAMS = dict(frame_size=FRAME, num_pts_filter=1, min_hits=1,
              min_velocity=0.0)


@pytest.fixture(scope="module")
def jax_model():
    darknet = Darknet(tiny_yolov3_defs(num_classes=12, img_size=S),
                      img_size=S)
    model = FusionNetwork(darknet, FusionConfig(**CFG))
    params, state = model.init(jax.random.PRNGKey(0))
    return model, params, state


@pytest.fixture(scope="module")
def engine(jax_model):
    _, params, state = jax_model
    weights = jax.tree.map(np.asarray, (params, state))
    model, p, s = build_fusion(weights, "f32", img_size=S, device="cpu",
                               **CFG)
    return FusionEngine(model, p, s, frame_size=FRAME, max_points=32,
                        device="cpu")


def _write_recording(root, n_frames=4):
    """tests/test_runtime.py's recording: frames, timestamps.txt and
    pointcloud.pkl at 20 fps, six random radar points a frame."""
    from PIL import Image
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    rng = np.random.default_rng(1)
    with open(os.path.join(root, "timestamps.txt"), "w") as f:
        for i in range(n_frames):
            f.write(f"{100.0 + 0.05 * i} {i}\n")
    for i in range(n_frames):
        img = (rng.uniform(size=(FRAME[1], FRAME[0], 3)) * 255).astype(
            np.uint8)
        Image.fromarray(img).save(
            os.path.join(root, "frames", f"{i:06d}.jpg"))
    records = []
    for i in range(n_frames):
        n = 6
        records.append({
            "Data": {"numObj": n,
                     "x": rng.uniform(-0.5, 0.5, n),
                     "y": rng.uniform(1.0, 3.0, n),     # forward depth
                     "z": rng.uniform(-0.2, 0.2, n),
                     "velocity": rng.uniform(-1, 1, n)},
            "Time": 100.0 + 0.05 * i, "Frame_ID": i})
    with open(os.path.join(root, "pointcloud.pkl"), "wb") as f:
        pickle.dump(records, f)


def _collect(store):
    return lambda i, b, v: store.update({i: (b, v)})


def _window_contract(got, want):
    """tests/test_runtime.py:147-150."""
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(got[i][1], want[i][1])
        np.testing.assert_allclose(got[i][0], want[i][0], rtol=1e-4,
                                   atol=1e-4)


def test_run_lossless_yields_every_frame_in_order(engine, tmp_path):
    rec = str(tmp_path / "rec")
    _write_recording(rec)
    pipe = StreamingPipeline(engine, rec, CALIB, RadarParams(**PARAMS),
                             mode=0, drop_on_full=False)
    results = []
    n, report = pipe.run(on_result=lambda i, b, v: results.append(i))
    assert n == 4 and pipe.dropped == 0 and report["dropped"] == 0
    assert report["e2e_fps"] > 0 and {"track", "device"} <= report.keys()
    assert results == [0, 1, 2, 3]


def test_run_live_mode(engine, tmp_path):
    """drop_on_full=True: the producer never waits, so a slow consumer
    loses frames; every frame is delivered or counted as dropped, and a
    delivered frame's answer is the lossless one (the tracker saw every
    frame either way)."""
    rec = str(tmp_path / "rec")
    _write_recording(rec, n_frames=10)
    want = {}
    StreamingPipeline(engine, rec, CALIB, RadarParams(**PARAMS),
                      drop_on_full=False).run(on_result=_collect(want))
    pipe = StreamingPipeline(engine, rec, CALIB, RadarParams(**PARAMS),
                             queue_size=1, drop_on_full=True)
    got = {}
    n, report = pipe.run(on_result=_collect(got))
    assert n + pipe.dropped == 10 and report["dropped"] == pipe.dropped
    assert n == len(got) >= 1
    for i, (b, v) in got.items():
        np.testing.assert_array_equal(b, want[i][0])
        np.testing.assert_array_equal(v, want[i][1])


@pytest.mark.parametrize("max_frames", [None, 2])
def test_run_batched_matches_per_frame(engine, tmp_path, max_frames):
    rec = str(tmp_path / "rec")
    _write_recording(rec, n_frames=5)
    pipe = StreamingPipeline(engine, rec, CALIB, RadarParams(**PARAMS))
    got = {}
    n, report = pipe.run_batched(window=3, on_result=_collect(got),
                                 max_frames=max_frames)
    assert report["dropped"] == 0 and report["window"] == 3
    want = {}
    StreamingPipeline(engine, rec, CALIB, RadarParams(**PARAMS),
                      drop_on_full=False).run(on_result=_collect(want),
                                              max_frames=max_frames)
    assert n == len(want) == (max_frames or 5)
    _window_contract(got, want)


def test_run_batched_rejects_auto_mode(engine, tmp_path):
    rec = str(tmp_path / "rec")
    _write_recording(rec, n_frames=2)
    pipe = StreamingPipeline(engine, rec, CALIB,
                             RadarParams(frame_size=FRAME), mode=3)
    with pytest.raises(ValueError, match="auto mode"):
        pipe.run_batched(window=2)


def test_run_batched_staged_equals_host_fed(engine, tmp_path):
    rec = str(tmp_path / "rec")
    _write_recording(rec, n_frames=4)
    ref = {}
    StreamingPipeline(engine, rec, CALIB, RadarParams(
        **PARAMS)).run_batched(window=2, on_result=_collect(ref))
    # the producer's items, run synchronously into a queue that holds all
    pipe2 = StreamingPipeline(engine, rec, CALIB, RadarParams(**PARAMS),
                              queue_size=16)
    pipe2._produce(device_stage=False, drop_on_full=False)
    items = []
    while (it := pipe2.q.get()) is not None:
        items.append(it)
    staged = []
    for lo in range(0, len(items), 2):
        chunk = items[lo:lo + 2]
        arrays = [np.stack([np.ascontiguousarray(c[1]) for c in chunk])] + [
            np.stack([c[2][j] for c in chunk]) for j in range(4)]
        staged.append(([c[0] for c in chunk],
                       tuple(torch.from_numpy(a) for a in arrays)))
    got = {}
    n, report = StreamingPipeline(engine, rec, CALIB, RadarParams(
        **PARAMS)).run_batched(window=2, staged=staged,
                               on_result=_collect(got))
    assert n == 4 and report["device_resident"]
    _window_contract(got, ref)
    for i in ref:
        np.testing.assert_array_equal(got[i][0], ref[i][0])


def _match_rows(got, want, tol):
    """Valid masks equal; each valid row matched to the nearest valid
    reference row by box."""
    np.testing.assert_array_equal(got[1], want[1])
    g, w = got[0][got[1]], want[0][want[1]]
    if not len(w):
        return
    match = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1).argmin(1)
    assert sorted(match) == list(range(len(w)))
    np.testing.assert_allclose(g[:, :4], w[match, :4], rtol=0,
                               atol=tol["box"])
    np.testing.assert_allclose(g[:, 4:], w[match, 4:], rtol=0,
                               atol=tol["score"])


def test_stream_matches_jax(jax_model, engine, tmp_path):
    """The JAX package's StreamingPipeline and the port's on the same
    recording and weights, lossless, frame by frame."""
    rec = str(tmp_path / "rec")
    _write_recording(rec, n_frames=6)
    jeng = JaxEngine(*jax_model, frame_size=FRAME, max_points=32)
    want, got = {}, {}
    JaxPipeline(jeng, rec, CALIB, JaxRadarParams(**PARAMS),
                drop_on_full=False).run(on_result=_collect(want))
    n, _ = StreamingPipeline(engine, rec, CALIB, RadarParams(**PARAMS),
                             drop_on_full=False).run(on_result=_collect(got))
    assert n == 6 and sorted(got) == sorted(want)
    assert sum(int(v.sum()) for _, v in got.values()) > 0
    for i in want:
        _match_rows(got[i], want[i], TOL_F32)


def test_stage_timer_and_trace_hooks(tmp_path):
    t = StageTimer(("a",))
    with t("a"):
        pass
    assert t.fps("a") > 0 and "a" in t.report()
    # the body's own error comes through the annotation as it is
    with pytest.raises(KeyError, match="body"):
        with trace_annotation("span"):
            raise KeyError("body")
    with device_trace(str(tmp_path / "trace")):
        with trace_annotation("span"):
            torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_demo_main(tmp_path, capsys):
    import yaml
    rec = str(tmp_path / "rec")
    _write_recording(rec, n_frames=4)
    calib = tmp_path / "calib.yaml"
    calib.write_text(yaml.safe_dump({
        "camera_matrix": {"data": [40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1]},
        "distortion_coefficients": {"data": [0.0] * 5}}))
    out = tmp_path / "out"
    report = demo.main([
        "--recording", rec, "--calib", str(calib),
        "--weights", "artifacts/stage3_final.npz", "--device", "cpu",
        "--img_size", str(S), "--frame_w", str(FRAME[0]), "--frame_h",
        str(FRAME[1]), "--max_frames", "2", "--save_dir", str(out)])
    assert report["frames"] == 2 and report["e2e_fps"] > 0
    assert "frames: 2" in capsys.readouterr().out
    saved = sorted(os.listdir(out))
    assert len(saved) == 2
    frames = dict(iter_frames(rec))
    for name in saved:          # each an annotated frame of the recording
        from PIL import Image
        img = np.asarray(Image.open(out / name))
        assert img.shape == frames[int(name[:6])].shape


def _demo_inputs(tmp_path):
    """A 4-frame recording and its camera YAML, and a ``--save_dir``
    (whose saver ``_demo_answers`` replaces)."""
    import yaml
    rec = str(tmp_path / "rec")
    _write_recording(rec, n_frames=4)
    calib = tmp_path / "calib.yaml"
    calib.write_text(yaml.safe_dump({
        "camera_matrix": {"data": [40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1]},
        "distortion_coefficients": {"data": [0.0] * 5}}))
    return ["--recording", rec, "--calib", str(calib), "--img_size", str(S),
            "--frame_w", str(FRAME[0]), "--frame_h", str(FRAME[1]),
            "--save_dir", str(tmp_path / "out")]


def _demo_answers(monkeypatch, module, argv):
    """The frames ``module.main(argv)`` delivers, caught where its
    ``--save_dir`` saver would write them."""
    got = {}
    monkeypatch.setattr(module, "_make_saver", lambda args: _collect(got))
    module.main(argv)
    assert got                          # the demo runs live: frames that
    return got                          # find its queue full are dropped


def _lossless(weights, argv):
    """The demo's network (``build_fusion`` of ``weights``, the demo's
    ``refine_threshold_radar``) over the whole recording, lossless: the
    answer every frame a live run delivers must give."""
    model, p, s = build_fusion(weights, "f32", img_size=S, device="cpu",
                               refine_threshold_radar=0.56)
    eng = FusionEngine(model, p, s, frame_size=FRAME, device="cpu")
    want = {}
    StreamingPipeline(eng, argv[1], load_calib(argv[3]),
                      RadarParams(frame_size=FRAME), drop_on_full=False).run(
        on_result=_collect(want))
    assert sorted(want) == [0, 1, 2, 3]
    return want


def _same_frames(got, want):
    for i in got:
        np.testing.assert_array_equal(got[i][0], want[i][0])
        np.testing.assert_array_equal(got[i][1], want[i][1])


def _weight_files(tmp_path):
    """The tracked checkpoint at S as chip_smoke.py writes it, plus its
    module3 state dict as a ``.pt``."""
    import shutil
    import chip_smoke as cs
    model, p, s = build_fusion(CKPT, "f32", img_size=S, device="cpu")
    files = cs.write_weight_files(torch, str(tmp_path), model, p, s)
    files["module3.pt"] = str(tmp_path / "module3.pt")
    shutil.copy(files["pth"], files["module3.pt"])
    return model, files


@pytest.mark.parametrize("weights", [None, "w.pt", "w.pth", "w.weights"])
def test_demo_needs_npz_weights(tmp_path, monkeypatch, weights):
    """The demo takes every format the JAX demo takes, and none: a
    module3 state dict as ``.pt`` or ``.pth`` and a darknet ``.weights``
    (each written from the tracked checkpoint), and no ``--weights`` (the
    seed-0 init). It runs live, dropping frames that find its queue
    full: each frame it delivers is bit-identical to the lossless run of
    ``build_fusion`` of that file (or init) over the recording. (The name
    is kept from when the demo refused these cases, so that the test's
    record stays continuous; it now checks that none is refused.)"""
    argv = _demo_inputs(tmp_path) + ["--device", "cpu", "--max_frames", "2"]
    path = None
    if weights:
        _, files = _weight_files(tmp_path)
        path = str(tmp_path / weights)
        os.replace(files["pth" if weights.endswith((".pt", ".pth"))
                         else "weights"], path)
        argv += ["--weights", path]
    got = _demo_answers(monkeypatch, demo, argv)
    assert len(got) <= 2
    _same_frames(got, _lossless(path, argv))


def test_demo_matches_jax_on_each_format(tmp_path, monkeypatch):
    """The port's demo on the tracked checkpoint as .npz, .pth and .pt
    (one tree) and on a darknet .weights (the checkpoint's backbone over
    the seed-0 init), each frame it delivers bit-identical to the
    lossless run of its tree; the JAX package's demo on the .npz, and on
    a .npz of the .weights tree written by the port's
    ``save_checkpoint`` (the JAX package's ``_load_fusion`` unpacks
    ``load_darknet_weights``' header into its pair and raises on a
    .weights file), each frame it delivers within TOL_F32 of the same
    lossless run, rows matched by box. Both demos run live, so each is
    held to the lossless run, not to the other's frames."""
    import millieye_tpu.cli.demo as jdemo
    from millieye_torch.cli._common import load_fusion
    from millieye_torch.io.checkpoint import save_checkpoint
    argv = _demo_inputs(tmp_path) + ["--max_frames", "3"]
    model, files = _weight_files(tmp_path)
    init = build_fusion(None, "f32", img_size=S, device="cpu")
    tree = load_fusion(model, init[1], init[2], files["weights"])
    files["from_weights.npz"] = str(tmp_path / "from_weights.npz")
    save_checkpoint(files["from_weights.npz"],
                    {"params": tree[0], "state": tree[1]})
    want = {"npz": _lossless(files["npz"], argv),
            "from_weights.npz": _lossless(files["from_weights.npz"], argv)}
    assert sum(int(v.sum()) for _, v in want["npz"].values()) > 0
    for f, tree_of in (("npz", "npz"), ("pth", "npz"), ("module3.pt", "npz"),
                       ("weights", "from_weights.npz")):
        _same_frames(_demo_answers(monkeypatch, demo, argv + [
            "--device", "cpu", "--weights", files[f]]), want[tree_of])
    for f in ("npz", "from_weights.npz"):
        store = _demo_answers(monkeypatch, jdemo,
                              argv + ["--weights", files[f]])
        for i in store:
            _match_rows(want[f][i], tuple(map(np.asarray, store[i])),
                        TOL_F32)


def test_chip_smoke_session(jax_model, tmp_path):
    """chip_smoke.py's recorded session and its P15 check on the CPU at
    S = 128: the tracker's proposals on most frames and a cloud past
    ``max_points`` over the 96 frames, and the lossless stream of the
    first 24 equal to ``FusionEngine.infer`` fed by a second
    ``RadarPipeline``."""
    import chip_smoke as cs
    rec = str(tmp_path)
    frames = cs.write_recording(rec)
    assert len(frames) == 96 and frames[0][1].shape == (480, 640, 3)
    weights = jax.tree.map(np.asarray, jax_model[1:])
    model, p, s = build_fusion(weights, "f32", img_size=S, device="cpu",
                               **CFG)
    eng = FusionEngine(model, p, s, device="cpu")
    params = RadarParams()
    replay, host_ms = cs.radar_replay(rec, eng, params)
    assert len(replay) == len(host_ms) == 96
    assert sum(len(props) > 0 for _, props in replay) >= 48
    assert max(len(pts) for pts, _ in replay) > eng.max_points
    got = {}
    n, _ = StreamingPipeline(eng, rec, cs.STREAM_CALIB, params,
                             frames=frames[:24], drop_on_full=False).run(
        on_result=_collect(got))
    assert n == 24
    for (i, f), r in zip(frames[:24], replay):
        assert cs.same_answer(got[i], eng.infer(f, *r))
