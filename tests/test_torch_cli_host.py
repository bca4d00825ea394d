"""The port's live CLI, ``cli.realtime``, on the CPU against the JAX
package's: its flags, its two missing-dependency messages, and its loop
run through the seams (a capture of recorded frames, a ``RadarReader``
over a replayed UART byte stream, a headless display, ``--device cpu``),
each frame's answer held to the JAX package's ``FusionEngine.infer`` on
the JAX ``RadarPipeline``'s output for the points that frame consumed;
and chip_smoke.py's P22 (``live_phase``) rehearsed on the CPU.

The network is the tracked checkpoint at S = 128 and the ``f32`` preset
(the CLI's), 640x480 frames from chip_smoke.py's recorded session.
Tolerance: tests/test_torch_stream.py's ``TOL_F32`` (float32 summation
order: 1e-4 on scores, 1e-3 px on boxes), valid masks equal, rows
matched by box. Which radar frames a camera frame sees depends on the
radar thread's timing, so the checks replay the points each frame
recorded, never an assumed interleaving.
"""
import io
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from millieye_torch.cli import realtime
from millieye_torch.cli._common import build_fusion
from millieye_torch.collection.uart import RadarReader
from millieye_torch.runtime.engine import FusionEngine
from millieye_tpu.cli import realtime as jax_realtime
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxNetwork
from millieye_tpu.radar.pipeline import RadarParams as JaxRadarParams
from millieye_tpu.radar.pipeline import RadarPipeline as JaxPipeline
from millieye_tpu.radar.projection import load_calib as jax_load_calib
from millieye_tpu.runtime.engine import FusionEngine as JaxEngine

torch.set_num_threads(1)

S = 128
CKPT = "artifacts/stage3_final.npz"
TOL_F32 = dict(score=1e-4, box=1e-3)
N_FRAMES = 10


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """chip_smoke.py's recorded session cut to N_FRAMES (RGB frames, the
    camera YAML, the radar .cfg) and the CLI's arguments for it."""
    rec = str(tmp_path_factory.mktemp("rec"))
    frames = cs.write_recording(rec, n_frames=N_FRAMES)
    calib = cs.write_demo_inputs(rec, frames)
    cfg = f"{rec}/radar.cfg"
    with open(cfg, "w") as f:
        f.write("\n".join(cs.LIVE_CFG) + "\n")
    argv = ["--calib", calib, "--cfg", cfg, "--weights", CKPT,
            "--img_size", str(S)]
    return rec, frames, calib, argv


def _run(session, argv_extra=(), display=None, **seams):
    """realtime.main through its seams over the session; returns (rc,
    each frame's record)."""
    rec, frames, _, argv = session
    stream, ends, _ = cs.radar_stream(rec)
    port = cs.SerialReplay(stream)
    shown = []
    rc = realtime.main(
        argv + ["--device", "cpu", *argv_extra],
        capture=cs.ReplayCapture(frames, port, ends),
        reader=RadarReader(argv[3], cli=io.BytesIO(), data=port),
        display=display or (lambda bgr, r: shown.append(r)), **seams)
    return rc, shown


def _radar_threads():
    return [t for t in threading.enumerate() if t.name == "realtime-radar"]


def test_parse_args_matches_jax(session):
    argv = session[3] + ["--mode", "3", "--camera", "2", "--frame_w", "320"]
    got, want = realtime.parse_args(argv), jax_realtime.parse_args(argv)
    assert vars(got) == dict(vars(want), device="cuda")
    assert realtime.parse_args(argv + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("hidden,reader", [("cv2", False), ("cv2", True),
                                           ("serial", False)])
def test_missing_dependency_messages_match_jax(session, monkeypatch, capsys,
                                               hidden, reader):
    """Without cv2 both CLIs print the cv2 message and return 1, a reader
    given or not (cv2 also draws the boxes); without pyserial, the
    pyserial message, unless a reader is given (tested by every run
    below, pyserial being absent here)."""
    monkeypatch.setitem(sys.modules, hidden, None)
    argv = session[3] + ["--device", "cpu"]
    seams = {"reader": object()} if reader else {}
    assert realtime.main(argv, **seams) == 1
    got = capsys.readouterr().out
    assert jax_realtime.main(session[3]) == 1
    assert got == capsys.readouterr().out
    assert hidden in got or (hidden == "serial" and "pyserial" in got)


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX package's realtime network: its build_fusion at S with the
    default FusionConfig, the tracked checkpoint loaded (into the
    eval_shape template, skipping the random init)."""
    darknet = JaxDarknet(jax_defs(num_classes=12, img_size=S), img_size=S)
    model = JaxNetwork(darknet, JaxConfig())
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    r = load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    params, state = jax.tree.map(jnp.asarray, (r["params"], r["state"]))
    return JaxEngine(model, params, state, frame_size=cs.FRAME)


def test_realtime_matches_jax(session, jax_engine):
    """The loop on the CPU (the engine built by main from --weights at
    f32): every frame shown, and each frame's answer within TOL_F32 of
    the JAX package's FusionEngine.infer on the JAX RadarPipeline's
    output for the points that frame consumed, in the loop's order; the
    radar thread stopped when main returned."""
    rc, shown = _run(session)
    assert rc == 0 and len(shown) == N_FRAMES and not _radar_threads()
    _, frames, calib, _ = session
    radar = JaxPipeline(jax_load_calib(calib),
                        JaxRadarParams(frame_size=cs.FRAME))
    for (_, f), got in zip(frames, shown):
        r = radar.process(got["pts"])
        want = tuple(map(np.asarray, jax_engine.infer(
            f, r["points_uvzv"], r["proposals"], 0)))
        _match_rows((got["boxes"], got["valid"]), want, TOL_F32)
    assert any(got["pts"].shape[1] for got in shown)
    assert sum(int(got["valid"].sum()) for got in shown) > 0


def _match_rows(got, want, tol):
    """tests/test_torch_stream.py's: valid masks equal; each valid row
    matched to the nearest valid reference row by box."""
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


def test_display_ends_the_loop_and_the_thread(session):
    """A true return from the display ends the loop, as the window's "q"
    does; the radar thread stops and the capture is released either way,
    and also when the display raises."""
    model, p, s = build_fusion(CKPT, "f32", img_size=S, device="cpu")
    eng = FusionEngine(model, p, s, frame_size=cs.FRAME, device="cpu")
    seen = []
    rc, _ = _run(session, display=lambda bgr, r: seen.append(r) or
                 len(seen) == 2, engine=eng)
    assert rc == 0 and len(seen) == 2 and not _radar_threads()

    def fail(bgr, r):
        raise KeyError("display")

    with pytest.raises(KeyError, match="display"):
        _run(session, display=fail, engine=eng)
    assert not _radar_threads()


def test_chip_smoke_live_phase(session):
    """chip_smoke.py's P22 on the CPU: live_phase at pallas_max_s01 (the
    kernels' plain versions) over the session, each frame bit-identical
    to FusionEngine.infer on the points it consumed, the native parser on
    every packet; no launch counts and no profile on the CPU."""
    rec, frames, calib, _ = session
    model, p, s = build_fusion(CKPT, "pallas_max_s01", img_size=S,
                               device="cpu")
    eng = FusionEngine(model, p, s, frame_size=cs.FRAME, device="cpu")
    out = cs.live_phase(torch, eng, rec, frames, calib, dev="cpu",
                        profile=False)
    assert out["frames"] == N_FRAMES and out["native_frames_stream"] == N_FRAMES
    assert out["frames_with_points"] > 0 and out["frames_per_s"] > 0
