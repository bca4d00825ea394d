"""The port's sensor toolkit on the CPU against the JAX package's:
``collection/uart.py`` (the cfg parser, both frame parsers, the reader),
``collection/recorder.py`` (the radar and camera processes and
``record``), ``collection/prepare.py:prepare_dataset`` and the host CLIs
``cli.prepare_data`` and ``cli.collect``, and the packages'
re-exports.

Everything here is numpy host code, so the port must equal the JAX
package exactly. The two frame parsers disagree with each other on a
frame with two type-1 TLVs (and on where a short TLV ends), so the
port's native parser is held to the JAX package's native parser, called
directly (it raises where the JAX assembler would fall back to numpy),
and the port's numpy parser to the JAX numpy parser.
"""
import ast
import importlib
import io
import multiprocessing as mp
import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import millieye_tpu.native as jax_native
from millieye_torch.cli import collect as collect_cli
from millieye_torch.cli import prepare_data as prepare_cli
from millieye_torch.collection import recorder
from millieye_torch.collection.prepare import prepare_dataset
from millieye_torch.collection.uart import (FrameAssembler, RadarReader,
                                            parse_radar_cfg)
from millieye_torch.radar.pipeline import RadarParams
from millieye_tpu.cli import prepare_data as jax_prepare_cli
from millieye_tpu.collection import recorder as jax_recorder
from millieye_tpu.collection.prepare import prepare_dataset as jax_prepare
from millieye_tpu.collection.uart import FrameAssembler as JaxAssembler
from millieye_tpu.collection.uart import RadarReader as JaxReader
from millieye_tpu.collection.uart import parse_radar_cfg as jax_parse_cfg
from millieye_tpu.radar.pipeline import RadarParams as JaxRadarParams

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MAGIC = bytes([2, 1, 4, 3, 6, 5, 8, 7])
CFG = ["% comment", "sensorStop",
       "profileCfg 0 60 7 3 24 0 0 166 1 256 12500 0 0 30",
       "frameCfg 0 2 16 0 55 1 0", "sensorStart"]


def _header(frame_no, total, num_obj, num_tlvs):
    return MAGIC + struct.pack("<IIIIIIII", 0x0A0B0C0D, total, 0x68430000,
                               frame_no, 12345, num_obj, num_tlvs, 0)


def _tlv(kind, payload):
    return struct.pack("<II", kind, len(payload)) + payload


def _frame(frame_no, points, tlvs=None, num_obj=None):
    """One TI demo-protocol packet (tests/test_collection.py's layout):
    a type-1 TLV of ``points``, or the TLVs given."""
    points = np.asarray(points, np.float32).reshape(-1, 4)
    if tlvs is None:
        tlvs = [_tlv(1, points.tobytes())]
    body = b"".join(tlvs)
    n = len(points) if num_obj is None else num_obj
    return _header(frame_no, 40 + len(body), n, len(tlvs)) + body


def _points(rng, n):
    return rng.normal(0, 2, (n, 4)).astype(np.float32)


def _chunks(stream, rng, most=97):
    cuts, i = [], 0
    while i < len(stream):
        k = int(rng.integers(1, most))
        cuts.append(stream[i:i + k])
        i += k
    return cuts


def _feed_all(fa, chunks):
    """Every frame and the leftover buffer after each chunk."""
    out = []
    for c in chunks:
        out.append((fa.feed(c), bytes(fa.buf)))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gf, gb), (wf, wb) in zip(got, want):
        assert gb == wb
        assert [f for f, _ in gf] == [f for f, _ in wf]
        for (_, g), (_, w) in zip(gf, wf):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def _jax_native_assembler(max_points):
    """The JAX assembler on the JAX package's native parser, with no
    numpy fallback."""
    fa = JaxAssembler(max_points=max_points, use_native=False)
    fa._native = jax_native.parse_mmwave_frame
    return fa


def _streams():
    """name -> (chunks, max_points)."""
    rng = np.random.default_rng(0)
    frames = [_frame(7 + i, _points(rng, int(rng.integers(0, 9))))
              for i in range(6)]
    stream = b"\xde\xad\x01" + b"".join(frames)
    out = {f"chunked{s}": (_chunks(stream, np.random.default_rng(s)), 1024)
           for s in range(3)}
    out["whole"] = ([stream], 1024)
    # the magic word of the second frame cut after its third byte
    cut = 3 + len(frames[0]) + 3
    out["split_magic"] = ([stream[:cut], stream[cut:]], 1024)
    pts = _points(rng, 1)
    out["unknown_tlv"] = ([_frame(1, pts, [_tlv(6, b"\x00" * 8),
                                           _tlv(1, pts.tobytes())])], 1024)
    good = _frame(3, _points(rng, 2))
    out["total_len_short"] = ([b"\x00" * 5 + _header(9, 20, 1, 1) + good],
                              1024)
    out["total_len_huge"] = ([_header(9, (1 << 20) + 1, 1, 1) + b"\x11" * 32
                              + good], 1024)
    out["truncated_tail"] = (_chunks(stream[:-13], np.random.default_rng(9)),
                             1024)
    out["over_max_points"] = ([_frame(4, _points(rng, 10))], 4)
    out["zero_points"] = ([_frame(5, np.zeros((0, 4))),
                           _frame(6, np.zeros((0, 4)), tlvs=[])], 1024)
    # num_obj points in each of two type-1 TLVs
    two = [_tlv(1, _points(rng, 2).tobytes()), _tlv(1, _points(rng, 2)
                                                     .tobytes())]
    out["two_point_tlvs"] = ([_frame(8, np.zeros((2, 4)), tlvs=two)], 1024)
    short = [_tlv(1, _points(rng, 2).tobytes()), _tlv(1, _points(rng, 5)
                                                       .tobytes())]
    out["short_tlv"] = ([_frame(2, np.zeros((5, 4)), tlvs=short)], 1024)
    out["garbage_only"] = ([bytes(range(200))], 1024)
    return out


STREAMS = _streams()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_frame_assembler_numpy_matches_jax_numpy(name):
    chunks, cap = STREAMS[name]
    _same(_feed_all(FrameAssembler(cap, use_native=False), chunks),
          _feed_all(JaxAssembler(cap, use_native=False), chunks))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_frame_assembler_native_matches_jax_native(name):
    chunks, cap = STREAMS[name]
    fa = FrameAssembler(cap)
    assert fa._native is not None
    FrameAssembler.backends.clear()
    got = _feed_all(fa, chunks)
    _same(got, _feed_all(_jax_native_assembler(cap), chunks))
    n = sum(len(f) for f, _ in got)
    assert FrameAssembler.backends == ({"native": n} if n else {})


def test_two_point_tlvs_the_parsers_disagree():
    """The native parser appends the second type-1 TLV's points, the
    numpy parser keeps the last TLV's: both kept as the reference has
    them."""
    chunks, cap = STREAMS["two_point_tlvs"]
    native = FrameAssembler(cap).feed(chunks[0])[0][1]
    numpy_ = FrameAssembler(cap, use_native=False).feed(chunks[0])[0][1]
    assert native.shape == (4, 4) and numpy_.shape == (2, 4)
    np.testing.assert_array_equal(native[2:], numpy_)


def test_backends_count_each_branch():
    stream = b"".join(_frame(i, np.ones((2, 4))) for i in range(3))
    FrameAssembler.backends.clear()
    assert len(FrameAssembler().feed(stream)) == 3
    assert len(FrameAssembler(use_native=False).feed(stream)) == 3
    assert FrameAssembler.backends == {"native": 3, "numpy": 3}


def _cfg(tmp_path, lines=CFG, name="indoor.cfg"):
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("lines", [CFG, [ln for ln in CFG
                                         if "profileCfg" not in ln]])
def test_parse_radar_cfg_matches_jax(tmp_path, lines):
    path = _cfg(tmp_path, lines)
    got, want = parse_radar_cfg(path), jax_parse_cfg(path)
    assert got == want
    assert ("range_resolution_m" in got) == ("profileCfg" in "".join(lines))


@pytest.mark.parametrize("reader", [RadarReader, JaxReader])
def test_radar_reader_with_filelike(tmp_path, reader):
    """tests/test_collection.py:74-84, on the port's reader and the JAX
    package's."""
    data = io.BytesIO(_frame(3, [[1, 2, 3, 4]]))
    cli = io.BytesIO()
    rd = reader(_cfg(tmp_path), cli=cli, data=data)
    rd.boot(inter_command_delay=0)
    frames = rd.poll()
    assert frames and frames[0][0] == 3
    np.testing.assert_array_equal(frames[0][1], [[1, 2, 3, 4]])
    assert b"profileCfg" in cli.getvalue()
    assert rd.poll() == []


def test_radar_reader_needs_serial_without_ports(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "serial", None)
    with pytest.raises(ImportError):
        RadarReader(_cfg(tmp_path))


def _radar_stream(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return b"\x00\x07" + b"".join(_frame(i, _points(rng, i + 1))
                                  for i in range(n))


def _without_time(records):
    out = []
    for r in records:
        r = dict(r)
        assert isinstance(r.pop("Time"), float)
        out.append(r)
    return out


def test_radar_process_matches_jax(tmp_path):
    """radar_process with an injected reader: the same records as the
    JAX package's on the same bytes, every field but the wall clock."""
    cfg, stream = _cfg(tmp_path), _radar_stream()
    pkls = {}
    for name, proc, reader in (("port", recorder, RadarReader),
                               ("jax", jax_recorder, JaxReader)):
        out = tmp_path / name
        out.mkdir()
        a, b = mp.Pipe()
        b.send("camera-go")
        cli = io.BytesIO()
        proc.radar_process(a, str(out), cfg, 0.2,
                           reader=reader(cfg, cli=cli,
                                         data=io.BytesIO(stream)))
        assert b.recv() == "radar-ready" and b"sensorStart" in cli.getvalue()
        with open(out / "pointcloud.pkl", "rb") as f:
            pkls[name] = _without_time(pickle.load(f))
    got, want = pkls["port"], pkls["jax"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["Frame_ID"] == w["Frame_ID"]
        assert g["Data"].keys() == w["Data"].keys()
        for k in g["Data"]:
            np.testing.assert_array_equal(g["Data"][k], w["Data"][k])


def _camera_layout(out):
    lines = (out / "timestamps.txt").read_text().splitlines()
    stamps = [ln.split(" ") for ln in lines]
    idx = [int(i) for _, i in stamps]
    assert idx == list(range(len(idx))) and idx
    assert all(float(t) > 0 for t, _ in stamps)
    names = sorted(os.listdir(out / "frames"))
    assert names == [f"{i:06d}.jpg" for i in idx]
    return (out / "frames" / names[0]).read_bytes()


def test_camera_process_pil_fallback_matches_jax(tmp_path, monkeypatch):
    """Without cv2 both camera processes dump black frames/*.jpg and a
    timestamps.txt of "<wallclock> <index>" lines."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    first = {}
    for name, proc in (("port", recorder), ("jax", jax_recorder)):
        out = tmp_path / name
        out.mkdir()
        a, b = mp.Pipe()
        a.send("radar-ready")
        proc.camera_process(b, str(out), 0.2, fps=20, size=(64, 48))
        assert a.recv() == "camera-go"
        first[name] = _camera_layout(out)
    assert first["port"] == first["jax"]
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(first["port"])))
    assert img.shape == (48, 64, 3)


# record() and cli.collect fork two processes: run them in a fresh
# interpreter (no JAX or torch threads at the fork), cv2 hidden so the
# camera takes the PIL fallback
_RECORD = """
import io, sys
sys.modules["cv2"] = None
sys.path.insert(0, sys.argv[1])
from millieye_torch.collection.uart import RadarReader
cfg, out, stream = sys.argv[2], sys.argv[3], open(sys.argv[4], "rb").read()
reader = RadarReader(cfg, cli=io.BytesIO(), data=io.BytesIO(stream))
if sys.argv[5] == "record":
    from millieye_torch.collection.recorder import record
    record(out, cfg, duration_s=0.4, fps=20, reader=reader)
else:
    from millieye_torch.cli.collect import main
    main(["--out", out, "--cfg", cfg, "--duration", "0.4"], reader=reader)
assert "torch" not in sys.modules
"""


@pytest.mark.parametrize("how", ["record", "cli.collect"])
def test_record_writes_the_recorder_layout(tmp_path, how):
    """record(reader=...) and cli.collect.main(reader=...): both
    processes run, with the handshake, and leave the recorder's layout:
    pointcloud.pkl (every packet of the stream, read back by
    collection.sync), frames/*.jpg and timestamps.txt."""
    from millieye_torch.collection.sync import load_pointcloud
    stream = tmp_path / "stream.bin"
    stream.write_bytes(_radar_stream())
    out = tmp_path / "rec"
    subprocess.run([sys.executable, "-c", _RECORD, str(REPO),
                    _cfg(tmp_path), str(out), str(stream), how],
                   check=True, timeout=120)
    _camera_layout(out)
    _, frames = load_pointcloud(str(out / "pointcloud.pkl"))
    assert [f.shape for f in frames] == [(4, i + 1) for i in range(5)]


def test_collect_cli_flags():
    """cli.collect has the JAX package's flags; --out and --cfg are
    required."""
    with pytest.raises(SystemExit):
        collect_cli.main(["--cfg", "x.cfg"])
    src = (REPO / "millieye_torch/cli/collect.py").read_text()
    jsrc = (REPO / "millieye_tpu/cli/collect.py").read_text()
    assert _flags(src) == _flags(jsrc) == ["--out", "--cfg", "--duration",
                                           "--fps"]


def _flags(src):
    return [n.args[0].value for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
            == "add_argument"]


def _runtime_recording(root, n_frames=6):
    sys.path.insert(0, os.path.dirname(__file__))
    from test_runtime import FRAME, _write_recording
    _write_recording(str(root), n_frames=n_frames)
    return FRAME


def _dataset(out, stems):
    """(dataset.txt lines relative to out, {stem: (jpg bytes, radar
    point array, radar box array)})."""
    lines = [os.path.relpath(p, out) for p in
             (Path(out) / "dataset.txt").read_text().splitlines()]
    files = {}
    for s in stems:
        with open(Path(out) / "radar_point" / f"{s}.pkl", "rb") as f:
            pts = pickle.load(f)
        with open(Path(out) / "radar_box" / f"{s}.pkl", "rb") as f:
            boxes = pickle.load(f)
        files[s] = ((Path(out) / "image" / f"{s}.jpg").read_bytes(), pts,
                    boxes)
    return lines, files


def _same_dataset(got, want):
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for s in want[1]:
        assert got[1][s][0] == want[1][s][0]
        for g, w in zip(got[1][s][1:], want[1][s][1:]):
            assert g.dtype == w.dtype
            assert np.array_equal(g, w)


def test_prepare_dataset_matches_jax(tmp_path):
    """tests/test_datasets.py:71-90's recording and RadarParams: equal
    stems, dataset.txt lines, image bytes and radar pickles; a second
    call appends to dataset.txt in both."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_runtime import CALIB
    frame = _runtime_recording(tmp_path / "rec")
    kw = dict(frame_size=frame, num_pts_filter=1, min_hits=1,
              min_velocity=0.0)
    rec = str(tmp_path / "rec")
    got = prepare_dataset(rec, str(tmp_path / "port"), CALIB,
                          RadarParams(**kw), keep_every=2, scene="H0-")
    want = jax_prepare(rec, str(tmp_path / "jax"), CALIB,
                       JaxRadarParams(**kw), keep_every=2, scene="H0-")
    assert got == want == ["H0-000000", "H0-000002", "H0-000004"]
    gd, wd = (_dataset(tmp_path / n, got) for n in ("port", "jax"))
    _same_dataset(gd, wd)
    assert sum(len(b) for _, _, b in gd[1].values()) > 0
    prepare_dataset(rec, str(tmp_path / "port"), CALIB, RadarParams(**kw),
                    keep_every=2, scene="H0-")
    jax_prepare(rec, str(tmp_path / "jax"), CALIB, JaxRadarParams(**kw),
                keep_every=2, scene="H0-")
    gd, wd = (_dataset(tmp_path / n, got) for n in ("port", "jax"))
    _same_dataset(gd, wd)
    assert len(gd[0]) == 6


def test_prepare_data_cli_matches_jax(tmp_path, capsys):
    """cli.prepare_data on chip_smoke.py's recorded session (its first 24
    frames at 640x480, the walkers' radar, PNG frames and a camera YAML)
    against the JAX package's CLI, and chip_smoke.py's P22 check of it
    (its pickles equal to an in-process RadarPipeline's)."""
    import chip_smoke as cs
    rec = str(tmp_path / "rec")
    os.makedirs(rec)
    frames = cs.write_recording(rec, n_frames=24)
    calib = cs.write_demo_inputs(rec, frames)
    argv = ["--recording", rec, "--calib", calib, "--scene", "L1-"]
    jax_prepare_cli.main(argv + ["--out", str(tmp_path / "jax")])
    want_out = capsys.readouterr().out
    stems = cs.prepare_data_check(rec, calib, str(tmp_path / "port"),
                                  scene="L1-")
    assert capsys.readouterr().out == want_out == "emitted 5 frames\n"
    assert stems == [f"L1-{i:06d}" for i in range(0, 24, 5)]
    gd, wd = (_dataset(tmp_path / n, stems) for n in ("port", "jax"))
    _same_dataset(gd, wd)
    assert sum(len(b) for _, _, b in gd[1].values()) > 0
    with pytest.raises(SystemExit):
        prepare_cli.main(["--recording", rec, "--out", "x"])


_PACKAGES = ("collection", "ops", "io", "models", "data", "eval", "radar",
             "runtime", "train")


def _jax_exports(package):
    """(JAX submodule, name) for each name the JAX package's __init__
    re-exports."""
    tree = ast.parse((REPO / "millieye_tpu" / package / "__init__.py")
                     .read_text())
    return [(n.module, a.name) for n in tree.body
            if isinstance(n, ast.ImportFrom) for a in n.names]


@pytest.mark.parametrize("package", _PACKAGES)
def test_reexports_mirror_jax(package):
    """Every name a JAX package's __init__ re-exports has a counterpart
    of that name in the port's submodule of the same path, and imports
    from the port's package as that object."""
    names = _jax_exports(package)
    assert names
    pkg = importlib.import_module(f"millieye_torch.{package}")
    for module, name in names:
        sub = importlib.import_module(module.replace("millieye_tpu",
                                                     "millieye_torch"))
        assert getattr(pkg, name) is getattr(sub, name), (package, name)


def test_imports_build_nothing():
    """Importing every port package and CLI loads no kernel library and
    no native library (a fresh interpreter)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import importlib\n"
            "for m in sys.argv[2:]: importlib.import_module(m)\n"
            "from millieye_torch.ops import cuda_lib\n"
            "from millieye_torch import native\n"
            "assert cuda_lib._loaded == {} and native._lib is None\n")
    mods = [f"millieye_torch.{p}" for p in _PACKAGES] + [
        f"millieye_torch.cli.{c}" for c in ("realtime", "collect",
                                             "prepare_data")]
    subprocess.run([sys.executable, "-c", code, str(REPO), *mods],
                   check=True, timeout=120)
