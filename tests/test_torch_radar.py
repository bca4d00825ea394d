"""Port parity of the radar host chain: recording I/O and time matching,
projection, Hungarian assignment, the Kalman filter, DBSCAN (both
backends), the tracker, ``RadarPipeline.process`` and the drawing
helpers of millieye_torch against millieye_tpu. The same numpy-seeded
inputs go through both packages; the port keeps the JAX package's numpy
operations in their order, so every result is held EQUAL
(``assert_array_equal``), not close. Track ids come from a counter that
each package's ``_Track`` shares across its process, so they are compared
as offsets from the count before the run.

Also the contracts of tests/test_radar.py, run on the port.
"""
import importlib
import os
import pickle

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import millieye_torch.native as tnative
import millieye_tpu.native as jnative
from millieye_torch.collection import sync as tsync
from millieye_torch.radar import hungarian as thung
from millieye_torch.radar import kalman as tkal
from millieye_torch.radar import pipeline as tpipe
from millieye_torch.radar import projection as tproj
from millieye_torch.radar import tracker as ttrack
from millieye_torch.radar import viz as tviz
from millieye_tpu.collection import sync as jsync
from millieye_tpu.radar import hungarian as jhung
from millieye_tpu.radar import kalman as jkal
from millieye_tpu.radar import pipeline as jpipe
from millieye_tpu.radar import projection as jproj
from millieye_tpu.radar import tracker as jtrack
from millieye_tpu.radar import viz as jviz

# the packages' radar/__init__.py export the function dbscan under the
# module's name
tdb = importlib.import_module("millieye_torch.radar.dbscan")
jdb = importlib.import_module("millieye_tpu.radar.dbscan")

torch.set_num_threads(1)

CALIB = np.array([500.0, 320.0, 500.0, 240.0,
                  0.0, 0.0, 0.0, 0.0, 0.0, -0.07, -0.05, 0.0])
# plumb-bob distortion of a wide lens
CALIB_DIST = np.array([480.0, 322.5, 482.0, 238.5,
                       -0.28, 0.09, 1.2e-3, -8e-4, -0.012, -0.07, -0.05, 0.0])


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _eq_tree(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq_tree(x, y)
    else:
        _eq(a, b)


@pytest.fixture
def native_lib():
    """Both packages' native library (one file), or a skip where no
    compiler can build it."""
    try:
        tnative._load()
        jnative._load()
    except Exception as e:                      # no toolchain
        pytest.skip(f"native library unavailable: {e}")


@pytest.fixture
def numpy_backend(monkeypatch):
    """Both packages on their numpy / scipy fallbacks."""
    def refuse(*_):
        raise OSError("native backend switched off")

    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "dbscan_native", refuse)
        monkeypatch.setattr(mod, "hungarian_native", refuse)


# ----------------------------------------------------------------- sync
def _write_sync_recording(root, rng):
    """40 radar frames on a 0.25 s grid and video frames at the midpoints
    (every distance to the two nearest radar frames is an exact tie),
    then at random times."""
    os.makedirs(root, exist_ok=True)
    rtimes = np.arange(40) * 0.25
    vtimes = np.concatenate([np.arange(30) * 0.25 + 0.125,
                             np.sort(rng.uniform(0, 10, 20))])
    with open(os.path.join(root, "timestamps.txt"), "w") as f:
        for i, t in enumerate(vtimes):
            f.write(f"{float(t)!r} {i}\n")
        f.write("\n")                                  # a blank line
    records = []
    for i, t in enumerate(rtimes):
        n = int(rng.integers(0, 9))
        records.append({"Data": {"numObj": n, "x": rng.normal(size=n),
                                 "y": rng.uniform(1, 8, n),
                                 "z": rng.normal(size=n) * 0.3,
                                 "velocity": rng.normal(size=n)},
                        "Time": float(t), "Frame_ID": i})
    with open(os.path.join(root, "pointcloud.pkl"), "wb") as f:
        pickle.dump(records, f)


def test_sync_matches(tmp_path):
    rng = np.random.default_rng(3)
    rec = str(tmp_path)
    _write_sync_recording(rec, rng)
    ts = os.path.join(rec, "timestamps.txt")
    pc = os.path.join(rec, "pointcloud.pkl")
    vt, vj = tsync.load_timestamps(ts), jsync.load_timestamps(ts)
    _eq(vt, vj)
    rt, rf = tsync.load_pointcloud(pc)
    rtj, rfj = jsync.load_pointcloud(pc)
    _eq(rt, rtj)
    _eq_tree(rf, rfj)
    assert rf[0].shape[0] == 4 and rf[0].dtype == np.float64
    # the midpoints tie exactly between two radar frames, and on some of
    # them a stable sort would pick other frames than numpy's default
    d = np.abs(rt - vt[0])
    assert np.sum(d == d.min()) == 2
    assert any(list(np.argsort(np.abs(rt - t), kind="stable")[:3])
               != list(np.argsort(np.abs(rt - t))[:3]) for t in vt)
    for k in (1, 3, 5):
        got = tsync.match_frames(vt, rt, k)
        _eq_tree(got, jsync.match_frames(vt, rt, k))
        assert all(len(p) <= k for p in got)


# ----------------------------------------------------------- projection
def test_projection_matches(tmp_path, rng):
    import yaml
    path = tmp_path / "calib.yaml"
    path.write_text(yaml.safe_dump({
        "camera_matrix": {"data": [480.0, 0.0, 322.5, 0.0, 482.0, 238.5,
                                   0.0, 0.0, 1.0]},
        "distortion_coefficients": {"data": [-0.28, 0.09, 1.2e-3, -8e-4,
                                             -0.012]}}))
    calib = tproj.load_calib(str(path))
    _eq(calib, jproj.load_calib(str(path)))
    _eq(calib, CALIB_DIST)
    xyz = np.stack([rng.normal(size=50), rng.normal(size=50),
                    rng.uniform(-1, 8, 50)])
    xyz[2, :3] = (0.0, -1e-9, 1e-12)           # at / behind the camera
    for c in (CALIB, CALIB_DIST):
        _eq_tree(tproj.project_camera_xyz_to_uv(xyz, c),
                 jproj.project_camera_xyz_to_uv(xyz, c))
        pts = np.stack([rng.normal(size=50), rng.uniform(-1, 9, 50),
                        rng.normal(size=50) * 0.5, rng.normal(size=50)])
        _eq_tree(tproj.radar_points_to_image(pts, c),
                 jproj.radar_points_to_image(pts, c))


# -------------------------------------------------------------- assign
@pytest.mark.parametrize("shape", [(1, 5), (6, 1), (3, 4), (4, 3), (7, 9),
                                   (9, 7), "tied4", "tied6"])
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_assign_matches(shape, backend, request):
    request.getfixturevalue("native_lib" if backend == "native"
                            else "numpy_backend")
    rng = np.random.default_rng(11)
    if shape == "tied4":        # the exhaustive search, every total tied
        cost = np.ones((4, 4))
    elif shape == "tied6":      # native or scipy, rows of equal costs
        cost = np.repeat(rng.integers(0, 3, (1, 6)).astype(float), 6, 0)
    else:
        cost = rng.uniform(0, 10, size=shape)
    thung.assign.backends.clear()
    got, want = thung.assign(cost), jhung.assign(cost)
    _eq_tree(got, want)
    r2, c2 = linear_sum_assignment(cost)
    assert cost[got].sum() == pytest.approx(cost[r2, c2].sum())
    n, m = cost.shape
    branch = ("row" if n == 1 else "column" if m == 1 else "search"
              if n <= 4 and m <= 4 else
              "native" if backend == "native" else "scipy")
    assert thung.assign.backends == {branch: 1}


def test_assign_empty():
    _eq_tree(thung.assign(np.zeros((0, 3))), jhung.assign(np.zeros((0, 3))))


# --------------------------------------------------------------- kalman
def test_kalman_matches():
    rng = np.random.default_rng(5)
    args = (rng.normal(size=3), 0.7, np.abs(rng.normal(size=3)), 0.05)
    kt, kj = tkal.ClusterKalman(*args), jkal.ClusterKalman(*args)
    for _ in range(20):
        kt.predict()
        kj.predict()
        z = (rng.normal(size=3), float(rng.normal()),
             np.abs(rng.normal(size=3)))
        kt.update(*z)
        kj.update(*z)
        _eq(kt.x, kj.x)
        _eq(kt.P, kj.P)
    assert kt.x.dtype == np.float64
    _eq(kt.center, kj.center)
    _eq(kt.size, kj.size)
    assert kt.avg_v == kj.avg_v


# --------------------------------------------------------------- dbscan
def _clouds(rng):
    """Blobs, noise, an empty cloud, duplicates and a single point."""
    blobs = np.concatenate([rng.normal(size=(15, 4)) * 0.3 + c for c in
                            rng.uniform(-6, 6, (4, 4))])
    yield blobs
    yield rng.normal(size=(40, 4)) * 3
    yield np.zeros((0, 4))
    yield np.repeat(rng.normal(size=(1, 4)), 5, 0)
    yield rng.normal(size=(1, 4))


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_dbscan_matches(backend, request):
    request.getfixturevalue("native_lib" if backend == "native"
                            else "numpy_backend")
    rng = np.random.default_rng(7)
    tdb.dbscan.backends.clear()
    calls = 0
    for pts in _clouds(rng):
        for eps, ms in ((1.5, 2), (0.8, 4)):
            _eq(tdb.dbscan(pts, eps, ms), jdb.dbscan(pts, eps, ms))
            calls += len(pts) > 0
        for gv in (True, False):
            _eq_tree(tdb.cluster_points(pts, global_avg_v=gv),
                     jdb.cluster_points(pts, global_avg_v=gv))
            calls += len(pts) > 0
    assert tdb.dbscan.backends == {backend: calls}


def test_dbscan_native_equals_numpy(native_lib, monkeypatch):
    rng = np.random.default_rng(8)
    for pts in _clouds(rng):
        if not len(pts):
            continue
        native = tdb.dbscan(pts, 1.5, 2)
        monkeypatch.setattr(tnative, "dbscan_native", None)
        _eq(native, tdb.dbscan(pts, 1.5, 2))
        monkeypatch.undo()
    assert tdb.dbscan.backends["numpy"] > 0


def test_cluster_helpers_match(rng):
    pts = np.concatenate([rng.normal(size=(8, 4)) * 0.2,
                          rng.normal(size=(3, 4)) * 0.2 + 5])
    ct, _ = tdb.cluster_points(pts, eps=1.0)
    cj, _ = jdb.cluster_points(pts, eps=1.0)
    _eq_tree(tdb.filter_clusters(ct, 5), jdb.filter_clusters(cj, 5))
    _eq_tree(tdb.take_cluster(ct, 1), jdb.take_cluster(cj, 1))
    _eq_tree(tdb.concat_clusters([tdb.take_cluster(ct, i) for i in (1, 0)]),
             jdb.concat_clusters([jdb.take_cluster(cj, i) for i in (1, 0)]))
    _eq_tree(tdb.concat_clusters([]), jdb.concat_clusters([]))
    _eq_tree(tdb._empty_clusters(), jdb._empty_clusters())


# ------------------------------------------------- tracker and pipeline
def walker_frames(rng, n_frames=40, n_walkers=3, clutter=15):
    """Radar frames [4, n] (x, y = depth, z, velocity): walkers at 2-6 m
    depth and |x| <= 1.5 m, 12-25 points each, spread 0.3 m, moving at
    0.5-1.5 m/s in depth, plus slow clutter; one frame empty and one of
    300 points."""
    start = np.stack([rng.uniform(-1.5, 1.5, n_walkers),
                      rng.uniform(2, 6, n_walkers)], -1)
    speed = rng.uniform(0.5, 1.5, n_walkers) * rng.choice([-1, 1], n_walkers)
    frames = []
    for f in range(n_frames):
        cols = []
        for w in range(n_walkers):
            n = int(rng.integers(12, 26))
            depth = np.clip(start[w, 1] + speed[w] * f / 20, 2, 6)
            cols.append(np.stack([
                start[w, 0] + rng.normal(0, 0.3, n),
                depth + rng.normal(0, 0.3, n),
                rng.normal(0, 0.3, n) - 0.2,
                speed[w] + rng.normal(0, 0.1, n)]))
        cols.append(np.stack([rng.uniform(-4, 4, clutter),
                              rng.uniform(1, 12, clutter),
                              rng.uniform(-1, 1, clutter),
                              rng.uniform(-0.1, 0.1, clutter)]))
        frames.append(np.concatenate(cols, 1))
    frames[17] = np.zeros((4, 0))
    frames[23] = np.concatenate([frames[23], np.stack([
        rng.uniform(-1, 1, 300), rng.uniform(2, 5, 300),
        rng.uniform(-0.5, 0.5, 300), rng.uniform(0.2, 1, 300)])], 1)
    return frames


def _without_ids(tracked, first):
    return [dict(t, id=t["id"] - first) for t in tracked]


def test_tracker_matches():
    rng = np.random.default_rng(21)
    tt, tj = ttrack.ClusterTracker(), jtrack.ClusterTracker()
    t0, j0 = ttrack._Track._count, jtrack._Track._count
    reported = 0
    for pts in walker_frames(rng):
        xyzv = np.stack([pts[0], -pts[2], pts[1], pts[3]], -1)
        ct, _ = tdb.cluster_points(xyzv)
        cj, _ = jdb.cluster_points(xyzv)
        _eq_tree(ct, cj)
        ct, cj = tdb.filter_clusters(ct, 5), jdb.filter_clusters(cj, 5)
        out_t, out_j = tt.update(ct), tj.update(cj)
        _eq_tree(_without_ids(out_t, t0), _without_ids(out_j, j0))
        reported += len(out_t)
    assert reported > 40
    assert ttrack._Track._count - t0 == jtrack._Track._count - j0 > 2


@pytest.mark.parametrize("calib", ["pinhole", "distorted"])
def test_pipeline_process_matches(calib):
    c = CALIB if calib == "pinhole" else CALIB_DIST
    rng = np.random.default_rng(4)
    pt, pj = tpipe.RadarPipeline(c), jpipe.RadarPipeline(c)
    t0, j0 = ttrack._Track._count, jtrack._Track._count
    with_props, n_points = 0, []
    for pts in walker_frames(rng):
        ot, oj = pt.process(pts), pj.process(pts)
        _eq(ot["points_uvzv"], oj["points_uvzv"])
        _eq(ot["proposals"], oj["proposals"])
        _eq_tree(_without_ids(ot["tracked"], t0),
                 _without_ids(oj["tracked"], j0))
        with_props += len(ot["proposals"]) > 0
        n_points.append(len(ot["points_uvzv"]))
    assert with_props >= 20
    assert min(n_points) == 0 and max(n_points) > 256
    assert tpipe.RadarParams() == tpipe.RadarParams(
        **vars(jpipe.RadarParams()))
    props = ot["proposals"]
    _eq(tpipe.clusters_to_proposals(ot["tracked"], c, 20.0),
        jpipe.clusters_to_proposals(oj["tracked"], c, 20.0))
    _eq_tree(tpipe.normalize_boxes_to_padded(props, (640, 480)),
             jpipe.normalize_boxes_to_padded(props, (640, 480)))
    _eq_tree(tpipe.pad_rows(props, 2, 4), jpipe.pad_rows(props, 2, 4))


# ------------------------------------------------------------------ viz
def test_viz_matches(rng):
    frame = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    calib = np.array([40.0, 32, 40, 24, 0, 0, 0, 0, 0, 0, 0, 0])
    pts = np.array([[10.0, 10.0, 2.0, 1.0], [50.0, 30.0, 8.0, -1.0]])
    _eq(tviz.draw_radar_points(frame, pts), jviz.draw_radar_points(frame,
                                                                   pts))
    tracked = [{"center": (0.0, 0.0, 3.0), "size": (0.5, 0.5, 0.5)},
               {"center": (0.2, 0.1, 0.05), "size": (0.5, 0.5, 0.5)}]
    _eq(tviz.draw_cluster_boxes(frame, tracked, calib),
        jviz.draw_cluster_boxes(frame, tracked, calib))
    _eq(tviz.cluster_corners_3d((1.0, 2.0, 3.0), (0.5, 0.2, 1.0)),
        jviz.cluster_corners_3d((1.0, 2.0, 3.0), (0.5, 0.2, 1.0)))
    boxes = np.array([[5, 5, 30, 40, 0.9, 0], [1, 2, 20, 21, 0.4, 3],
                      [0, 0, 9, 9, 0.1, 1]])
    valid = np.array([True, True, False])
    for labels in (None, ["person", "a", "b", "car"]):
        got = tviz.draw_detections(frame, boxes, valid, labels=labels)
        _eq(got, jviz.draw_detections(frame, boxes, valid, labels=labels))
    assert not np.array_equal(got, frame)


# ---------------------------------- the contracts of tests/test_radar.py
def _relabel(labels):
    out = np.full_like(labels, -1)
    seen = {}
    for i, lab in enumerate(labels):
        if lab >= 0:
            out[i] = seen.setdefault(lab, len(seen))
    return out


def _dbscan_matches_sklearn(rng):
    sklearn = pytest.importorskip("sklearn.cluster")
    for _ in range(5):
        pts = rng.normal(size=(40, 4)) * 3
        got = tdb.dbscan(pts, eps=1.5, min_samples=2)
        want = sklearn.DBSCAN(eps=1.5, min_samples=2).fit_predict(pts)
        _eq(_relabel(got), _relabel(want))


def _dbscan_empty_and_noise(rng):
    assert tdb.dbscan(np.zeros((0, 4)), 1.5, 2).size == 0
    pts = np.arange(5)[:, None] * np.array([[100.0, 0, 0, 0]])
    assert (tdb.dbscan(pts, 1.5, 2) == -1).all()


def _cluster_points_summary(rng):
    a = rng.normal(size=(6, 4)) * 0.1 + np.array([0, 0, 0, 1.0])
    b = rng.normal(size=(5, 4)) * 0.1 + np.array([50, 50, 50, -2.0])
    pts = np.concatenate([a, b])
    clusters, _ = tdb.cluster_points(pts, weights=(1, 1, 1, 0), eps=2.0,
                                     global_avg_v=False)
    assert set(clusters["num_points"].tolist()) == {5, 6}
    assert {round(v) for v in clusters["avg_v"]} == {1, -2}
    clusters_g, _ = tdb.cluster_points(pts, weights=(1, 1, 1, 0), eps=2.0)
    np.testing.assert_allclose(clusters_g["avg_v"],
                               np.full(2, pts[:, 3].mean()))
    assert len(tdb.filter_clusters(clusters, 6)["num_points"]) == 1


def _hungarian_matches_scipy(rng):
    for shape in ((3, 3), (2, 5), (6, 2)):
        cost = rng.uniform(0, 10, size=shape)
        r, c = thung.assign(cost)
        r2, c2 = linear_sum_assignment(cost)
        assert cost[r, c].sum() == pytest.approx(cost[r2, c2].sum())


def _kalman_constant_velocity(rng):
    kf = tkal.ClusterKalman(center=(0, 0, 10.0), avg_v=1.0, size=(1, 1, 1),
                            dt=0.05)
    for step in range(1, 40):
        kf.predict()
        kf.update(center=(0, 0, 10.0 + step * 0.05), avg_v=1.0,
                  size=(1, 1, 1))
    assert kf.center[2] == pytest.approx(10.0 + 39 * 0.05, abs=0.05)
    assert kf.x[5] == pytest.approx(1.0, abs=0.2)


def _tracker_lifecycle(rng):
    tr = ttrack.ClusterTracker(fps=20, max_age=4, min_hits=4)

    def frame(depth):
        return {"num_points": np.array([8]),
                "center": np.array([[1.0, 2.0, depth]]),
                "size": np.array([[0.5, 1.0, 0.4]]),
                "avg_v": np.array([1.0])}

    assert len(tr.update(frame(10.0))) == 1
    for i in range(6):
        out = tr.update(frame(10.0 + i * 0.05))
    assert len(out) == 1
    alive = [len(tr.update(tdb._empty_clusters())) for _ in range(6)]
    assert alive[0] == 1 and alive[-1] == 0


def _projection_pinhole_closed_form(rng):
    calib = np.array([500.0, 320.0, 480.0, 240.0, 0, 0, 0, 0, 0, 0, 0, 0])
    u, v = tproj.project_camera_xyz_to_uv(np.array([[1.0], [0.5], [5.0]]),
                                          calib)
    assert u[0] == pytest.approx(500 * 1.0 / 5.0 + 320)
    assert v[0] == pytest.approx(480 * 0.5 / 5.0 + 240)


def _pipeline_end_to_end(rng):
    calib = np.array([500.0, 320.0, 480.0, 240.0,
                      0, 0, 0, 0, 0, -0.07, -0.05, 0])
    pipe = tpipe.RadarPipeline(calib, tpipe.RadarParams(num_pts_filter=3,
                                                        min_hits=2))
    for _ in range(6):
        pts = np.zeros((4, 12))
        pts[0] = rng.normal(scale=0.1, size=12) + 0.2
        pts[1] = rng.normal(scale=0.1, size=12) + 5.0
        pts[2] = rng.normal(scale=0.1, size=12) - 0.2
        pts[3] = 1.0
        out = pipe.process(pts)
    assert out["points_uvzv"].shape[1] == 4
    assert out["proposals"].shape[0] >= 1
    boxes, valid = tpipe.normalize_boxes_to_padded(out["proposals"],
                                                   (640, 480))
    assert ((boxes >= 0) & (boxes <= 1)).all()
    padded, mask = tpipe.pad_rows(boxes[valid], 32, 4)
    assert padded.shape == (32, 4) and mask.sum() == valid.sum()


def _pipeline_empty_cloud(rng):
    pipe = tpipe.RadarPipeline(np.array([500.0, 320.0, 480.0, 240.0,
                                         0, 0, 0, 0, 0, 0, 0, 0]))
    out = pipe.process(np.zeros((4, 0)))
    assert out["proposals"].shape == (0, 4)
    assert out["points_uvzv"].shape == (0, 4)


def _viz_helpers(rng):
    frame = np.zeros((48, 64, 3), np.uint8)
    calib = np.array([40.0, 32, 40, 24, 0, 0, 0, 0, 0, 0, 0, 0])
    pts = np.array([[10.0, 10.0, 2.0, 1.0], [50.0, 30.0, 8.0, -1.0]])
    out = tviz.draw_radar_points(frame, pts)
    assert out.shape == frame.shape and out.sum() > 0
    tracked = [{"center": (0.0, 0.0, 3.0), "size": (0.5, 0.5, 0.5)}]
    out2 = tviz.draw_cluster_boxes(out, tracked, calib)
    assert out2.sum() > out.sum()
    out3 = tviz.draw_detections(out2, np.array([[5, 5, 30, 40, 0.9, 0]]),
                                np.array([True]), labels=["person"])
    assert out3.sum() > 0


CONTRACTS = {f.__name__[1:]: f for f in (
    _dbscan_matches_sklearn, _dbscan_empty_and_noise,
    _cluster_points_summary, _hungarian_matches_scipy,
    _kalman_constant_velocity, _tracker_lifecycle,
    _projection_pinhole_closed_form, _pipeline_end_to_end,
    _pipeline_empty_cloud, _viz_helpers)}


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_radar_contract(name, rng):
    CONTRACTS[name](rng)
