"""The port's evaluation path on the CPU against the JAX package's: the
numpy mAP engine, the three harnesses (``evaluate_yolo``,
``evaluate_refine``, ``evaluate_fusion`` at modes 0-3) on
``SyntheticScenes(8, seed=777)`` at 128 px, ``cli.evaluate.main`` of both
packages on one ``.npz``, and one run at 416 px on the tracked
checkpoint.

Weights: the tracked checkpoint read by the JAX package into a template
from ``jax.eval_shape`` and carried to the port through
``io.checkpoint.convert`` (``build_fusion``/``build_refine`` of the JAX
pair); the refinement network's heads come from the JAX package's
``RefineNetwork.init(PRNGKey(0))``. Both harnesses get the same host
batches.

Tolerances: at float32 the networks differ by summation order only, so
the AP arrays (precision, recall, AP, f1 per class) are held within
1e-6 and the classes equal; the 416 px run also holds each batch's rows
to the reference's window contract (``valid`` equal, boxes within 1e-4)
and the mAP within 1e-6. At bf16 (``bf16``) both packages round their
convolutions' operands to bf16 but sum in other orders (XLA:CPU against
oneDNN), which moves boxes by up to ~1 px and can carry a detection
across the 0.5 IoU or confidence threshold: the AP arrays are held within
0.1 and the mAP within 0.05. ``int8_acts``: the JAX harness compiles its
step, which multiplies by the reciprocal of each activation scale (a
standing difference, ROADMAP §3 "Compiled int8_acts"; 0.94 px): held as
bf16."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.cli import evaluate as tcli
from millieye_torch.cli._common import build_fusion, build_refine
from millieye_torch.data.loader import DataLoader, PaddedCollate
from millieye_torch.data.synthetic import SyntheticScenes
from millieye_torch.eval import harness as th
from millieye_torch.eval import metrics as tm
from millieye_torch.io.checkpoint import convert
from millieye_torch.models.darknet import Darknet as TorchDarknet
from millieye_torch.models.zoo import tiny_yolov3_defs as torch_defs
from millieye_torch.train.recipes import fusion_device_batch
from millieye_tpu.cli import evaluate as jcli
from millieye_tpu.eval import harness as jh
from millieye_tpu.eval import metrics as jm
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxNetwork
from millieye_tpu.models.fusion import RefineNetwork as JaxRefine
from millieye_tpu.train.recipes import fusion_device_batch as jax_batch

torch.set_num_threads(1)

CKPT = "artifacts/stage3_final.npz"
S = 128
F32_TOL = 1e-6
BF16_TOL = dict(ap=0.1, map=0.05)


def _same_result(got, want, tol):
    """Two ``ap_per_class`` results: classes equal, every array within
    ``tol``."""
    assert (got is None) == (want is None)
    if got is None:
        return
    p, r, ap, f1, cls, curve = got
    jp, jr, jap, jf1, jcls, jcurve = want
    np.testing.assert_array_equal(cls, jcls)
    for a, b in ((p, jp), (r, jr), (ap, jap), (f1, jf1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    for a, b in zip(curve, jcurve):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=tol)


# ------------------------------------------------------------------ metrics
def test_metrics_equal():
    rng = np.random.default_rng(0)
    box = np.array([10.0, 12.0, 40.0, 50.0])
    boxes = rng.uniform(0, 60, size=(9, 4))
    boxes[:, 2:] += boxes[:, :2]
    np.testing.assert_array_equal(tm.iou_np(box, boxes),
                                  jm.iou_np(box, boxes))
    outputs, targets = [], []
    for i in range(5):
        n = int(rng.integers(0, 6))
        if n == 0:
            outputs.append(None)
        else:
            o = np.zeros((n, 7))
            o[:, :2] = rng.uniform(0, 80, (n, 2))
            o[:, 2:4] = o[:, :2] + rng.uniform(5, 40, (n, 2))
            o[:, 4:6] = rng.uniform(size=(n, 2))
            o[:, 6] = rng.integers(0, 3, n)
            outputs.append(o)
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.uniform(0, 80, 2)
            targets.append([i, rng.integers(0, 3), x, y,
                            x + rng.uniform(5, 40), y + rng.uniform(5, 40)])
    targets = np.asarray(targets)
    for thr in (0.1, 0.5):
        got = tm.get_batch_statistics(outputs, targets, thr)
        want = jm.get_batch_statistics(outputs, targets, thr)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        tp = np.concatenate([s[0] for s in got])
        conf = np.concatenate([s[1] for s in got])
        pred = np.concatenate([s[2] for s in got])
        _same_result(tm.ap_per_class(tp, conf, pred, targets[:, 1]),
                     jm.ap_per_class(tp, conf, pred, targets[:, 1]), 0)
    rec, prec = np.sort(rng.uniform(size=7)), rng.uniform(size=7)
    assert tm.compute_ap(rec, prec) == jm.compute_ap(rec, prec)
    # no predictions of a class, an empty target list
    _same_result(tm.ap_per_class([], [], [], []),
                 jm.ap_per_class([], [], [], []), 0)
    text, m_ap = th.summarize(got and tm.ap_per_class(
        tp, conf, pred, targets[:, 1]), ["a", "b", "c"])
    assert (text, m_ap) == jh.summarize(jm.ap_per_class(
        tp, conf, pred, targets[:, 1]), ["a", "b", "c"])
    assert th.summarize(None) == jh.summarize(None)


# ---------------------------------------------------------------- harnesses
def _jax_darknet(size):
    return JaxDarknet(jax_defs(num_classes=12, img_size=size), img_size=size)


@functools.lru_cache(maxsize=None)
def _jax_fusion(size, **over):
    model = JaxNetwork(_jax_darknet(size), JaxConfig(**over))
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    r = load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    return model, r["params"], r["state"]


@functools.lru_cache(maxsize=None)
def _host_batches(n, size, radar=True, batch=4):
    ds = SyntheticScenes(n, seed=777, radar=radar)
    kw = dict(max_targets=64)
    if radar:
        kw.update(max_radar=32, max_points=256)
    return tuple(DataLoader(ds, batch, PaddedCollate(size, **kw)))


def _both(size, radar=True):
    hb = _host_batches(8, size, radar)
    return ([fusion_device_batch(b, size, "cpu") for b in hb],
            [jax_batch(b, size) for b in hb])


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_evaluate_fusion_matches_jax(mode):
    jmodel, jp, js = _jax_fusion(S)
    model, params, state = build_fusion((jp, js), "f32", img_size=S,
                                        device="cpu")
    tb, jb = _both(S)
    got = th.evaluate_fusion(model, params, state, tb, mode=mode)
    want = jh.evaluate_fusion(jmodel, _jnp(jp), _jnp(js), jb, mode=mode)
    assert got is not None
    _same_result(got, want, F32_TOL)


def test_evaluate_fusion_bf16_and_mesh():
    jmodel, jp, js = _jax_fusion(S, compute_dtype="bfloat16")
    model, params, state = build_fusion((jp, js), "bf16", img_size=S,
                                        device="cpu")
    tb, jb = _both(S)
    got = th.evaluate_fusion(model, params, state, tb)
    want = jh.evaluate_fusion(jmodel, _jnp(jp), _jnp(js), jb)
    _same_result(got, want, BF16_TOL["ap"])
    with pytest.raises(NotImplementedError, match="item 9"):
        th.evaluate_fusion(model, params, state, tb, mesh=object())


def test_evaluate_yolo_and_refine_match_jax():
    _, jp, js = _jax_fusion(S)
    jdn = _jax_darknet(S)
    dn = TorchDarknet(torch_defs(num_classes=12, img_size=S), img_size=S)
    dp, ds = convert(jp["darknet"], js["darknet"])
    tb, jb = _both(S, radar=False)
    for conf in (0.5, 0.1):
        got = th.evaluate_yolo(dn, dp, ds, tb, conf_thresh=conf)
        want = jh.evaluate_yolo(jdn, _jnp(jp["darknet"]),
                                _jnp(js["darknet"]), jb, conf_thresh=conf)
        _same_result(got, want, F32_TOL)

    # module2's network: the checkpoint's Darknet and score-map stack,
    # heads from the JAX init (no checkpoint has them)
    jref = JaxRefine(jdn, JaxConfig(class_num=12, conf_thresh=0.1))
    rp, rs = jref.init(jax.random.PRNGKey(0))
    rp = dict(rp, darknet=jp["darknet"], fcn=jp["img_cnn"])
    rs = dict(rs, darknet=js["darknet"], fcn=js["img_cnn"])
    model, params, state = build_refine(
        (jax.tree.map(np.asarray, rp), jax.tree.map(np.asarray, rs)),
        img_size=S, device="cpu", conf_thresh=0.1)
    got = th.evaluate_refine(model, params, state, tb)
    want = jh.evaluate_refine(jref, _jnp(rp), _jnp(rs), jb)
    assert got is not None
    _same_result(got, want, F32_TOL)


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("serving,tol", [("f32", None), ("bf16", BF16_TOL),
                                         ("int8_acts", BF16_TOL)])
def test_evaluate_cli_matches_jax(serving, tol, tmp_path):
    argv = ["--what", "fusion", "--weights", CKPT, "--synthetic", "8",
            "--img_size", str(S), "--batch_size", "4", "--serving", serving]
    got = tcli.main(argv + ["--device", "cpu"])
    want = jcli.main(argv)
    assert isinstance(got, float)
    if tol is None:
        assert abs(got - want) <= F32_TOL
    else:
        assert abs(got - want) <= tol["map"]


def test_evaluate_cli_options(tmp_path, capsys):
    """--device_cache, --model_mode 3, --plot, --class_names, --what yolo
    on a darknet file and refine on the fusion checkpoint, and the
    --data_parallel refusals."""
    from millieye_torch.io.checkpoint import save_checkpoint
    from millieye_torch.io.darknet_weights import save_darknet_weights
    names = tmp_path / "names.txt"
    names.write_text("person\n" + "".join(f"c{i}\n" for i in range(1, 12)))
    base = ["--weights", CKPT, "--synthetic", "8", "--img_size", str(S),
            "--batch_size", "3", "--device", "cpu"]
    host = tcli.main(["--what", "fusion", "--model_mode", "3"] + base)
    plot = tmp_path / "pr.png"
    cached = tcli.main(["--what", "fusion", "--model_mode", "3",
                        "--device_cache", "--plot", str(plot),
                        "--class_names", str(names)] + base)
    out = capsys.readouterr().out
    assert "person" in out and plot.exists()
    # float16 images in the cache: the same scenes, within a few rows
    assert abs(cached - host) <= 0.1
    # --what yolo on a darknet file (its header dropped) and on the same
    # Darknet's .npz: one answer
    model, params, state = build_fusion(CKPT, img_size=S, device="cpu")
    wfile, nfile = (str(tmp_path / f) for f in ("dn.weights", "dn.npz"))
    save_darknet_weights(model.darknet, params["darknet"], state["darknet"],
                         wfile)
    save_checkpoint(nfile, {"params": params["darknet"],
                            "state": state["darknet"]})
    yolo = ["--what", "yolo", "--conf_thresh", "0.1"] + base[2:]
    assert tcli.main(yolo + ["--weights", wfile]) == tcli.main(
        yolo + ["--weights", nfile])
    assert isinstance(tcli.main(["--what", "refine"] + base), float)
    with pytest.raises(SystemExit, match="needs that many devices"):
        tcli.main(["--what", "fusion", "--data_parallel", "2"] + base)
    assert tcli.parse_args(["--what", "fusion", "--weights", "w"]).device \
        == "cuda"


# ------------------------------------------------------------ 416 px, f32
def test_evaluate_fusion_416_matches_jax(monkeypatch):
    """The tracked checkpoint at 416 px on 16 scenes: each batch's rows
    to the reference's window contract, the mAP within 1e-6."""
    size = 416
    jmodel, jp, js = _jax_fusion(size)
    model, params, state = build_fusion(CKPT, "f32", img_size=size,
                                        device="cpu")
    hb = tuple(DataLoader(SyntheticScenes(16, seed=777), 8,
                          PaddedCollate(size, max_targets=64, max_radar=32,
                                        max_points=256)))
    rows = {"port": [], "jax": []}
    for key, mod in (("port", th), ("jax", jh)):
        real = mod._unpad

        def record(boxes, valid, n=None, key=key, real=real):
            rows[key].append((np.asarray(boxes), np.asarray(valid)))
            return real(boxes, valid, n)
        monkeypatch.setattr(mod, "_unpad", record)
    got = th.evaluate_fusion(model, params, state,
                             [fusion_device_batch(b, size, "cpu")
                              for b in hb])
    want = jh.evaluate_fusion(jmodel, _jnp(jp), _jnp(js),
                              [jax_batch(b, size) for b in hb])
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for (gb, gv), (wb, wv) in zip(rows["port"], rows["jax"]):
        np.testing.assert_array_equal(gv, wv)
        assert gv.any()
        np.testing.assert_allclose(gb[gv], wb[wv], rtol=1e-4, atol=1e-4)
    assert abs(th.summarize(got)[1] - jh.summarize(want)[1]) <= F32_TOL
