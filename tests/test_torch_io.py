"""Port parity: weights and configs in and out. millieye_torch/io
(config.py, darknet_weights.py, torch_ckpt.py, checkpoint.py,
artifacts.py) and cli/_common.py's load_weights_any / load_fusion against
the JAX package's functions, on the same numpy-seeded inputs and files.

Tolerance: equality everywhere. The readers and writers move float32
values without arithmetic, so the port's tree must equal
``io/checkpoint.py:convert`` of the JAX package's leaf for leaf, and a
file written by one package must hold the other's bytes. The JAX
templates come from ``jax.eval_shape`` of its inits (the inits alone cost
seconds and their values are never read).
"""
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from millieye_torch.cli._common import (build_darknet, build_fusion,
                                        build_refine, load_fusion,
                                        load_weights_any)
from millieye_torch.io import artifacts as tart
from millieye_torch.io import checkpoint as tck
from millieye_torch.io import config as tcfg
from millieye_torch.io import darknet_weights as tdw
from millieye_torch.io import torch_ckpt as ttc
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.zoo import tiny_yolov3_defs, yolov3_defs
from millieye_tpu.cli._common import load_weights_any as jax_load_any
from millieye_tpu.io import artifacts as jart
from millieye_tpu.io import checkpoint as jck
from millieye_tpu.io import config as jcfg
from millieye_tpu.io import darknet_weights as jdw
from millieye_tpu.io import torch_ckpt as jtc
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_tiny_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxFusion
from millieye_tpu.models.fusion import RefineNetwork as JaxRefine

torch.set_num_threads(1)

S = 128
CKPT = "artifacts/stage3_final.npz"
CFG_TEXT = """
# a comment
[net]
channels=3
width=64
height=64

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=33
size=1
stride=1
pad=1
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14,  23,27,  37,58
classes=6
num=3
"""


def _equal_trees(got, want):
    """Port tree against a port-layout tree: same key paths, bit-equal
    tensors of the same dtype."""
    g, w = tck.leaf_items(got), tck.leaf_items(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def _as_port(jax_tree):
    """A JAX tree (numpy or jax leaves) in the port's layout."""
    return tck.convert(*jax.tree.map(np.asarray, jax_tree))


def _jax_fusion(cls=JaxFusion, **cfg):
    model = cls(JaxDarknet(jax_tiny_defs(num_classes=12, img_size=S),
                           img_size=S), JaxConfig(**cfg))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _random_like(like, rng):
    """Numpy leaves of ``like``'s shapes (variances positive)."""
    return jax.tree.map(lambda sd: rng.uniform(0.5, 2, sd.shape).astype(
        np.float32), like)


# ----------------------------------------------------------------- configs
def test_parse_model_config_matches(tmp_path):
    path = tmp_path / "m.cfg"
    path.write_text(CFG_TEXT)
    got = tcfg.parse_model_config(str(path))
    assert got == jcfg.parse_model_config(str(path))
    assert got[1]["batch_normalize"] == "1"
    assert got[3]["batch_normalize"] == "0"
    # the zoo's full YOLOv3 through chip_smoke.py's writer
    path = tmp_path / "yolov3.cfg"
    cs.write_cfg(yolov3_defs(80, 416), str(path))
    assert tcfg.parse_model_config(str(path)) == jcfg.parse_model_config(
        str(path)) == yolov3_defs(80, 416)


def test_parse_data_config_and_classes_match(tmp_path):
    d = tmp_path / "x.data"
    d.write_text("classes=12\n# c\ntrain=train.txt\nvalid=a.txt b.txt\n\n"
                 "num_workers=2\n")
    got = tcfg.parse_data_config(str(d))
    assert got == jcfg.parse_data_config(str(d))
    assert got["gpus"] == "0,1,2,3" and got["valid"] == ["a.txt", "b.txt"]
    n = tmp_path / "x.names"
    n.write_text("bicycle\nboat\n")
    assert tcfg.load_classes(str(n)) == jcfg.load_classes(str(n)) == [
        "bicycle", "boat"]


# -------------------------------------------------------- darknet .weights
def _jax_darknet_tree(defs, rng):
    model = JaxDarknet(defs, img_size=S)
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return model, _random_like(like, rng)


@pytest.mark.parametrize("cutoff", [-1, 15])
def test_save_darknet_weights_bytes_equal(tmp_path, rng, cutoff):
    jm, (jp, js) = _jax_darknet_tree(jax_tiny_defs(12, S), rng)
    header = np.array([0, 2, 0, 32013, 0], np.int32)
    jdw.save_darknet_weights(jm, jp, js, str(tmp_path / "j.weights"),
                             header=header, cutoff=cutoff)
    tm = Darknet(tiny_yolov3_defs(12, S), img_size=S)
    tp, ts = _as_port((jp, js))
    tdw.save_darknet_weights(tm, tp, ts, str(tmp_path / "t.weights"),
                             header=header, cutoff=cutoff)
    assert (tmp_path / "j.weights").read_bytes() == \
        (tmp_path / "t.weights").read_bytes()


@pytest.mark.parametrize("name,cutoff", [
    ("w.weights", None), ("yolov3-tiny.conv.15", 15),
    ("darknet53.conv.74", 75)])
def test_load_darknet_weights_matches(tmp_path, rng, name, cutoff):
    defs = (yolov3_defs(80, 64) if "53" in name
            else jax_tiny_defs(12, S))
    jm, (jp, js) = _jax_darknet_tree(defs, rng)
    path = str(tmp_path / name)
    jdw.save_darknet_weights(jm, jp, js, path,
                             header=np.array([0, 2, 0, 7, 0], np.int32),
                             cutoff=-1 if cutoff is None else cutoff)
    _, (tj, tjs) = _jax_darknet_tree(defs, rng)        # the templates
    want_p, want_s, want_h = jdw.load_darknet_weights(jm, tj, tjs, path)
    tm = Darknet(defs, img_size=S)
    tp, ts = _as_port((tj, tjs))
    got_p, got_s, got_h = tdw.load_darknet_weights(tm, tp, ts, path)
    _equal_trees((got_p, got_s), _as_port((want_p, want_s)))
    np.testing.assert_array_equal(got_h, want_h)
    assert got_h.dtype == np.int32 and got_h[3] == 7
    if cutoff:          # past the cutoff the template's own leaves
        _equal_trees((got_p[cutoff:], got_s[cutoff:]),
                     (tp[cutoff:], ts[cutoff:]))


def test_darknet_weights_size_mismatch_raises(tmp_path, rng):
    jm, (jp, js) = _jax_darknet_tree(jax_tiny_defs(12, S), rng)
    path = str(tmp_path / "w.weights")
    jdw.save_darknet_weights(jm, jp, js, path)
    with open(path, "ab") as f:
        f.write(np.zeros(3, np.float32).tobytes())
    tm = Darknet(tiny_yolov3_defs(12, S), img_size=S)
    tp, ts = _as_port((jp, js))
    for load, m, p, s in ((jdw.load_darknet_weights, jm, jp, js),
                          (tdw.load_darknet_weights, tm, tp, ts)):
        with pytest.raises(ValueError, match="size mismatch"):
            load(m, p, s, path)


# ------------------------------------------------------------------ .npz
def test_save_checkpoint_of_tracked_tree(tmp_path):
    """The tracked checkpoint's tree, saved by the port: the same keys
    and bytes, and the JAX package's load_checkpoint reads it."""
    _, p, s = build_fusion(CKPT, "f32", device="cpu")
    path = str(tmp_path / "a.npz")
    tck.save_checkpoint(path, {"params": p, "state": s})
    with np.load(CKPT) as z0, np.load(path) as z1:
        assert z0.files == z1.files
        for k in z0.files:
            assert z0[k].dtype == z1[k].dtype and z0[k].shape == z1[k].shape
            assert z0[k].tobytes() == z1[k].tobytes(), k
    model, like = _jax_fusion()
    got = jck.load_checkpoint(path, {"params": like[0], "state": like[1]})
    want = jck.load_checkpoint(CKPT, {"params": like[0],
                                      "state": like[1]})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def _odd_tree(rng):
    """Unsorted dict keys, a list past 10 items, empty containers, an
    int8 leaf, a 4-D kernel and a scalar."""
    return {"z": [rng.standard_normal(2).astype(np.float32)
                  for _ in range(12)],
            "a": {"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                  "q": rng.integers(-127, 128, (2, 5)).astype(np.int8),
                  "e": {}},
            "m": ({}, np.float32(2.5), [])}


def test_leaf_order_matches_jax(rng):
    import collections
    nt = collections.namedtuple("NT", ["second", "first"])
    tree = dict(_odd_tree(rng), n=None, t=nt(np.ones(1), [np.ones(2)]))
    assert [k for k, _ in tck.leaf_items(tree)] == \
        [k for k, _ in jck._leaf_items(tree)]


def test_checkpoint_round_trips_with_jax(tmp_path, rng):
    """JAX writes, the port reads (4-D leaves OIHW, int8 kept) and
    writes back the JAX package's bytes; either loader refuses a template
    with another leaf count or key."""
    tree = _odd_tree(rng)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, tree)
    like = tck.convert(tree, {})[0]
    got = tck.load_checkpoint(jpath, like)
    assert got["a"]["w"].shape == (4, 2, 3, 3)
    assert got["a"]["q"].dtype == torch.int8
    assert list(got) == list(tree) and got["a"]["e"] == {}
    _equal_trees(got, tck.convert(jck.load_checkpoint(jpath, tree), {})[0])
    tck.save_checkpoint(tpath, got)
    with np.load(jpath) as z0, np.load(tpath) as z1:
        assert z0.files == z1.files
        assert all(z0[k].dtype == z1[k].dtype
                   and z0[k].tobytes() == z1[k].tobytes() for k in z0.files)
    short = dict(tree, z=tree["z"][:-1])
    renamed = dict(tree, y=tree["z"])
    del renamed["z"]
    for load, tmpl in ((jck.load_checkpoint, lambda t: t),
                       (tck.load_checkpoint,
                        lambda t: tck.convert(t, {})[0])):
        with pytest.raises(ValueError, match="leaves, template has"):
            load(jpath, tmpl(short))
        with pytest.raises(ValueError, match="!= template key"):
            load(jpath, tmpl(renamed))


# ----------------------------------------------------------- torch fills
def _darknet_sd(plan, prefix, rng):
    sd = {}
    for i, info in enumerate(plan):
        if info["type"] != "convolutional":
            continue
        k, c = info["size"], info["filters"]
        base = f"{prefix}module_list.{i}"
        sd[f"{base}.conv_{i}.weight"] = rng.standard_normal(
            (c, info["in_ch"], k, k)).astype(np.float32)
        if info["bn"]:
            bn = f"{base}.batch_norm_{i}"
            _bn_sd(sd, bn, c, rng)
            sd[f"{bn}.num_batches_tracked"] = np.asarray(3)
        else:
            sd[f"{base}.conv_{i}.bias"] = rng.standard_normal(c).astype(
                np.float32)
    return sd


def _lin_sd(sd, key, out_d, in_d, rng):
    sd[f"{key}.weight"] = rng.standard_normal((out_d, in_d)).astype(
        np.float32)
    sd[f"{key}.bias"] = rng.standard_normal(out_d).astype(np.float32)


def _conv_sd(sd, key, cout, cin, k, rng):
    sd[f"{key}.weight"] = rng.standard_normal((cout, cin, k, k)).astype(
        np.float32)
    sd[f"{key}.bias"] = rng.standard_normal(cout).astype(np.float32)


def _bn_sd(sd, key, c, rng):
    for name in ("weight", "bias", "running_mean"):
        sd[f"{key}.{name}"] = rng.standard_normal(c).astype(np.float32)
    sd[f"{key}.running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)


def _fusion_sd(plan, rng, module2=False):
    """A module3 (or module2) Network state dict: tests/test_io.py's."""
    sd = _darknet_sd(plan, "base_detector.", rng)
    stack = "fcn_layers" if module2 else "img_cnn_layers"
    _conv_sd(sd, f"{stack}.net.conv_0", 490, 256, 1, rng)
    _bn_sd(sd, f"{stack}.net.batch_norm_0", 490, rng)
    if not module2:
        for i, (cin, cout) in enumerate(((3, 32), (32, 64), (64, 128))):
            _conv_sd(sd, f"radar_cnn_layers.conv{i + 1}.0", cout, cin, 3,
                     rng)
            _bn_sd(sd, f"radar_cnn_layers.conv{i + 1}.1", cout, rng)
        _conv_sd(sd, "radar_cnn_layers.conv3.3", 10, 128, 1, rng)
    _lin_sd(sd, "refinement_head.net0.0", 256, 490, rng)
    _lin_sd(sd, "refinement_head.net1.0", 4, 256, rng)
    _lin_sd(sd, "refinement_head.net2.0", 13, 256, rng)
    if not module2:
        _conv_sd(sd, "refinement_head.radar_net.0", 10, 10, 7, rng)
        _bn_sd(sd, "refinement_head.radar_net.1", 10, rng)
        _conv_sd(sd, "refinement_head.radar_net.3", 1, 10, 1, rng)
    _lin_sd(sd, "ensemble_head.fc1.0", 32, 2, rng)
    _lin_sd(sd, "ensemble_head.fc2.0", 2, 32 * (13 if module2 else 2), rng)
    return sd


def _port_fusion(module2=False):
    build = build_refine if module2 else build_fusion
    return build(None, "f32", img_size=S, device="cpu")


def test_fill_darknet_matches(rng):
    jm, like = _jax_fusion()
    tm, tp, ts = _port_fusion()
    sd = _darknet_sd(tm.darknet._plan, "", rng)
    want = jtc.fill_darknet(jm.darknet, like[0]["darknet"],
                            like[1]["darknet"], sd)
    got = ttc.fill_darknet(tm.darknet, tp["darknet"], ts["darknet"], sd)
    _equal_trees(got, _as_port(want))


def test_ultralytics_pt_matches(tmp_path, rng):
    """An ultralytics-style container pickling an nn.Module (chip_smoke's
    writer), loaded by position and by key, and a raw state dict under
    foreign key names, by position."""
    jm, like = _jax_fusion()
    tm, tp, ts = _port_fusion()
    sd = _darknet_sd(tm.darknet._plan, "", rng)
    src = ttc.fill_darknet(tm.darknet, tp["darknet"], ts["darknet"], sd)
    path = str(tmp_path / "w.pt")
    torch.save({"model": cs.darknet_module(torch, tm.darknet, *src),
                "epoch": 3}, path)
    foreign = str(tmp_path / "f.pt")
    torch.save({f"x.{i}.{k.split('.')[-1]}": torch.from_numpy(np.asarray(v))
                for i, (k, v) in enumerate(sd.items())}, foreign)
    for p in (path, foreign):
        want = jtc.load_ultralytics_pt(jm.darknet, like[0]["darknet"],
                                       like[1]["darknet"], p)
        got = ttc.load_ultralytics_pt(tm.darknet, tp["darknet"],
                                      ts["darknet"], p)
        _equal_trees(got, _as_port(want))
        _equal_trees(got, src)
    _equal_trees(load_weights_any(tm.darknet, tp["darknet"], ts["darknet"],
                                  path), src)


def test_fill_fusion_network_matches(tmp_path, rng):
    jm, like = _jax_fusion()
    tm, tp, ts = _port_fusion()
    sd = _fusion_sd(tm.darknet._plan, rng)
    path = str(tmp_path / "fusion.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    want = jtc.fill_fusion_network(jm, like[0], like[1],
                                   jtc.read_state_dict(path))
    got = ttc.fill_fusion_network(tm, tp, ts, ttc.read_state_dict(path))
    _equal_trees(got, _as_port(want))
    _equal_trees(load_weights_any(tm, tp, ts, path), got)
    assert ttc.read_state_dict(path)[
        "base_detector.module_list.0.batch_norm_0.num_batches_tracked"
    ].dtype == torch.int64


def test_fill_refine_network_and_module2_pretrain_match(rng):
    jm, like = _jax_fusion(JaxRefine, class_num=12)
    tm, tp, ts = _port_fusion(module2=True)
    sd = _fusion_sd(tm.darknet._plan, rng, module2=True)
    want = jtc.fill_refine_network(jm, like[0], like[1], sd)
    got = ttc.fill_refine_network(tm, tp, ts, sd)
    _equal_trees(got, _as_port(want))
    # module2 -> module3: img_cnn and the refinement nets, frozen
    jf, flike = _jax_fusion()
    fp, fs = _random_like(flike, rng)
    wp, ws, wfrozen = jtc.load_module2_pretrain(fp, fs, sd)
    gp, gs, gfrozen = ttc.load_module2_pretrain(*_as_port((fp, fs)), sd)
    _equal_trees((gp, gs), _as_port((wp, ws)))
    assert gfrozen == wfrozen == {"img_cnn": True, "refine_nets": True}


# ---------------------------------------------------- load_weights_any
def test_load_weights_any_matches(tmp_path, rng):
    """Each format through both packages' load_weights_any into the same
    template; the .weights file through load_fusion (the JAX package's
    _load_fusion unpacks the header into its pair and raises, so its
    backbone comes from load_weights_any on the Darknet)."""
    jm, like = _jax_fusion()
    jp, js = _random_like(like, rng)
    tm, tp, ts = _port_fusion()
    files = cs.write_weight_files(torch, str(tmp_path), tm,
                                  *_as_port((jp, js)))
    init = _as_port((jp, js))
    jinit = jax.tree.map(lambda a: a * 0 + 1, (jp, js))
    for fmt in ("npz", "pth"):
        want = jax_load_any(jm, *jinit, files[fmt])
        got = load_weights_any(tm, tp, ts, files[fmt])
        _equal_trees(got, _as_port(want))
        _equal_trees(got, init)
    wp, ws, wh = jax_load_any(jm.darknet, jinit[0]["darknet"],
                              jinit[1]["darknet"], files["weights"])
    gp, gs, gh = load_weights_any(tm.darknet, tp["darknet"], ts["darknet"],
                                  files["weights"])
    _equal_trees((gp, gs), _as_port((wp, ws)))
    np.testing.assert_array_equal(gh, wh)
    fp, fs = load_fusion(tm, tp, ts, files["weights"])
    _equal_trees((fp["darknet"], fs["darknet"]), (gp, gs))
    _equal_trees((fp["refine"], fs["refine"]), (tp["refine"], ts["refine"]))
    with pytest.raises(ValueError, match="unknown weight format"):
        load_weights_any(tm, tp, ts, str(tmp_path / "w.bin"))


@pytest.mark.parametrize("fmt,rel", [
    ("npz", "darknet53.conv.74_x/fusion.npz"),
    ("npz", "yolov3-tiny.conv.15.npz"),
    ("pth", "yolov3-tiny.conv.15_runs/module3.pth"),
    ("weights", "darknet53.conv.74_x/fusion.weights")])
def test_backbone_names_count_only_as_file_names(tmp_path, fmt, rel):
    """A file whose path holds a backbone file's conventional name
    (``darknet53.conv.74``, ``yolov3-tiny.conv.15``) other than as its
    own name loads as its extension says: a .npz or .pth whole, a
    .weights whole with its size checked."""
    _, ck_p, ck_s = build_fusion(CKPT, "f32", img_size=S, device="cpu")
    model, init_p, init_s = build_fusion(None, "f32", img_size=S,
                                         device="cpu")
    files = cs.write_weight_files(torch, str(tmp_path), model, ck_p, ck_s)
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    os.replace(files[fmt], path)
    got = load_fusion(model, init_p, init_s, str(path))
    if fmt != "weights":
        _equal_trees(got, (ck_p, ck_s))
        return
    _equal_trees((got[0]["darknet"], got[1]["darknet"]),
                 (ck_p["darknet"], ck_s["darknet"]))
    with open(path, "ab") as f:
        f.write(np.zeros(3, np.float32).tobytes())
    with pytest.raises(ValueError, match="size mismatch"):
        load_fusion(model, init_p, init_s, str(path))


def test_build_fusion_from_every_format(tmp_path):
    """build_fusion on a file of each format written from the tracked
    checkpoint gives its tree; the conv.15 file fills blocks 0-14 over
    the seed-0 init; a darknet .cfg path builds the same model."""
    _, ck_p, ck_s = build_fusion(CKPT, "f32", img_size=S, device="cpu")
    model, init_p, init_s = build_fusion(None, "f32", img_size=S,
                                         device="cpu")
    files = cs.write_weight_files(torch, str(tmp_path), model, ck_p, ck_s)
    for fmt in ("npz", "pth"):
        _equal_trees(build_fusion(files[fmt], "f32", img_size=S,
                                  device="cpu")[1:], (ck_p, ck_s))
    got = build_fusion(files["weights"], "f32", img_size=S, device="cpu")
    _equal_trees((got[1]["darknet"], got[2]["darknet"]),
                 (ck_p["darknet"], ck_s["darknet"]))
    _equal_trees((got[1]["img_cnn"], got[2]["img_cnn"]),
                 (init_p["img_cnn"], init_s["img_cnn"]))
    got = build_fusion(files["tiny15"], "f32", img_size=S, device="cpu")
    _equal_trees(got[1]["darknet"][:15], ck_p["darknet"][:15])
    _equal_trees(got[1]["darknet"][15:], init_p["darknet"][15:])
    cfg = str(tmp_path / "tiny.cfg")
    cs.write_cfg(tiny_yolov3_defs(12, S), cfg)
    m2 = build_fusion(files["npz"], "pallas_max_s01", img_size=S,
                      device="cpu", model_def=cfg)[0]
    assert m2.darknet._plan == model.darknet._plan
    assert m2.darknet.stem_stages == (0, 2) and m2.darknet.stem_pair
    assert build_darknet(cfg, img_size=S)._plan == model.darknet._plan


# -------------------------------------------------------------- artifacts
def test_artifacts_root_matches():
    assert tart.REPO_ROOT == jart.REPO_ROOT
    assert tart.ARTIFACTS == jart.ARTIFACTS


@pytest.mark.parametrize("case", ["exists", "mirror", "non_default",
                                  "missing"])
def test_resolve_checkpoint_matches(tmp_path, monkeypatch, capsys, case):
    art = tmp_path / "artifacts"
    os.makedirs(art)
    for mod in (tart, jart):
        monkeypatch.setattr(mod, "ARTIFACTS", str(art))
    default = tmp_path / "runs" / "synthetic" / "stage3_final.npz"
    path = {"exists": tmp_path / "runs" / "stage3_final.npz",
            "mirror": default,
            "non_default": tmp_path / "runs" / "exp" / "stage3_final.npz",
            "missing": default}[case]
    if case == "exists":
        path.parent.mkdir()
        path.write_bytes(b"x")
    if case != "missing":
        (art / "stage3_final.npz").write_bytes(b"y")
    out = []
    for mod in (tart, jart):
        try:
            out.append(("ok", mod.resolve_checkpoint(str(path)),
                        capsys.readouterr().out))
        except FileNotFoundError as e:
            out.append(("raised", str(e), capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[0][0] == ("raised" if case in ("non_default", "missing")
                         else "ok")


def test_mirror_checkpoint_matches(tmp_path, monkeypatch):
    src = tmp_path / "stage3_final.npz"
    src.write_bytes(b"payload")
    got = []
    for mod, name in ((tart, "t"), (jart, "j")):
        monkeypatch.setattr(mod, "ARTIFACTS", str(tmp_path / name))
        dst = mod.mirror_checkpoint(str(src))
        got.append((os.path.relpath(dst, tmp_path / name),
                    open(dst, "rb").read()))
    assert got[0] == got[1] == ("stage3_final.npz", b"payload")
