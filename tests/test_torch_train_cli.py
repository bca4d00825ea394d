"""The port's trainer and training CLI on the CPU (plain versions):
``train/recipes.py:Trainer`` checkpoints read by the JAX package's
``Trainer.resume`` and the other way round, ``cli.train.main`` of both
packages on stage 1 from one JAX-written ``.npz``, and the port's
stage 3 with ``--fold_frozen`` (and ``--device_cache``) and stage 2 from
a fusion ``.npz`` end to end, at 64 px (stage 3 at 128) on
``SyntheticScenes``.

Tolerances: checkpoints cross-load leaf for leaf, bit-equal. Stage 1 in
both CLIs (4 scenes, batch 2, every_k 2: two steps, one Adam update at
lr 5e-4, no random draw, the numpy-seeded loader): the BN statistics
within 1e-5 relative of each leaf's largest (float32 summation order);
every parameter within 2 lr of the JAX package's (Adam's first update is
-lr g / (|g| + eps), so an element whose gradient is rounding noise may
step either way; test_torch_train.py holds each element to what the two
gradients explain), and 99.9% of them within 1e-6.
"""
import os

import jax
import numpy as np
import pytest
import torch

from millieye_torch.cli import train as tcli
from millieye_torch.cli._common import build_darknet
from millieye_torch.data.loader import DataLoader, PaddedCollate
from millieye_torch.data.synthetic import SyntheticScenes
from millieye_torch.io.checkpoint import (convert, leaf_items,
                                          load_checkpoint, save_checkpoint)
from millieye_torch.train import optim as topt
from millieye_torch.train import recipes as trec
from millieye_torch.train.steps import generator_draw
from millieye_tpu.cli import train as jcli
from millieye_tpu.io.checkpoint import load_checkpoint as jload
from millieye_tpu.io.checkpoint import save_checkpoint as jsave
from millieye_tpu.models import Darknet as JDarknet
from millieye_tpu.models import tiny_yolov3_defs as jdefs
from millieye_tpu.train import recipes as jrec

torch.set_num_threads(1)

CKPT = "artifacts/stage3_final.npz"
S = 64
FUSION_S = 128       # image proposals with positives: the ensemble trains
LR = 5e-4


def _jax_tree(tp, ts, jdark, path):
    """The port's tree written by the port and read by JAX."""
    save_checkpoint(path, {"params": tp, "state": ts})
    like = jax.eval_shape(jdark.init, jax.random.PRNGKey(0))
    return jload(path, {"params": like[0], "state": like[1]})


def _same(port_tree, jax_tree):
    want = leaf_items(convert(jax.tree.map(np.asarray, jax_tree), [])[0])
    got = topt.tree_leaves(port_tree)
    assert len(want) == len(got)
    for (key, w), g in zip(want, got):
        assert torch.equal(g, w), key


def _loader(n=4, batch=2):
    return DataLoader(SyntheticScenes(n, seed=3, radar=False), batch,
                      PaddedCollate(S, max_targets=16), shuffle=True, seed=0)


def test_trainer_checkpoints_cross_load(tmp_path):
    """Port fit -> save -> the JAX Trainer.resume holds the same tree; JAX
    save -> the port's Trainer.resume holds JAX's."""
    tdark = build_darknet(img_size=S)
    jdark = JDarknet(jdefs(num_classes=12, img_size=S), img_size=S)
    tp, ts = tdark.init(torch.Generator().manual_seed(0))
    tr = trec.yolo_trainer(tdark, tp, ts, str(tmp_path / "port"),
                           log_every=1)
    out = tr.fit(_loader(), 1, None,
                 lambda b: trec.fusion_device_batch(b, S, "cpu"))
    assert out.step == 2
    path = str(tmp_path / "port" / "yolo_ckpt_0.npz")
    assert os.path.exists(path)
    with open(tmp_path / "port" / "logs" / "metrics.jsonl") as f:
        assert len(f.read().splitlines()) == 2          # log_every 1

    r = _jax_tree(tp, ts, jdark, str(tmp_path / "init.npz"))
    jtr = jrec.yolo_trainer(jdark, r["params"], r["state"],
                            str(tmp_path / "jax"))
    jtr.resume(path)
    _same(tr.ts.params, jtr.ts.params)
    _same(tr.ts.state, jtr.ts.state)

    jp = jax.tree.map(lambda a: a * 1.5, jtr.ts.params)
    jtr.ts = jtr.ts._replace(params=jp)
    tr.resume(jtr.save(7))
    _same(tr.ts.params, jp)


def test_train_cli_stage1_matches_jax(tmp_path):
    """Both CLIs, stage 1 from the same JAX-written checkpoint: the final
    checkpoints agree within the module's tolerance."""
    tdark = build_darknet(img_size=S)
    jdark = JDarknet(jdefs(num_classes=12, img_size=S), img_size=S)
    tp, ts = tdark.init(torch.Generator().manual_seed(5))
    r = _jax_tree(tp, ts, jdark, str(tmp_path / "port.npz"))
    start = str(tmp_path / "start.npz")
    jsave(start, r)                                     # JAX-written
    args = ["--stage", "yolo", "--synthetic", "4", "--epochs", "1",
            "--batch_size", "2", "--img_size", str(S), "--checkpoint",
            start]
    jcli.main(args + ["--checkpoint_dir", str(tmp_path / "j")])
    trainer = tcli.main(args + ["--checkpoint_dir", str(tmp_path / "t"),
                                "--device", "cpu"])
    assert trainer.ts.step == 2
    final = {}
    for d in ("j", "t"):
        with np.load(tmp_path / d / "yolo_ckpt_final.npz") as z:
            final[d] = {k.split("|", 1)[1]: z[k] for k in z.files}
    assert final["j"].keys() == final["t"].keys()
    close = total = 0
    moved = False
    with np.load(start) as z0:
        start_arrays = {k.split("|", 1)[1]: z0[k] for k in z0.files}
    for key, w in final["j"].items():
        g = final["t"][key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key.startswith("state/"):
            np.testing.assert_allclose(g, w, rtol=0, err_msg=key,
                                       atol=1e-5 * np.abs(w).max())
            continue
        d = np.abs(g - w)
        assert d.max(initial=0) <= 2 * LR + 1e-6, key
        close += int((d <= 1e-6).sum())
        total += d.size
        moved |= not np.array_equal(g, start_arrays[key])
    assert moved
    assert close >= 0.999 * total, (close, total)


def test_train_cli_fusion_fold_frozen_cpu(tmp_path):
    """Stage 3 with --fold_frozen from the tracked checkpoint, the data
    on a device cache: the frozen leaves (Darknet, img_cnn, refine nets
    0-2) and the Darknet's BN statistics bit-identical after the run, the
    radar encoder, refine.radar_net and the ensemble moved, everything
    finite; one more step reports a finite loss and no reverted
    element."""
    trainer = tcli.main(["--stage", "fusion", "--fold_frozen",
                         "--synthetic", "4", "--epochs", "1",
                         "--batch_size", "2", "--img_size", str(FUSION_S),
                         "--checkpoint", CKPT, "--device_cache",
                         "--checkpoint_dir", str(tmp_path), "--device",
                         "cpu"])
    assert trainer.ts.step == 2
    assert trainer.step.__qualname__.startswith("make_fusion_train_step")
    model_params = trainer.ts.params
    template = {"params": model_params, "state": trainer.ts.state}
    start = load_checkpoint(CKPT, template)
    labels = topt.label_tree(model_params, topt.STAGE3_FROZEN)
    for lab, a, b in zip(topt.tree_leaves(labels),
                         topt.tree_leaves(model_params),
                         topt.tree_leaves(start["params"])):
        assert torch.isfinite(a).all()
        if lab == "freeze":
            assert torch.equal(a, b)
    for top in ("radar_enc", "ensemble"):
        assert any(not torch.equal(a, b) for a, b in zip(
            topt.tree_leaves(model_params[top]),
            topt.tree_leaves(start["params"][top])))
    assert any(not torch.equal(a, b) for a, b in zip(
        topt.tree_leaves(model_params["refine"]["radar_net"]),
        topt.tree_leaves(start["params"]["refine"]["radar_net"])))
    for a, b in zip(topt.tree_leaves(trainer.ts.state["darknet"]),
                    topt.tree_leaves(start["state"]["darknet"])):
        assert torch.equal(a, b)
    assert os.path.exists(tmp_path / "module3_ckpt_final.npz")

    batch = next(iter(tcli._make_loader(
        SyntheticScenes(2, seed=9), tcli.parse_args(
            ["--stage", "fusion", "--batch_size", "2", "--img_size",
             str(FUSION_S)]), "cpu", radar=True)))
    _, metrics = trainer.step(trainer.ts,
                              trec.fusion_device_batch(batch, FUSION_S,
                                                       "cpu"),
                              generator_draw(torch.Generator()))
    assert torch.isfinite(metrics["loss"])
    assert int(metrics["nonfinite_reverted"]) == 0


def test_train_cli_refine_from_fusion_npz(tmp_path):
    """Stage 2 with --pretrained a fusion .npz: the Darknet and score-map
    stack come from it (the Darknet stays frozen, bit-identical), the
    seed-0 heads train."""
    trainer = tcli.main(["--stage", "refine", "--synthetic", "4",
                         "--epochs", "1", "--batch_size", "2",
                         "--img_size", str(S), "--pretrained", CKPT,
                         "--checkpoint_dir", str(tmp_path), "--device",
                         "cpu"])
    with np.load(CKPT) as z:
        ckpt = {k.split("|", 1)[1]: z[k] for k in z.files}
    got = leaf_items({"params": trainer.ts.params})
    for key, leaf in got:
        if key.startswith("params/darknet/"):
            want = ckpt[key]
            if leaf.dim() == 4:
                leaf = leaf.permute(2, 3, 1, 0)
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=key)
    assert os.path.exists(tmp_path / "module2_ckpt_final.npz")
    for leaf in topt.tree_leaves(trainer.ts.params):
        assert torch.isfinite(leaf).all()


@pytest.mark.parametrize("flag", ["--data_parallel", "--model_parallel"])
def test_train_cli_refuses_several_devices(flag):
    with pytest.raises(SystemExit, match="ROADMAP.md §1 item 9"):
        tcli.main(["--stage", "yolo", "--synthetic", "2", flag, "2",
                   "--device", "cpu"])
