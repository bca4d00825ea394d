"""``cli.train --data_parallel N --model_parallel M`` of the port on gloo
ranks on the CPU against the same CLI in one process
(``tests/test_parallel.py:test_train_cli_data_parallel_matches_single``'s
contract): ``--stage fusion --synthetic 8 --epochs 1 --batch_size 8
--img_size 128 --seed 3`` at dp 4 x mp 2, the epoch-end checkpoints
compared key for key at rtol 2e-4 and atol 2e-5, at ``--grad_accum 2``
(the JAX contract: no optimizer update, the BN statistics move) and at
``--grad_accum 1`` (one Adam update: the radar branch and the ensemble
move; stage 3 freezes the sharded leaves); stages 1 and 2 at dp 2 x mp 2
at ``--grad_accum 1``. The losses of the step agree within 1e-5
relative.

Adam's first update is -lr g / (|g| + eps): an element whose gradient
is rounding noise steps by up to +-lr on either side. So a trained
element beyond the key tolerance passes only within what the two runs'
gradients explain (``_hold``), and such elements stay below 1e-5 of the
trained ones, leaving out the conv biases that feed a train-mode BN
(``bn_fed``): their exact gradient is 0, so every element of theirs is
rounding noise in both runs.
"""
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from millieye_torch.cli import train as tcli
from millieye_torch.cli._common import build_fusion
from millieye_torch.io.checkpoint import _to_file, leaf_items

torch.set_num_threads(1)

LR = 5e-4
EPS = 1e-8
TIMEOUT = 300


def load_raw(path):
    with np.load(path, allow_pickle=False) as z:
        keys = sorted(z.files, key=lambda k: int(k.split("|")[0]))
        return keys, [z[k] for k in keys]


def bn_fed(names):
    """The leaves of ``names`` (parameter paths) that are a conv's bias
    feeding a train-mode BN: a stage of ``{w, b, bn}`` (the score-map
    stack, the radar encoder) and the refinement head's ``conv7``."""
    return {n for n in names if n.endswith("/b") and (
        n[:-1] + "bn/gamma" in names or n.endswith("radar_net/conv7/b"))}


def _hold(ks, flat_s, flat_m, mu1, mu2):
    """Every key of the two checkpoints at rtol 2e-4 and atol 2e-5, or,
    for a trained element, within lr |u_1 - u_mesh| + 1e-7 (u = g / (|g|
    + eps), g = 10 mu after Adam's first update); returns (the trained
    elements outside the key tolerance, not counting ``bn_fed``'s, the
    trained elements)."""
    noise = bn_fed(set(mu1))
    explained_n = trained_n = 0
    for k, a, b in zip(ks, flat_s, flat_m):
        assert a.shape == b.shape, k
        d = np.abs(a.astype(np.float64) - b)
        ok = d <= 2e-5 + 2e-4 * np.abs(b)
        name = k.split("|", 1)[1].split("/", 1)[1]
        if k.split("|", 1)[1].startswith("params/") and name in mu1:
            g1, g2 = (10.0 * m.numpy().astype(np.float64)
                      for m in (mu1[name], mu2[name]))
            if g1.ndim == 4:
                g1, g2 = (g.transpose(2, 3, 1, 0) for g in (g1, g2))
            explained = LR * np.abs(g1 / (np.abs(g1) + EPS)
                                    - g2 / (np.abs(g2) + EPS))
            assert (ok | (d <= explained + 1e-7)).all(), k
            if name not in noise:
                explained_n += int((~ok).sum())
                trained_n += a.size
        else:
            assert ok.all(), k
    return explained_n, trained_n


@pytest.mark.parametrize("grad_accum", ["2", "1"])
def test_train_cli_data_parallel_matches_single(tmp_path, grad_accum):
    common = ["--stage", "fusion", "--synthetic", "8", "--epochs", "1",
              "--batch_size", "8", "--img_size", "128", "--seed", "3",
              "--grad_accum", grad_accum, "--lr", str(LR), "--device",
              "cpu"]
    single = ranks.TrainProbe()
    trainer = tcli.main(common + ["--checkpoint_dir",
                                  str(tmp_path / "single")], probe=single)
    out = tcli.main(common + ["--checkpoint_dir", str(tmp_path / "mesh"),
                              "--data_parallel", "4", "--model_parallel",
                              "2"],
                    probe=ranks.TrainProbe(), timeout=TIMEOUT)
    assert [(o["data"], o["model"]) for o in out] == [
        (d, m) for d in range(4) for m in range(2)]
    for o in out:
        np.testing.assert_allclose(o["report"]["losses"], single.losses,
                                   rtol=1e-5)

    ks, flat_s = load_raw(str(tmp_path / "single" /
                              "module3_ckpt_final.npz"))
    km, flat_m = load_raw(str(tmp_path / "mesh" / "module3_ckpt_final.npz"))
    assert ks == km and len(flat_s) > 50
    explained_n, trained_n = _hold(ks, flat_s, flat_m,
                                   single.report(trainer)["mu"],
                                   out[0]["report"]["mu"])
    assert explained_n <= 1e-5 * trained_n, explained_n
    _, p0, _ = build_fusion(None, img_size=128, device="cpu")
    start = {k: _to_file(v) for k, v in leaf_items({"params": p0})}
    moved = sum(k.split("|", 1)[1] in start
                and not np.array_equal(a, start[k.split("|", 1)[1]])
                for k, a in zip(ks, flat_s))
    # at --grad_accum 1 the trained leaves moved; at 2 none did
    assert (moved > 10) == (grad_accum == "1"), moved


STAGE_FILES = {"yolo": "yolo_ckpt_final.npz",
               "refine": "module2_ckpt_final.npz"}
# stage 2 from the tracked checkpoint's Darknet and score map (seed-0
# heads) at 256 px: from the seed-0 init, or at 128 px, no proposal
# matches a target, the loss is 0 and nothing trains
# the leaves the shape rule shards over "model" (JAX's 7, as each stage
# names them)
SHARDED = {"yolo": ["8/w", "13/w", "21/w"],
           "refine": ["fcn/0/w", "refine/net0/w", "refine/net1/w",
                      "refine/net2/w"]}
STAGE_ARGS = {"yolo": [],
              "refine": ["--img_size", "256", "--pretrained",
                         "artifacts/stage3_final.npz"]}
# the gradients' tolerance (of the leaf's largest, of the tree's largest)
# and the most trained elements beyond the key tolerance, a stage. Stage
# 1 trains a seed-0 Darknet whose gradient is ill-conditioned in its BN
# statistics: in one process alone, computing the Darknet BN's mean and
# variance as sums over the count instead of x.mean / x.var moves the
# gradient of darknet/14/w by 1.0e-2 of its largest and 2/w by 9e-4, and
# the mesh differs from one process by as much (1.0e-2 on 14/w, 1705 of
# 8.7M elements beyond the key tolerance, each explained by the
# gradients). Stage 2 stays below 3e-4 and 0 elements.
GRAD_TOL = {"yolo": (3e-2, 1e-4), "refine": (1e-3, 1e-5)}
BEYOND = {"yolo": 1e-3, "refine": 1e-5}


@pytest.mark.parametrize("stage", ["yolo", "refine"])
def test_train_cli_stages_1_and_2_mesh(tmp_path, stage):
    """Stages 1 and 2 at dp 2 x mp 2, one Adam update: the sharded leaves
    (the Darknet's 256-wide convolutions in stage 1; the score map and
    ``net0``-``net2`` in stage 2) train, which holds the tensor-parallel
    backward, the global ``_masked_mean`` and the synced Darknet BN.

    The checkpoints as ``_hold`` holds them, at most ``BEYOND`` of the
    trained elements beyond the key tolerance, and the gradients (Adam's
    first moment after the first update, mu = 0.1 g) within ``GRAD_TOL``
    of each leaf's largest plus of the tree's largest."""
    common = ["--stage", stage, "--synthetic", "8", "--epochs", "1",
              "--batch_size", "8", "--img_size", "128", "--seed", "3",
              "--grad_accum", "1", "--lr", str(LR), "--device", "cpu"
              ] + STAGE_ARGS[stage]
    single = ranks.TrainProbe()
    trainer = tcli.main(common + ["--checkpoint_dir",
                                  str(tmp_path / "single")], probe=single)
    out = tcli.main(common + ["--checkpoint_dir", str(tmp_path / "mesh"),
                              "--data_parallel", "2", "--model_parallel",
                              "2"],
                    probe=ranks.TrainProbe(), timeout=TIMEOUT)
    rep = out[0]["report"]
    assert single.losses[0] > 0
    np.testing.assert_allclose(rep["losses"], single.losses, rtol=1e-5)
    mu1 = single.report(trainer)["mu"]
    mu2 = rep["mu"]
    assert sorted(mu1) == sorted(mu2)
    # every leaf that the mesh shards over "model" has a gradient
    for k in SHARDED[stage]:
        assert float(mu1[k].abs().max()) > 0, k
    top = max(float(v.abs().max()) for v in mu1.values())
    leaf_tol, top_tol = GRAD_TOL[stage]
    for k in mu1:
        a, b = mu1[k], mu2[k]
        tol = leaf_tol * float(a.abs().max()) + top_tol * top
        torch.testing.assert_close(b, a, rtol=0, atol=tol, msg=k)

    ks, flat_s = load_raw(str(tmp_path / "single" / STAGE_FILES[stage]))
    km, flat_m = load_raw(str(tmp_path / "mesh" / STAGE_FILES[stage]))
    assert ks == km
    explained_n, trained_n = _hold(ks, flat_s, flat_m, mu1, mu2)
    assert trained_n > 0 and explained_n <= BEYOND[stage] * trained_n, \
        explained_n
