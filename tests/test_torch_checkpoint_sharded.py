"""Port parity: ``io/checkpoint.py:save_sharded`` / ``load_sharded``
against the JAX package's ``save_orbax`` / ``load_orbax``
(``tests/test_train.py:test_orbax_roundtrip``'s contract) on the same
trees, and written by every rank of a dp 2 x mp 2 mesh.

* the ``ensemble`` tree of ``test_orbax_roundtrip`` and the whole fusion
  ``{"params", "state"}`` tree, both from the tracked checkpoint: the
  containers and key paths of ``load_orbax``'s tree, every leaf
  bit-identical to it (through ``convert``: 4-D leaves OIHW);
* dtypes: bfloat16, float16, int8 and int32 leaves made from one numpy
  draw in both packages, through both pairs; a ``fold_for_serving`` tree
  at ``int8`` and at ``pallas_max_s01`` (int8 and bfloat16 leaves) with
  a float16 head, and a ``TrainState`` with its step counter, each equal
  to what went in and, where the ``.npz`` can hold it, to
  ``load_checkpoint(save_checkpoint(...))``;
* an existing path to save onto, a missing one to load from, a named
  tuple with an int field: as JAX's pair;
* a gloo world of 4 CPU ranks (dp 2 x mp 2) after one stage-3
  ``--fold_frozen`` step of ``cli.train``: every rank saves, one process
  loads the state bit-identical to ``gather_params`` of the mesh's, the
  parameters and BN state to the gathered ``.npz`` the CLI wrote, and
  each rank's leaves to the loaded tree cut by the shape rule; the
  score-map weight's two "model" slices differ, so a checkpoint that
  kept one slice for both (one key) fails.

Tolerance: equality everywhere (no arithmetic moves a value).
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from millieye_torch import parallel
from millieye_torch.cli import train as tcli
from millieye_torch.cli._common import build_fusion
from millieye_torch.io import checkpoint as tck
from millieye_torch.parallel.mesh import _shard
from millieye_torch.runtime.engine import fold_for_serving
from millieye_torch.train.optim import STAGE3_FROZEN, frozen_adam, tree_map
from millieye_torch.train.steps import init_train_state
from millieye_tpu.io import checkpoint as jck
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_tiny_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxFusion

torch.set_num_threads(1)

S = 128
CKPT = "artifacts/stage3_final.npz"
TIMEOUT = 300


def _containers(tree):
    """The tree's containers with every leaf replaced by its kind:
    "leaf", or a Python scalar's value."""
    if isinstance(tree, dict):
        return {k: _containers(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_containers(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    return "leaf"


def _bits(x):
    """A leaf's dtype name and bytes (bfloat16 as its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.dtype).split(".")[1], x.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def _same_tree(got, want):
    """Same containers and key paths; leaves of the same dtype and bits."""
    assert _containers(got) == _containers(want)
    g, w = tck.leaf_items(got), tck.leaf_items(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu", k
            assert a.shape == b.shape and _bits(a) == _bits(b), k
        else:
            assert type(a) is type(b) and a == b, k


@pytest.fixture(scope="module")
def jax_tree():
    """The tracked checkpoint as the JAX package's ``{"params",
    "state"}`` of numpy leaves (an ``eval_shape`` template)."""
    model = JaxFusion(JaxDarknet(jax_tiny_defs(num_classes=12, img_size=S),
                                 img_size=S), JaxConfig())
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    tree = jck.load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    return jax.tree.map(np.asarray, tree)


def _through_orbax(path, tree):
    jck.save_orbax(path, tree)
    return jck.load_orbax(path)


def _through_sharded(path, tree):
    tck.save_sharded(path, tree)
    return tck.load_sharded(path)


@pytest.mark.parametrize("part", ["ensemble", "fusion"])
def test_tree_matches_orbax(tmp_path, jax_tree, part):
    tree = ({"ensemble": jax_tree["params"]["ensemble"]} if part == "ensemble"
            else jax_tree)
    want = _through_orbax(str(tmp_path / "orbax"), tree)
    if part == "ensemble":
        port_in = {"ensemble": tck.convert(tree["ensemble"], {})[0]}
        want = {"ensemble": tck.convert(
            jax.tree.map(np.asarray, want["ensemble"]), {})[0]}
    else:
        port_in = dict(zip(("params", "state"),
                           tck.convert(tree["params"], tree["state"])))
        want = dict(zip(("params", "state"), tck.convert(
            *jax.tree.map(np.asarray, (want["params"], want["state"])))))
    got = _through_sharded(str(tmp_path / "sharded"), port_in)
    _same_tree(got, want)
    _same_tree(got, port_in)
    assert len(tck.leaf_items(got)) > (100 if part == "fusion" else 3)


def test_dtypes_match_orbax(tmp_path):
    """bfloat16, float16, int8, int32 and float32 leaves, a 0-d array,
    Python scalars and None, from one numpy draw in both packages."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 5, 6)).astype(np.float32) * 40

    def tree(arr, cast):
        return {"bf16": cast(x, "bfloat16"), "f16": cast(x, "float16"),
                "i8": cast(np.clip(x, -127, 127), "int8"),
                "i32": cast(x, "int32"), "f32": arr(x[0, 0]),
                "zero_d": arr(np.float32(2.5)), "nested": [
                    {"count": 3, "rate": 0.25, "flag": True}, None]}

    jtree = tree(np.asarray, lambda a, d: jnp.asarray(a, getattr(jnp, d)))
    ttree = tree(lambda a: torch.from_numpy(np.array(a)),
                 lambda a, d: torch.from_numpy(np.array(a)).to(
                     getattr(torch, d)))
    want = _through_orbax(str(tmp_path / "orbax"), jtree)
    got = _through_sharded(str(tmp_path / "sharded"), ttree)
    # both packages' casts give the same bits, and the pairs keep them
    assert [k for k, _ in tck.leaf_items(got)] == [
        k for k, _ in tck.leaf_items(want)]
    for (k, a), (_, b) in zip(tck.leaf_items(got), tck.leaf_items(want)):
        if isinstance(a, torch.Tensor):
            assert a.shape == tuple(np.shape(b)), k
            bb = np.asarray(b)
            name = "bfloat16" if bb.dtype.name == "bfloat16" else str(
                bb.dtype)
            assert _bits(a) == (name, bb.tobytes()), k
        else:
            assert type(a) is type(b) and a == b, k
    assert _containers(got) == _containers(want)
    _same_tree(got, ttree)


def test_serving_and_train_state_trees(tmp_path):
    """``fold_for_serving`` trees (int8 weights; bfloat16 stages), a
    float16 copy of the ensemble head and a stage-3 ``TrainState`` at
    step 3."""
    trees = {}
    for preset in ("int8", "pallas_max_s01"):
        model, params, state = build_fusion(CKPT, preset, img_size=S,
                                            device="cpu")
        p, s = fold_for_serving(model, params, state)
        trees[preset] = {"params": p, "state": s}
    # no serving tree keeps float16 weights: the ensemble head cast
    trees["float16"] = tree_map(torch.Tensor.half, params["ensemble"])
    dtypes = {x.dtype for _, x in tck.leaf_items(trees)}
    assert {torch.int8, torch.bfloat16, torch.float16} <= dtypes
    got = _through_sharded(str(tmp_path / "serving"), trees)
    _same_tree(got, trees)
    # the .npz holds the int8 tree (not bfloat16): both formats agree
    npz = str(tmp_path / "int8.npz")
    tck.save_checkpoint(npz, trees["int8"])
    _same_tree(got["int8"], tck.load_checkpoint(npz, trees["int8"]))

    _, params, state = build_fusion(CKPT, img_size=S, device="cpu")
    tx = frozen_adam(params, frozen_prefixes=STAGE3_FROZEN, every_k=2)
    ts = init_train_state(params, state, tx)._replace(step=3)
    got = _through_sharded(str(tmp_path / "ts"), ts)
    assert sorted(got) == ["opt_state", "params", "state", "step"]
    assert got["step"] == 3 and type(got["step"]) is int
    assert sorted(got["opt_state"]) == ["acc_grads", "gradient_step",
                                        "inner_opt_state", "mini_step"]
    mu = got["opt_state"]["inner_opt_state"]["mu"]
    assert mu["darknet"][0]["w"] is None       # frozen: no moments
    assert tck.leaf_items(mu["darknet"]) == [] and tck.leaf_items(
        mu["radar_enc"])
    npz = str(tmp_path / "ts.npz")
    tck.save_checkpoint(npz, ts)
    # the .npz keeps the named tuples' field order, the dicts sort theirs
    g = dict(tck.leaf_items(got))
    w = dict(tck.leaf_items(tck.load_checkpoint(npz, ts)))
    assert sorted(g) == sorted(w)
    for k, a in g.items():
        b = w[k]
        if k == "step":
            assert a == int(b)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), k


class Counter(NamedTuple):
    count: int
    weights: object


def test_refusals_and_named_tuple_match_orbax(tmp_path):
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    want = _through_orbax(str(tmp_path / "orbax"), Counter(4, {"w": w}))
    got = _through_sharded(str(tmp_path / "sharded"),
                           Counter(4, {"w": torch.from_numpy(w)}))
    assert want == {"count": 4, "weights": {"w": want["weights"]["w"]}}
    assert got["count"] == 4 and type(got["count"]) is int
    _same_tree(got, {"count": 4, "weights": {"w": torch.from_numpy(
        np.asarray(want["weights"]["w"]))}})
    with pytest.raises(ValueError, match="already exists"):
        jck.save_orbax(str(tmp_path / "orbax"), {"w": w})
    with pytest.raises(ValueError, match="already exists"):
        tck.save_sharded(str(tmp_path / "sharded"), {"w": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        jck.load_orbax(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        tck.load_sharded(str(tmp_path / "missing"))
    # the refused save left the checkpoint as it was
    _same_tree(tck.load_sharded(str(tmp_path / "sharded")), got)


def test_mesh_writes_each_slice_once(tmp_path):
    """dp 2 x mp 2 on gloo CPU ranks, one stage-3 ``--fold_frozen`` step
    at ``--grad_accum 2`` (so the optimizer's gradient accumulator holds
    slices too), then ``save_sharded`` from every rank."""
    out = tcli.main(["--stage", "fusion", "--fold_frozen", "--checkpoint",
                     CKPT, "--synthetic", "4", "--img_size", str(S),
                     "--batch_size", "4", "--epochs", "1", "--grad_accum",
                     "2", "--data_parallel", "2", "--model_parallel", "2",
                     "--device", "cpu", "--checkpoint_dir",
                     str(tmp_path / "mesh")],
                    probe=ranks.SaveProbe(str(tmp_path / "sharded")),
                    timeout=TIMEOUT)
    got = tck.load_sharded(str(tmp_path / "sharded"))
    full = out[0]["report"]["full"]
    items = tck.leaf_items(got)
    assert [k for k, _ in items] == list(full)
    for k, a in items:
        b = full[k]
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert type(a) is type(b) and a == b, k
    assert got["step"] == 1
    npz = tck.load_checkpoint(str(tmp_path / "mesh" /
                                  "module3_ckpt_final.npz"),
                              {"params": got["params"],
                               "state": got["state"]})
    _same_tree({"params": got["params"], "state": got["state"]}, npz)

    mesh = parallel.make_mesh(4, model_axis=2, devices=["cpu"] * 4)
    sliced = set()
    for o in out:
        own = o["report"]["own"]
        assert sorted(own) == sorted(k for k, x in items
                                     if isinstance(x, torch.Tensor))
        for k, x in items:
            if not isinstance(x, torch.Tensor):
                continue
            cut = (_shard(mesh, x, o["model"])
                   if k.split("/")[0] in ("params", "opt_state") else x)
            assert torch.equal(own[k], cut), (o["rank"], k)
            if cut.shape != x.shape:
                sliced.add(k)
    # the 7 sharded parameters and their gradient accumulators
    assert "params/img_cnn/0/w" in sliced
    assert "opt_state/acc_grads/img_cnn/0/w" in sliced
    assert len(sliced) == 14, sorted(sliced)
    w = got["params"]["img_cnn"][0]["w"]
    assert w.shape[0] == 490 and not torch.equal(*w.chunk(2))
