"""The port's ``parallel/`` on gloo ranks on the CPU, against the JAX
package's ``parallel/`` on its 8 virtual CPU devices
(``tests/test_parallel.py``'s contract, case for case).

* the mesh shapes and the shape rule: the port's ``param_sharding``
  marks exactly the leaves of the tracked stage-3 tree that JAX's marks
  (axis 3 of HWIO is axis 0 of OIHW), the 7 leaves;
* sharded evaluation: 8 ranks as an 8 x 1 mesh at 128 px, on the
  batch of ``test_sharded_evaluate_fusion`` (its seeds) and a batch of
  ``SyntheticScenes`` (where the AP is not 0): the result equals the
  port's one-process evaluation and the JAX package's sharded one within
  rtol 1e-4, and each rank's rows equal the one-process rows of its
  slice within 1e-4 (float32: the batch size moves oneDNN's summation
  order);
* the shard_map twin on 8 ranks: finite loss, ``step == 1``, the Darknet
  bit-identical, and the gradients each rank holds (per-shard sums
  summed over "data") equal to a one-process loop over the same shards
  with the same per-shard draws within 1e-5 of each leaf's largest
  (summation order), the BN state the shards' mean, the metrics their
  sum;
* ``entry.dryrun_multichip(4)`` and ``(8)``;
* a rank that raises or hangs ends the world with an error.

Every world has a join limit (``world.launch(timeout=)``).
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from millieye_torch import parallel
from millieye_torch.cli._common import build_fusion
from millieye_torch.data.loader import DataLoader, PaddedCollate
from millieye_torch.data.synthetic import SyntheticScenes
from millieye_torch.eval import harness as th
from millieye_torch.io.checkpoint import leaf_items
from millieye_torch.parallel import world
from millieye_torch.parallel.shard_map_step import shard_seed
from millieye_torch.train.optim import STAGE3_FROZEN, label_tree, tree_map
from millieye_torch.train.recipes import fusion_device_batch
from millieye_tpu import parallel as jparallel
from millieye_tpu.eval import harness as jh
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.models import Darknet as JDarknet
from millieye_tpu.models import tiny_yolov3_defs as jdefs
from millieye_tpu.models.fusion import FusionConfig as JConfig
from millieye_tpu.models.fusion import FusionNetwork as JFusion
from millieye_tpu.train.recipes import fusion_device_batch as jax_batch

torch.set_num_threads(1)

CKPT = "artifacts/stage3_final.npz"
S = 128
CFG = dict(conf_thresh=0.05, max_det=16, max_radar=4, pre_nms_top_k=64)
TIMEOUT = 300


def test_mesh_shapes():
    mesh = parallel.make_mesh(8, model_axis=2, devices=["cpu"] * 8)
    assert mesh.shape["data"] == 4 and mesh.shape["model"] == 2
    mesh1 = parallel.make_mesh(8, model_axis=1, devices=["cpu"] * 8)
    assert mesh1.shape["data"] == 8
    with pytest.raises(ValueError):
        parallel.make_mesh(5, model_axis=2, devices=["cpu"] * 5)


def test_param_sharding_specs():
    mesh = parallel.make_mesh(8, model_axis=2, devices=["cpu"] * 8)
    params = {"wide_conv": torch.zeros(490, 256, 1, 1),
              "wide_lin": torch.zeros(490, 256),
              "small": torch.zeros(32, 16, 3, 3)}
    sh = parallel.param_sharding(mesh, params)
    assert sh["wide_conv"].spec == ("model", None, None, None)
    assert sh["wide_lin"].spec == ("model", None)
    assert sh["small"].spec == () and sh["small"].axis is None
    one = parallel.make_mesh(8, model_axis=1, devices=["cpu"] * 8)
    assert all(x.spec == () for x in
               parallel.param_sharding(one, params).values())
    assert parallel.batch_sharding(mesh).spec == ("data",)
    assert parallel.replicated(mesh).spec == ()


def _jax_fusion():
    model = JFusion(JDarknet(jdefs(num_classes=12, img_size=S), img_size=S),
                    JConfig(**CFG))
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    r = load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    return model, r["params"], r["state"]


def test_param_sharding_matches_jax_on_stage3():
    _, jp, _ = _jax_fusion()
    jmesh = jparallel.make_mesh(8, model_axis=2)
    jspec = jax.tree_util.tree_flatten_with_path(
        jparallel.param_sharding(jmesh, jp))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(sh.spec)
            for path, sh in jspec}
    _, params, _ = build_fusion(CKPT, img_size=S, device="cpu", **CFG)
    mesh = parallel.make_mesh(8, model_axis=2, devices=["cpu"] * 8)
    sh = parallel.param_sharding(mesh, params)
    got = {}
    for k, _ in leaf_items(params):
        node = sh
        for key in k.split("/"):
            node = node[int(key) if isinstance(node, list) else key]
        got[k] = node
    assert sorted(got) == sorted(want)
    marked = sorted(k for k, v in got.items() if v.spec)
    assert marked == sorted(k for k, v in want.items() if "model" in v)
    assert marked == ["darknet/13/w", "darknet/21/w", "darknet/8/w",
                      "img_cnn/0/w", "refine/net0/w", "refine/net1/w",
                      "refine/net2/w"]
    for k in marked:
        # HWIO's last axis (JAX) is OIHW's first (the port); a linear
        # [in, out] is sharded on its first in both
        assert want[k].index("model") == (3 if len(want[k]) == 4 else 0)
        assert got[k].spec[0] == "model" and got[k].axis == 0


def _seed_batch(rng, b=8):
    """test_sharded_evaluate_fusion's batch (its draws, in its order)."""
    rb = np.zeros((b, 4, 4), np.float32)
    rb[..., :2] = rng.uniform(0.1, 0.5, (b, 4, 2))
    rb[..., 2:] = rb[..., :2] + 0.3
    tg = np.zeros((b, 5, 5), np.float32)
    tg[..., 1:3] = rng.uniform(0.3, 0.7, (b, 5, 2))
    tg[..., 3:5] = 0.2
    return {"images": rng.uniform(size=(b, S, S, 3)).astype(np.float32),
            "radar_maps": rng.uniform(size=(b, S // 16, S // 16, 3)).astype(
                np.float32),
            "radar_boxes": rb, "rmask": np.ones((b, 4), bool),
            "targets": tg, "tmask": np.ones((b, 5), bool)}


def _port_batch(host):
    out = {k: torch.from_numpy(v) for k, v in host.items()}
    out["host"] = {k: host[k] for k in ("targets", "tmask")}
    return out


def _scene_batch():
    ds = SyntheticScenes(8, seed=777)
    coll = PaddedCollate(S, max_targets=64, max_radar=4, max_points=256)
    return next(iter(DataLoader(ds, 8, coll)))


def _same(got, want, rtol):
    assert (got is None) == (want is None)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=rtol,
                                   atol=1e-12)


def test_sharded_evaluate_fusion(rng, tmp_path):
    """8 ranks, 8 x 1: equal to one process and to JAX's sharded eval."""
    jmodel, jp, js = _jax_fusion()
    model, params, state = build_fusion((jp, js), img_size=S, device="cpu",
                                        **CFG)
    seeds, scenes = _seed_batch(rng), _scene_batch()
    batches = [_port_batch(seeds), fusion_device_batch(scenes, S, "cpu")]
    payload = str(tmp_path / "payload.pt")
    torch.save((model, params, state, batches, 0), payload)
    out = world.launch(ranks.eval_rank, 8, "cpu", (8, payload),
                       timeout=TIMEOUT)

    one = th.evaluate_fusion(model, params, state, batches)
    jmesh = jparallel.make_mesh(8, model_axis=1)
    jbatches = [seeds, jax_batch(scenes, S)]
    jsharded = jh.evaluate_fusion(jmodel, jp, js, iter(jbatches), mesh=jmesh)
    assert one is not None and np.asarray(one[2]).max() > 0
    for o in out:
        _same(o["result"], one, 1e-4)
        _same(o["result"], jsharded, 1e-4)
    # each rank's rows against the one-process rows of its slice
    for i, batch in enumerate(batches):
        with torch.inference_mode():
            full = model.apply(params, state, batch["images"],
                               batch["radar_maps"], batch["radar_boxes"],
                               batch["rmask"])
        for r, o in enumerate(out):
            boxes, valid = o["rows"][i]
            np.testing.assert_array_equal(valid, full["valid"][r:r + 1])
            np.testing.assert_allclose(boxes, full["boxes"][r:r + 1],
                                       rtol=0, atol=1e-4)


def _positive_batch(rng, b=8):
    """The seeds' batch with targets on the radar boxes, so the radar
    rows are positives and the twin samples negatives."""
    host = _seed_batch(rng, b)
    rb = host["radar_boxes"]
    tg = np.zeros((b, 5, 5), np.float32)
    tg[:, :4, 1:3] = (rb[..., :2] + rb[..., 2:]) / 2
    tg[:, :4, 3:5] = rb[..., 2:] - rb[..., :2]
    host["targets"] = tg
    host["tmask"] = np.arange(5)[None].repeat(b, 0) < 4
    return host


def test_shardmap_fusion_step(rng, tmp_path):
    """The twin on 8 ranks against a one-process loop over its shards."""
    from millieye_torch.train.steps import generator_draw
    model, params, state = build_fusion(CKPT, img_size=S, device="cpu",
                                        **CFG)
    host = _positive_batch(rng)
    batch = _port_batch(host)
    payload = str(tmp_path / "payload.pt")
    seed = 1
    torch.save((model, params, state, batch, seed), payload)
    out = world.launch(ranks.shardmap_rank, 8, "cpu", (8, payload),
                       timeout=TIMEOUT)

    dark0 = [x for _, x in leaf_items(params["darknet"])]
    labels = label_tree(params, STAGE3_FROZEN)
    want_g, want_bn, want_m = None, [], {}
    for d in range(8):
        live = tree_map(lambda p, lab: p.detach().requires_grad_(
            lab == "train"), params, labels)
        gen = torch.Generator().manual_seed(shard_seed(seed, d))
        sl = {k: v[d:d + 1] for k, v in batch.items() if k != "host"}
        o = model.apply(live, state, sl["images"], sl["radar_maps"],
                        sl["radar_boxes"], sl["rmask"], train=True,
                        targets=sl["targets"], tmask=sl["tmask"],
                        draw=generator_draw(gen))
        leaves = [(k, x) for k, x in leaf_items(live) if x.requires_grad]
        g = torch.autograd.grad(o["loss"], [x for _, x in leaves],
                                allow_unused=True)
        g = {k: torch.zeros_like(x) if gi is None else gi
             for (k, x), gi in zip(leaves, g)}
        want_g = g if want_g is None else {k: want_g[k] + g[k] for k in g}
        want_bn.append(dict(leaf_items(o["state"])))
        for k, v in dict(o["metrics"], loss=o["loss"]).items():
            want_m[k] = want_m.get(k, 0.0) + float(v.detach())
    assert want_m["loss"] > 0 and want_m["true"] > 0
    for o in out:
        assert np.isfinite(o["loss"]) and o["step"] == 1
        for a, b in zip(dark0, o["darknet"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for k, w in want_g.items():
            tol = 1e-5 * float(w.abs().max()) + 1e-12
            torch.testing.assert_close(o["grads"][k], w, rtol=0, atol=tol,
                                       msg=k)
        for k, g in o["grads"].items():
            if k not in want_g:
                assert not g.any(), k
        for k, v in o["bn"].items():
            if not k.startswith("darknet/"):
                mean = sum(b[k] for b in want_bn) / 8
                torch.testing.assert_close(v, mean, rtol=1e-5, atol=1e-6,
                                           msg=k)
        for k, v in want_m.items():
            assert abs(o["metrics"][k] - v) <= 1e-5 * max(abs(v), 1), k


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    from millieye_torch.entry import dryrun_multichip
    out = dryrun_multichip(n, device="cpu", timeout=TIMEOUT)
    assert [o["rank"] for o in out] == list(range(n))
    model = 2 if n % 2 == 0 else 1
    for o in out:
        assert o["mesh"] == {"data": n // model, "model": model}
        assert np.isfinite(o["loss"]) and o["eval_equal"]
        assert o["window_rows"][0] == 2 * (n // model)


def test_world_fails_on_a_failed_or_hung_rank():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        world.launch(ranks.raise_rank, 2, "cpu", timeout=TIMEOUT)
    with pytest.raises(Exception):
        world.launch(ranks.hang_rank, 2, "cpu", timeout=10)
