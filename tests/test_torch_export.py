"""The port's serving export on the CPU: the kernels as ``torch.library``
custom ops (``torch.library.opcheck`` of each), the constant cache under
tracing, ``io/export.py``'s round trip, ``cli.export`` with ``--verify``,
the artifact against the JAX package's ``load_serving`` blob on the same
weights, and a loading process that imports no model code.

Tolerances: an artifact replays the live graph's operators, so on the
CPU it is held bit-equal to it. Against the JAX package's blob (XLA:CPU,
compiled) at float32: ``valid`` equal and rows within
tests/test_torch_fusion.py's float32 class (1e-3 px on boxes, 1e-4 on
scores), rows matched by box."""
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.cli import export as tcli
from millieye_torch.cli._common import build_fusion
from millieye_torch.io.export import export_serving, load_serving
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.fusion import FusionConfig, FusionNetwork
from millieye_torch.models.zoo import tiny_yolov3_defs
from millieye_torch.ops import cuda_lib, library
from millieye_torch.runtime.engine import fold_for_serving
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.io.export import export_serving as jax_export
from millieye_tpu.io.export import load_serving as jax_load
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxNetwork

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_kernels_gpu import op_cases  # noqa: E402

torch.set_num_threads(1)

CKPT = "artifacts/stage3_final.npz"
S = 128
F32_TOL = dict(score=1e-4, box=1e-3)
# a fresh process on the repository's package, one thread
_ENV = dict(os.environ, PYTHONPATH=".", OMP_NUM_THREADS="1")


# ------------------------------------------------------------ custom ops
def test_every_kernel_is_a_custom_op():
    assert set(op_cases()) == cuda_lib.KERNELS
    for name in cuda_lib.KERNELS:
        assert str(library.op(name)._schema).startswith(f"millieye::{name}(")
    assert set(library.OPS) == cuda_lib.KERNELS


@pytest.mark.parametrize("name", sorted(cuda_lib.KERNELS))
def test_opcheck(name):
    """Schema, fake (shape and dtype) against the real CPU output, and
    tracing with dynamic shapes, on the CPU implementation (the plain
    version)."""
    args = op_cases()[name]
    torch.library.opcheck(library.op(name), args)
    # the op is the wrapper's plain version on the CPU, bit for bit
    out = library.op(name)(*args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = library.op(name)(*(mode.from_tensor(a)
                                  if isinstance(a, torch.Tensor) else a
                                  for a in args))
    for o, f in zip(out if isinstance(out, tuple) else (out,),
                    fake if isinstance(fake, tuple) else (fake,)):
        assert o.shape == f.shape and o.dtype == f.dtype


def test_wrappers_take_the_ops_and_count_nothing_on_the_cpu():
    from millieye_torch.ops import nms_kernel, stem
    case = op_cases()["nms"]
    before = nms_kernel.nms_keep_mask_blocked.launches
    keep = nms_kernel.nms_keep_mask_blocked(*case)
    assert torch.equal(keep, nms_kernel.nms_keep_mask_blocked_plain(*case))
    assert nms_kernel.nms_keep_mask_blocked.launches == before
    x, w0, b0, w1, b1 = op_cases()["stem_pair"][:5]
    assert torch.equal(stem.fused_stem_pair(x, w0, b0, w1, b1),
                       stem.fused_stem_pair_plain(x, w0, b0, w1, b1))


# ------------------------------------------------------------- the step
def _inputs(rng, b, s, r):
    imgs = torch.tensor(rng.uniform(size=(b, s, s, 3)), dtype=torch.float32)
    maps = torch.tensor(rng.uniform(size=(b, s // 16, s // 16, 3)),
                        dtype=torch.float32)
    rb = np.zeros((b, r, 4), np.float32)
    rb[..., :2] = rng.uniform(0.1, 0.5, size=(b, r, 2))
    rb[..., 2:] = rb[..., :2] + 0.3
    return imgs, maps, torch.tensor(rb), torch.ones((b, r), dtype=torch.bool)


_STEP = """
import sys, numpy as np, torch
from millieye_torch import device
from millieye_torch.cli._common import build_fusion
from millieye_torch.io.export import export_serving
from millieye_torch.runtime.engine import fold_for_serving
model, params, state = build_fusion("{ckpt}", "f32", img_size={s},
                                    device="cpu")
params, state = fold_for_serving(model, params, state)
if sys.argv[1] == "export":
    export_serving(model, params, state, device="cpu")
    assert device.constant.cache_info().currsize > 0
rng = np.random.default_rng(4)
s, r = {s}, model.cfg.max_radar
imgs = torch.tensor(rng.uniform(size=(2, s, s, 3)), dtype=torch.float32)
maps = torch.tensor(rng.uniform(size=(2, s // 16, s // 16, 3)),
                    dtype=torch.float32)
rb = torch.tensor(rng.uniform(0.1, 0.5, size=(2, r, 4)), dtype=torch.float32)
rb[..., 2:] += 0.3
out = model.apply(params, state, imgs, maps, rb, torch.ones(2, r, dtype=bool))
for v in (out["boxes"], out["valid"], out["radar_attention"]):
    assert type(v) is torch.Tensor, type(v)
np.savez(sys.argv[2], boxes=out["boxes"].numpy(), valid=out["valid"].numpy())
"""


def test_export_then_eager_step_gives_real_tensors(tmp_path):
    """The constant cache (``device.constant``) first filled under
    ``torch.export``'s fake tensors: the eager step after it returns real
    tensors, bit-equal to a fresh process's step."""
    code = _STEP.format(ckpt=CKPT, s=S)
    outs = {}
    for how in ("export", "fresh"):
        path = str(tmp_path / f"{how}.npz")
        subprocess.run([sys.executable, "-c", code, how, path], check=True,
                       env=_ENV)
        outs[how] = np.load(path)
    for k in ("boxes", "valid"):
        np.testing.assert_array_equal(outs["export"][k], outs["fresh"][k])
    assert outs["fresh"]["valid"].any()


def test_a_constant_first_made_in_inference_mode_serves_training():
    """``device.constant`` first called under ``torch.inference_mode`` (an
    evaluation's step) caches a normal tensor: a later training step in
    the same process saves it for backward."""
    from millieye_torch import device
    with torch.inference_mode():
        c = device.constant(((1.5, 2.5),), "cpu")
    assert not c.is_inference()
    x = torch.ones(2, requires_grad=True)
    (torch.exp(x) * c[0]).sum().backward()
    assert torch.equal(x.grad, torch.exp(torch.ones(2)) * c[0])


_LOAD = """
import sys, json, numpy as np, torch
from millieye_torch.io.export import load_serving
step = load_serving(open(sys.argv[1], "rb").read())
assert not torch.backends.cudnn.allow_tf32      # full float32, as exported
loaded = sorted(m for m in sys.modules if m.startswith("millieye_torch"))
assert not any(m.startswith(("millieye_torch.models", "millieye_torch.cli",
                             "millieye_torch.io.checkpoint",
                             "millieye_torch.io.torch_ckpt",
                             "millieye_torch.io.darknet_weights"))
               for m in loaded), loaded
z = np.load(sys.argv[2])
out = step(*(torch.from_numpy(z[k]) for k in ("imgs", "maps", "rb", "rm")))
np.savez(sys.argv[3], boxes=out["boxes"].numpy(), valid=out["valid"].numpy())
print(json.dumps({"meta": step.meta, "modules": loaded}))
"""


def test_cli_export_verify_and_a_loader_without_models(tmp_path):
    """``cli.export --verify`` at ``pallas_max_s01`` (K4, K1, K2 and K3 as
    ops in the program); its blob replayed in-process on other inputs and
    in a process that imports no model code, both bit-equal to the live
    graph."""
    out = str(tmp_path / "serving.pt2")
    res = tcli.main(["--out", out, "--serving", "pallas_max_s01",
                     "--weights", CKPT, "--img_size", str(S), "--batch", "2",
                     "--device", "cpu", "--verify"])
    assert res["verify_bit_identical"] is True
    blob = open(out, "rb").read()
    program = torch.export.load(io.BytesIO(blob))
    ops = {str(n.target) for n in program.graph.nodes
           if str(n.target).startswith("millieye.")}
    assert ops == {"millieye.stem_pair.default", "millieye.nms.default",
                   "millieye.ps_roi_align.default",
                   "millieye.roi_align.default"}
    model, params, state = build_fusion(CKPT, "pallas_max_s01", img_size=S,
                                        device="cpu")
    params, state = fold_for_serving(model, params, state)
    ins = _inputs(np.random.default_rng(7), 2, S, model.cfg.max_radar)
    live = model.apply(params, state, *ins)
    art = load_serving(blob)(*ins)
    assert set(art) == {"boxes", "valid"}
    assert torch.equal(art["boxes"], live["boxes"])
    assert torch.equal(art["valid"], live["valid"])
    with pytest.raises(ValueError, match="runs on cpu"):
        load_serving(blob)(*(t.to("meta") for t in ins))

    npz, got = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(npz, **{k: t.numpy() for k, t in zip(("imgs", "maps", "rb",
                                                   "rm"), ins)})
    run = subprocess.run([sys.executable, "-c", _LOAD, out, npz, got],
                         check=True, capture_output=True, text=True,
                         env=_ENV)
    meta = json.loads(run.stdout.splitlines()[-1])["meta"]
    assert meta == {"device": "cpu", "batch_size": 2, "img_size": S,
                    "max_radar": 32, "mode": 0}
    z = np.load(got)
    np.testing.assert_array_equal(z["boxes"], live["boxes"].numpy())
    np.testing.assert_array_equal(z["valid"], live["valid"].numpy())


def _match_rows(got, want, tol):
    np.testing.assert_array_equal(got[1], want[1])
    for g, w, v in zip(got[0], want[0], got[1]):
        g, w = g[v], w[v]
        match = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1).argmin(1)
        assert sorted(match) == list(range(len(w)))
        np.testing.assert_allclose(g[:, :4], w[match, :4], rtol=0,
                                   atol=tol["box"])
        np.testing.assert_allclose(g[:, 4:], w[match, 4:], rtol=0,
                                   atol=tol["score"])


def test_artifact_matches_live_graph_and_jax_blob():
    """At ``f32``, mode 0, batch 2: the port's artifact bit-equal to its
    live graph, and against the JAX package's blob of the same folded
    weights."""
    model, params, state = build_fusion(CKPT, "f32", img_size=S,
                                        device="cpu")
    params, state = fold_for_serving(model, params, state)
    blob = export_serving(model, params, state, batch_size=2, device="cpu")
    ins = _inputs(np.random.default_rng(3), 2, S, model.cfg.max_radar)
    live = model.apply(params, state, *ins)
    art = load_serving(blob)(*ins)
    assert torch.equal(art["boxes"], live["boxes"])
    assert torch.equal(art["valid"], live["valid"])

    jdn = JaxDarknet(jax_defs(num_classes=12, img_size=S), img_size=S)
    jmodel = JaxNetwork(jdn, JaxConfig())
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    r = load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    jp, js = r["params"], r["state"]
    fp, fs = jdn.fold_batchnorm(jax.tree.map(jnp.asarray, jp["darknet"]),
                                jax.tree.map(jnp.asarray, js["darknet"]))
    jblob = jax_export(jmodel, dict(jp, darknet=fp), dict(js, darknet=fs),
                       batch_size=2)
    want = jax_load(jblob)(*(jnp.asarray(t.numpy()) for t in ins))
    assert art["valid"].any()
    _match_rows((art["boxes"].numpy(), art["valid"].numpy()),
                (np.asarray(want["boxes"]), np.asarray(want["valid"])),
                F32_TOL)


def test_export_numpy_leaves_bf16_heads():
    """tests/test_export.py's regression on the port: a bf16 network whose
    weights are numpy leaves (the shape a checkpoint restore gives)
    exports, and its artifact equals the live graph on those weights as
    tensors."""
    dn = Darknet(tiny_yolov3_defs(num_classes=12, img_size=S), img_size=S)
    m = FusionNetwork(dn, FusionConfig(conf_thresh=0.05, max_det=8,
                                       max_radar=4, pre_nms_top_k=64,
                                       compute_dtype="bfloat16",
                                       heads_dtype="bfloat16"))
    params, state = m.init(torch.Generator().manual_seed(0))
    fp, fs = dn.fold_batchnorm(params["darknet"], state["darknet"],
                               dtype=torch.bfloat16)
    params, state = dict(params, darknet=fp), dict(state, darknet=fs)

    def numpy_leaves(tree):
        if isinstance(tree, dict):
            return {k: numpy_leaves(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [numpy_leaves(v) for v in tree]
        return tree.float().numpy() if tree.dtype == torch.bfloat16 \
            else tree.numpy()

    blob = export_serving(m, numpy_leaves(params), numpy_leaves(state),
                          device="cpu")
    ins = _inputs(np.random.default_rng(5), 1, S, 4)
    art = load_serving(blob)(*ins)
    assert torch.isfinite(art["boxes"]).all()
    assert art["boxes"].shape == (1, 12, 7)
