"""Port parity for the slice as a whole: FusionNetwork.apply (modes 0, 1,
2) and
FusionEngine.infer of millieye_torch against millieye_tpu, at the f32 and
pallas_max_s01 presets, 96 px (135 anchors -> K=128 NMS candidates,
96 % 32 == 0 for the stem pair), on the trained stage-3 weights through
the port's weight converter. On the CPU the port's four kernel wrappers
take their plain versions, the JAX package its XLA/interpret paths.

Tolerances: validity masks equal; rows are matched by box (rows whose
scores nearly tie may trade places in the priority sort). f32: float32
summation order only (1e-4 on scores, 1e-3 px). pallas_max_s01: bf16
class -- scores within 0.02 (five bf16 ulps at 0.5; measured 0.013, the
refined foreground score after bf16 heads), boxes within 1 px (measured
0.05 px).

Also: the port imports no JAX, the kernel wrappers' plain-version switch,
and the entry points refuse a missing GPU unless asked for the CPU.
"""
import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from millieye_torch.cli._common import build_fusion
from millieye_torch.io.checkpoint import convert
from millieye_torch.io.checkpoint import load_checkpoint as torch_load
from millieye_torch.ops import cuda_lib
from millieye_torch.ops import letterbox as tlb
from millieye_torch.ops.rasterize import radar_heatmap
from millieye_torch.runtime.engine import FusionEngine, fold_for_serving
from millieye_tpu.cli._common import serving_overrides as jax_overrides
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.models import Darknet as JaxDarknet
from millieye_tpu.models import tiny_yolov3_defs as jax_defs
from millieye_tpu.models.fusion import FusionConfig as JaxConfig
from millieye_tpu.models.fusion import FusionNetwork as JaxNetwork
from millieye_tpu.ops import letterbox as jlb
from millieye_tpu.ops.rasterize import radar_heatmap as jax_heatmap
from millieye_tpu.runtime import engine as jengine

# small shapes: one thread per process, so that test workers running side
# by side do not oversubscribe the cores
torch.set_num_threads(1)

S = 96
FRAME = (64, 48)
CKPT = "artifacts/stage3_final.npz"
REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = {"f32": dict(score=1e-4, box=1e-3),
       "pallas_max_s01": dict(score=2e-2, box=1.0),
       # the same bf16 class (at 96 px: 135 NMS candidates through kernel
       # K5's plain version, 232 proposal rows); measured scores within
       # 0.012, boxes within 0.06 px
       "pallas_max4": dict(score=2e-2, box=1.0),
       "pallas_stem": dict(score=2e-2, box=1.0),
       # the stem pair and the deep pair through K12 (pallas_pair2), K2's
       # "vpu" reduce with blocked NMS at K = 256 (pallas_lat): the same
       # bf16 class
       "pallas_pair2": dict(score=2e-2, box=1.0),
       "pallas_lat": dict(score=2e-2, box=1.0)}


@functools.lru_cache(maxsize=None)
def _jax_model(preset, **cfg):
    """The JAX package's network at a serving preset on the checkpoint
    (as its cli build_fusion + load, without the random init), built once
    per preset for the module: its leaves are immutable jax arrays."""
    _, hi, store, pk, over = jax_overrides(preset)
    over = {**over, **cfg}
    darknet = JaxDarknet(
        jax_defs(num_classes=12, img_size=S), img_size=S, hi_prec_stages=hi,
        hi_prec_store=jnp.dtype(store) if store else None,
        pallas_stem_stages=pk["pallas_stem"],
        pallas_stem_pair=pk["pallas_pair"],
        pallas_stem_precision=pk["pallas_precision"],
        pallas_stem_pair_variant=pk["pallas_variant"],
        pallas_stem_pairs=pk["pallas_pairs"])
    model = JaxNetwork(darknet, JaxConfig(**over))
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    r = load_checkpoint(CKPT, {"params": like[0], "state": like[1]})
    # jax arrays, not numpy leaves (numpy promotes bf16 + float to f32)
    return model, *jax.tree.map(jnp.asarray, (r["params"], r["state"]))


def _radar(rng):
    pts = np.stack([rng.uniform(0, FRAME[0], 24), rng.uniform(0, FRAME[1], 24),
                    rng.uniform(1, 12, 24), rng.uniform(-2, 2, 24)], -1)
    pts[3] = [np.nan, 5, 5, 1]                   # sanitized away
    props = np.array([[5, 5, 30, 40], [20, 10, 60, 45], [40, 2, 63, 30],
                      [10, 10, 10, 30]], np.float64)  # last one empty
    return pts, props


def _compare(got_b, got_v, want_b, want_v, tol):
    """[..., K, F] rows + [..., K] validity; valid rows sort first."""
    np.testing.assert_array_equal(got_v, want_v)
    got_b, want_b = got_b.reshape(-1, *got_b.shape[-2:]), \
        want_b.reshape(-1, *want_b.shape[-2:])
    got_v = got_v.reshape(-1, got_v.shape[-1])
    for g, w, v in zip(got_b, want_b, got_v):
        g, w = g[v], w[v]
        assert len(g) > 0
        dist = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1)
        match = dist.argmin(1)
        assert sorted(match) == list(range(len(w))), match
        np.testing.assert_allclose(g[:, :4], w[match, :4], rtol=0,
                                   atol=tol["box"])
        np.testing.assert_allclose(g[:, 4:], w[match, 4:], rtol=0,
                                   atol=tol["score"])


@pytest.mark.parametrize("preset,mode", [("f32", 0), ("pallas_max_s01", 0),
                                         ("f32", 1), ("f32", 2),
                                         ("pallas_max4", 0),
                                         ("pallas_stem", 0)])
def test_fusion_apply(preset, mode):
    _check_fusion_apply(preset, mode)


@pytest.mark.parametrize("preset,cfg", [
    ("pallas_max4", {"roi_precision": "highest"}),
    ("pallas_max4", {"roi_precision": "split"}),
    ("f32", {"nms_use_blocked": False, "pre_nms_top_k": 128})])
def test_fusion_apply_options(preset, cfg):
    """The float32-operand RoI ladder (kernels K7 and K3; the JAX side
    runs ps_roi_align_pallas_padded and roi_align_pallas in interpret
    mode) and the whole-matrix NMS kernel pinned where K1 would run."""
    _check_fusion_apply(preset, 0, cfg)


def _check_fusion_apply(preset, mode, cfg=None):
    cfg = cfg or {}
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    maps = rng.uniform(0, 1, (2, S // 16, S // 16, 3)).astype(np.float32)
    rb = np.zeros((2, 32, 4), np.float32)
    rb[:, :6, :2] = rng.uniform(0.05, 0.5, (2, 6, 2))
    rb[:, :6, 2:] = rb[:, :6, :2] + rng.uniform(0.1, 0.4, (2, 6, 2))
    rmask = np.zeros((2, 32), bool)
    rmask[:, :6] = True

    jm, jp, js = _jax_model(preset, **cfg)
    jp, js = jengine.fold_for_serving(jm, jp, js)
    want = jax.jit(jm.apply, static_argnames="mode")(
        jp, js, jnp.asarray(images), jnp.asarray(maps), jnp.asarray(rb),
        jnp.asarray(rmask), mode=mode)
    if cfg.get("roi_precision"):           # the port calls the engine "kernel"
        assert jm.cfg.roi_impl == "pallas"
    model, params, state = build_fusion(CKPT, preset, img_size=S,
                                        device="cpu", **cfg)
    params, state = fold_for_serving(model, params, state)
    got = model.apply(params, state, torch.from_numpy(images),
                      torch.from_numpy(maps), torch.from_numpy(rb),
                      torch.from_numpy(rmask), mode=mode)
    assert got["boxes"].shape == want["boxes"].shape
    _compare(got["boxes"].numpy(), got["valid"].numpy(),
             np.asarray(want["boxes"]), np.asarray(want["valid"]),
             TOL[preset])


@pytest.mark.parametrize("preset", ["f32", "pallas_max_s01", "pallas_pair2",
                                    "pallas_lat"])
def test_engine_infer(preset):
    rng = np.random.default_rng(9)
    frame = (rng.uniform(size=(FRAME[1], FRAME[0], 3)) * 255).astype(np.uint8)
    pts, props = _radar(rng)
    jm, jp, js = _jax_model(preset)
    want = jengine.FusionEngine(jm, jp, js, frame_size=FRAME,
                                max_points=32).infer(frame, pts, props)
    model, params, state = build_fusion(CKPT, preset, img_size=S,
                                        device="cpu")
    got = FusionEngine(model, params, state, frame_size=FRAME, max_points=32,
                       device="cpu").infer(frame, pts, props)
    assert got[0].shape == (model.cfg.max_det + 32, 6)
    _compare(*got, *want, TOL[preset])


def test_ingest_matches():
    """Letterbox and radar heatmap. Letterbox: one float32 ulp (the port
    divides by 255 as ToTensor does; XLA rewrites the jitted division as
    a multiply by the rounded reciprocal). The heatmap's depth and
    velocity means come from float32 sums whose order may differ (1e-6)."""
    rng = np.random.default_rng(2)
    frame = (rng.uniform(size=(FRAME[1], FRAME[0], 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(
        tlb.letterbox_image(torch.from_numpy(frame), S)[0].numpy(),
        np.asarray(jax.jit(lambda f: jlb.letterbox_image(f, S)[0])(frame)),
        rtol=2 ** -23, atol=0)
    pts, _ = _radar(rng)
    pts = np.nan_to_num(pts).astype(np.float32)
    pts[:4, :2] = pts[4, :2]                    # several points per bin
    pts[5, 0] = -3.0                            # out of range
    mask = np.ones(len(pts), bool)
    mask[6] = False
    got = radar_heatmap(torch.from_numpy(pts), torch.from_numpy(mask), FRAME)
    want = np.asarray(jax.jit(lambda p, m: jax_heatmap(p, m, FRAME))(
        pts, mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    sq, _ = tlb.pad_to_square(got, 0.0)
    np.testing.assert_allclose(
        tlb.resize_bilinear_align_corners(sq, S // 16).numpy(),
        np.asarray(jax.jit(lambda h: jlb.resize_bilinear_align_corners(
            jlb.pad_to_square(h, 0.0)[0], S // 16))(want)),
        rtol=1e-6, atol=1e-6)


def test_weight_converter():
    """convert gives the JAX package's leaves, conv kernels turned HWIO
    -> OIHW, and load_checkpoint of the checkpoint the same tree."""
    _, jp, js = _jax_model("f32")
    tp, ts = convert(*jax.tree.map(np.asarray, (jp, js)))
    _, ip, is_ = build_fusion(None, "f32", img_size=S, device="cpu")
    lt = torch_load(CKPT, {"params": ip, "state": is_})
    for got, want in ((lt["params"], tp), (lt["state"], ts)):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), b.numpy()), got, want)
    w = np.asarray(jp["darknet"][2]["w"])
    np.testing.assert_array_equal(tp["darknet"][2]["w"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tp["refine"]["net0"]["w"].numpy(),
                                  np.asarray(jp["refine"]["net0"]["w"]))
    np.testing.assert_array_equal(ts["img_cnn"][0]["var"].numpy(),
                                  np.asarray(js["img_cnn"][0]["var"]))
    assert tp["darknet"][1] == {} and len(tp["darknet"]) == 24


def test_roi_reduce_validation():
    """FusionConfig.roi_reduce is "dot" or "vpu"; the port refuses any
    other name where the JAX package would run "dot" for it."""
    model, _, _ = build_fusion(CKPT, "pallas_maxv", img_size=S, device="cpu")
    assert model.cfg.roi_reduce == "vpu"
    with pytest.raises(ValueError, match="unknown roi_reduce"):
        build_fusion(CKPT, "pallas_max", img_size=S, device="cpu",
                     roi_reduce="VPU")


def test_port_imports_no_jax():
    """No module of millieye_torch, and not chip_smoke.py, imports jax or
    millieye_tpu."""
    files = sorted((REPO / "millieye_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "millieye_tpu"), \
                    f"{path.relative_to(REPO)} imports {name}"


def test_plain_versions_block():
    """The kernel wrappers' one switch: CPU tensors always take the plain
    versions; other devices only inside plain_versions(), which restores
    the switch on the way out, error or not. (A meta tensor stands in for
    a CUDA one.)"""
    cpu, dev = torch.zeros(1), torch.empty(1, device="meta")
    k = "stem_pair"
    assert cuda_lib.takes_plain(cpu, k) and not cuda_lib.takes_plain(dev, k)
    with pytest.raises(KeyError):
        with cuda_lib.plain_versions():
            assert cuda_lib.takes_plain(dev, k)
            assert cuda_lib.takes_plain(cpu, k)
            raise KeyError
    assert not cuda_lib.takes_plain(dev, k)


def test_entry_points_need_cpu_opt_in_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fusion(CKPT, "pallas_max_s01", img_size=S)
    model, params, state = build_fusion(CKPT, "f32", img_size=S,
                                        device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusionEngine(model, params, state, frame_size=FRAME)


def test_plain_versions_keep():
    """plain_versions(keep=...): the named wrappers still take their
    kernels on a non-CPU tensor, every other wrapper its plain version;
    CPU tensors always take the plain version; an unknown name raises."""
    cpu, dev = torch.zeros(1), torch.empty(1, device="meta")
    pair = ("stem_pair", "stem_pair_select", "stem_pair_packed",
            "stem_pair_s2d")
    with cuda_lib.plain_versions(keep=pair):
        for name in sorted(cuda_lib.KERNELS):
            assert cuda_lib.takes_plain(dev, name) == (name not in pair)
            assert cuda_lib.takes_plain(cpu, name)
    for name in cuda_lib.KERNELS:
        assert not cuda_lib.takes_plain(dev, name)
    with pytest.raises(ValueError, match="unknown"):
        with cuda_lib.plain_versions(keep=("stem_pair", "no_such_kernel")):
            pass
    with pytest.raises(ValueError, match="unknown"):
        cuda_lib.takes_plain(dev, "no_such_kernel")
