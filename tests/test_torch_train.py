"""Port parity of training on the CPU: train-mode BN and dropout in the
heads, ``train/optim.py:frozen_adam`` against optax, and the three train
steps of millieye_torch against ``jax.jit(make_*_train_step)`` of
millieye_tpu from the same parameters (through the weight converter),
on the same batches, with the JAX step's random numbers injected into
the port's ``draw`` (split as the JAX step splits its key).

Sizes: the YOLO step at 64 px (seed-0 init), the refine and fusion steps
at 96 px on the tracked checkpoint (max_det 16, 4 radar rows, 128 NMS
candidates), batches of 2-4 from ``SyntheticScenes(seed=777)``.

Tolerances (float32; the packages differ in summation order only):
* BN outputs and running statistics within 1e-5 relative (5e-6
  absolute); the heads' outputs within 1e-5;
* frozen_adam against optax: updates and moments within 1e-6 relative
  after 4 steps at every_k 2 (the same operations; rounding of the
  global norm's sum order only), NaN where optax has NaN;
* train steps after 2 steps (one optimizer update at every_k 2): loss
  and loss terms within 1e-4 relative, counts equal; BN statistics
  within 1e-5 relative; the accumulated gradients within 1e-3 of each
  leaf's largest plus 1e-5 of the tree's largest, except the conv biases
  that feed a BN, whose exact gradient is 0 and whose computed one is
  rounding noise in either package. Parameters after the update: Adam
  divides each gradient by its own magnitude, so an element whose
  gradient is rounding noise may step by +-lr on either side. Each
  element is held within what the two packages' gradients explain, lr
  |g_t / (|g_t| + eps) - g_j / (|g_j| + eps)|, plus 1e-7 and 2 ulp of
  the parameter; every element within 2 lr; frozen leaves unchanged.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from millieye_torch.cli._common import TRAIN_FOLD, build_fusion, build_refine
from millieye_torch.io.checkpoint import convert, leaf_items
from millieye_torch.models import heads as th
from millieye_torch.models.darknet import Darknet as TDarknet
from millieye_torch.models.zoo import tiny_yolov3_defs as tdefs
from millieye_torch.train import optim as topt
from millieye_torch.train import recipes as trec
from millieye_torch.train import steps as tsteps
from millieye_tpu.data.loader import PaddedCollate as JCollate
from millieye_tpu.data.synthetic import SyntheticScenes as JScenes
from millieye_tpu.io.checkpoint import load_checkpoint
from millieye_tpu.models import Darknet as JDarknet
from millieye_tpu.models import heads as jh
from millieye_tpu.models import tiny_yolov3_defs as jdefs
from millieye_tpu.models.fusion import FusionConfig as JConfig
from millieye_tpu.models.fusion import FusionNetwork as JFusion
from millieye_tpu.models.fusion import RefineNetwork as JRefine
from millieye_tpu.train import optim as jopt
from millieye_tpu.train import recipes as jrec
from millieye_tpu.train import steps as jsteps

torch.set_num_threads(1)

CKPT = "artifacts/stage3_final.npz"
S = 96
SMALL = 64
OVER = dict(max_det=16, max_radar=4, pre_nms_top_k=128)
# module2 at 96 px: a lower confidence keeps some image proposals
REFINE_OVER = dict(OVER, conf_thresh=0.05)
LR = 5e-4
STEP_RTOL = 1e-4


def _port(tree):
    """A JAX tree (arrays) as the port's (4-D leaves OIHW)."""
    return convert(jax.tree.map(np.asarray, tree), [])[0]


def _np(t):
    return t.detach().numpy()


@functools.lru_cache(maxsize=None)
def _host_batch(size, radar=True, n=4):
    ds = JScenes(n, seed=777, radar=radar)
    kw = dict(max_targets=64)
    if radar:
        kw.update(max_radar=OVER["max_radar"], max_points=256)
    hb = JCollate(size, **kw)([ds.get(i) for i in range(n)])
    batch = jrec.fusion_device_batch(hb, size)
    return {k: np.array(v) for k, v in batch.items()
            if k not in ("_n", "brightness")}


def _batches(size, radar=True):
    hb = _host_batch(size, radar)
    return ({k: jnp.asarray(v) for k, v in hb.items()},
            {k: torch.from_numpy(v.copy()) for k, v in hb.items()})


def _jax_from_port(jmodel, tp, ts, tmp_path):
    """The port's (params, state) as the JAX package's trees (through the
    .npz both read), without JAX's random init."""
    from millieye_torch.io.checkpoint import save_checkpoint
    path = str(tmp_path / "tree.npz")
    save_checkpoint(path, {"params": tp, "state": ts})
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    r = load_checkpoint(path, {"params": like[0], "state": like[1]})
    return jax.tree.map(jnp.asarray, (r["params"], r["state"]))


def _draws(key, refine=False):
    """The port's draw for one JAX step key: the negatives' uniform keys
    (from the key, or for module2 the first half of its split) and module2's
    dropout mask (the second half)."""
    rest, drop = jax.random.split(key) if refine else (key, None)

    def draw(kind, shape):
        if kind == "negatives":
            return torch.from_numpy(np.array(jax.random.uniform(rest, shape)))
        return torch.from_numpy(np.array(jax.random.bernoulli(drop, 0.5,
                                                              shape)))
    return draw


def _run(jstep, tstep, jts, tts, jb, tb, keys, refine=False):
    jmets, tmets = [], []
    for i, k in enumerate(keys):
        jts, jm = jstep(jts, jb, k)
        tts, tm = tstep(tts, tb, _draws(k, refine))
        jmets.append(jm)
        tmets.append(tm)
        if i == 0:
            acc = (jts.opt_state.acc_grads, tts.opt_state.acc_grads)
    return jts, tts, jmets, tmets, acc


def _check_metrics(jmets, tmets):
    for jm, tm in zip(jmets, tmets):
        assert set(tm) == set(jm)
        for k in jm:
            want, got = float(jm[k]), float(tm[k])
            if jnp.issubdtype(jnp.result_type(jm[k]), jnp.integer):
                assert got == want, k
            else:
                assert got == pytest.approx(want, rel=STEP_RTOL, abs=1e-6), k


# conv biases that feed a BN: their exact gradient is 0 (the BN removes
# any shift), so both packages compute rounding noise there
BN_FED_BIAS = re.compile(r"^(img_cnn|fcn|radar_enc)/\d+/b$|"
                         r"^refine/radar_net/conv7/b$")


def _check_tree(got, want, rtol, atol=0.0, what="", skip=None):
    items = leaf_items(_port(want))
    got = topt.tree_leaves(got)
    assert len(items) == len(got)
    for (key, w), g in zip(items, got):
        if skip is not None and skip.match(key):
            continue
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        assert err <= rtol * scale + atol, (what, key, err, scale)


def _adam_mu(jts):
    return [x for x in jax.tree.leaves(
        jts.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)][0].mu


def _check_params(tts, jts, labels=None):
    """The parameters after one Adam update (at count 1 the update is
    -lr g / (|g| + eps), g = mu / (1 - b1) the accumulated gradient):
    each trained element within lr |g_t / (|g_t| + eps) - g_j / (|g_j| +
    eps)| + 1e-7 + 2 ulp of JAX's, what the two gradients explain; every
    element
    within 2 lr; the frozen ones unchanged in both."""
    from millieye_torch.io.checkpoint import _to_file
    want = [np.asarray(x) for x in jax.tree.leaves(jts.params)]
    got = [_to_file(x) for x in topt.tree_leaves(tts.params)]
    trained = ([True] * len(got) if labels is None else
               [lab == "train" for lab in topt.tree_leaves(labels)])
    mu_j = iter(np.asarray(x) for x in jax.tree.leaves(_adam_mu(jts)))
    mu_t = iter(_to_file(x) for x in
                topt.tree_leaves(tts.opt_state.inner_opt_state.mu))
    for w, g, tr in zip(want, got, trained):
        d = np.abs(g - w)
        assert d.max(initial=0) <= 2 * LR + 1e-6
        if not tr:
            np.testing.assert_array_equal(g, w)
            continue
        gj, gt = next(mu_j) / 0.1, next(mu_t) / 0.1
        explained = LR * np.abs(gt / (np.abs(gt) + 1e-8)
                                - gj / (np.abs(gj) + 1e-8))
        # + the rounding of p + u: 1e-7, and 2 ulp of the parameter
        slack = 1e-7 + 2.4e-7 * np.abs(w)
        assert (d <= explained + slack).all(), (d - explained).max()


def _check_acc(acc):
    """The gradients after one step: within 1e-3 of each leaf's largest
    plus 1e-5 of the tree's largest; the BN-fed biases' noise is not
    compared."""
    top = max(float(np.abs(np.asarray(a)).max(initial=0.0))
              for a in jax.tree.leaves(acc[0]))
    _check_tree(acc[1], acc[0], 1e-3, 1e-5 * top, what="acc_grads",
                skip=BN_FED_BIAS)


# ------------------------------------------------------------------ heads
@pytest.mark.parametrize("shape,weighted", [((6, 5), False), ((4, 3, 3, 7),
                                                              False),
                                            ((8, 1, 1, 10), True)])
def test_batch_norm_train_matches_jax(shape, weighted):
    """Three successive train-mode BN calls: outputs and the running
    statistics (momentum 0.1, unbiased variance), weighted by a validity
    mask (the refinement head's radar BN) or not."""
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    p = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "beta": rng.normal(0, 1, c).astype(np.float32)}
    js = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    ts = {"mean": torch.zeros(c), "var": torch.ones(c)}
    for i in range(3):
        x = rng.normal(i, 2.0, shape).astype(np.float32)
        w = ((rng.uniform(size=shape[0]) < 0.6).astype(np.float32)
             if weighted else None)
        jy, js = jh.batch_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                               js, True,
                               weight=None if w is None else jnp.asarray(w))
        ty, ts = th.batch_norm(torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in p.items()},
                               ts, True,
                               weight=None if w is None else
                               torch.from_numpy(w))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5,
                                   atol=5e-6)
        for k in ("mean", "var"):
            np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]),
                                       rtol=1e-5, atol=5e-6)


def test_heads_train_mode_match_jax(tmp_path):
    """The score-map stack, the radar encoder and module2's refinement head
    with its dropout (JAX's bernoulli mask injected), in train mode: outputs
    and new states."""
    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(0)
    stack_p, stack_s = th.conv_bn_stack_init(gen, (256, 490))
    enc_p, enc_s = th.radar_encoder_init(gen)
    ref_p, ref_s = th.refinement_head_init(gen, net2_out=13, with_radar=False)
    j = {}
    for name, tree in (("stack", (stack_p, stack_s)), ("enc", (enc_p, enc_s)),
                       ("ref", (ref_p, ref_s))):
        from millieye_torch.io.checkpoint import _to_file
        j[name] = jax.tree.map(lambda t: jnp.asarray(_to_file(t)), tree)
    fmap = rng.normal(0, 1, (2, 6, 6, 256)).astype(np.float32)
    heat = rng.uniform(0, 1, (2, 6, 6, 3)).astype(np.float32)
    crop = rng.normal(0, 1, (5, 7, 7, 10)).astype(np.float32)

    jy, jst = jh.conv_bn_stack_apply(*j["stack"], jnp.asarray(fmap), True)
    ty, tst = th.conv_bn_stack_apply(stack_p, stack_s,
                                     torch.from_numpy(fmap), True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    _check_tree(tst, jst, 1e-5, 1e-6, "stack state")

    jy, jst = jh.radar_encoder_apply(*j["enc"], jnp.asarray(heat), True)
    ty, tst = th.radar_encoder_apply(enc_p, enc_s, torch.from_numpy(heat),
                                     True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    _check_tree(tst, jst, 1e-5, 1e-6, "encoder state")

    key = jax.random.PRNGKey(3)
    jb, jv, _ = jh.refinement_head_apply(*j["ref"], None, jnp.asarray(crop),
                                         train=True, dropout_rng=key,
                                         class_num=12)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5,
                                                          (5, 256))))
    tb, tv, _ = th.refinement_head_apply(ref_p, ref_s, None,
                                         torch.from_numpy(crop), train=True,
                                         dropout_keep=keep, class_num=12)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_losses_match_jax():
    """focal_loss, bce_sum and smooth_l1_sum over a sample mask, with NaN
    and inf outside it: values and gradients."""
    rng = np.random.default_rng(4)
    n = 12
    w = (rng.uniform(size=n) < 0.5).astype(np.float32)
    p2 = rng.uniform(0.01, 0.99, (n, 2)).astype(np.float32)
    p2 /= p2.sum(-1, keepdims=True)
    lab = np.zeros((n, 2), np.float32)
    lab[np.arange(n), rng.integers(0, 2, n)] = 1
    pr = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    tg = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    tg[w == 0] = np.nan
    p1 = rng.uniform(0.01, 0.99, n).astype(np.float32)
    for jfn, tfn, args in (
            (jh.focal_loss, th.focal_loss, (p2, lab, w)),
            (jh.bce_sum, th.bce_sum, (p1, (p1 > 0.5).astype(np.float32), w)),
            (jh.smooth_l1_sum, th.smooth_l1_sum, (pr, tg, w))):
        jv, jg = jax.value_and_grad(lambda a: jfn(a, *map(jnp.asarray,
                                                          args[1:])))(
            jnp.asarray(args[0]))
        x = torch.from_numpy(args[0].copy()).requires_grad_(True)
        tv = tfn(x, *map(torch.from_numpy, args[1:]))
        (tgr,) = torch.autograd.grad(tv, x)
        assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5)
        np.testing.assert_allclose(tgr.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6)


# -------------------------------------------------------------- optimizer
def _opt_tree(rng):
    return {"a": {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
                  "b": rng.normal(0, 1, (4,)).astype(np.float32)},
            "frozen": {"w": rng.normal(0, 1, (2, 2)).astype(np.float32)},
            "lst": [rng.normal(0, 1, (5,)).astype(np.float32),
                    rng.normal(0, 1, (2, 3)).astype(np.float32)]}


@pytest.mark.parametrize("clip,wd", [(None, 0.0), (1.0, 0.0), (None, 0.01)])
def test_frozen_adam_matches_optax(clip, wd):
    """4 steps at every_k 2 with a frozen subtree; steps 3-4 carry NaN,
    inf and 1e30 gradients: with the clip the chain zeroes and bounds
    them, without it they reach the moments and the parameters as in
    optax (NaN where optax has NaN)."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    frozen = (("frozen",),)
    jtx = jopt.frozen_adam(jax.tree.map(jnp.asarray, params), lr=0.1,
                           frozen_prefixes=frozen, every_k=2,
                           weight_decay=wd, grad_clip=clip)
    tparams = jax.tree.map(torch.from_numpy, params)
    ttx = topt.frozen_adam(tparams, lr=0.1, frozen_prefixes=frozen,
                           every_k=2, weight_decay=wd, grad_clip=clip)
    jp, tp = jax.tree.map(jnp.asarray, params), tparams
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(4):
        g = jax.tree.map(lambda a: rng.normal(0, 3, a.shape).astype(
            np.float32), params)
        if i >= 2:
            g["a"]["w"][0, 0] = np.nan
            g["lst"][0][1] = np.inf
            g["a"]["b"][:] = 1e30
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        jp = optax.apply_updates(jp, ju)
        tp = topt.tree_map(lambda p, u: p + u, tp, tu)
        for a, b in zip(jax.tree.leaves(ju), topt.tree_leaves(tu)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(jax.tree.leaves(jp), topt.tree_leaves(tp)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    # frozen leaves never moved and keep no moments
    np.testing.assert_array_equal(_np(tp["frozen"]["w"]),
                                  params["frozen"]["w"])
    adam = ts.inner_opt_state
    assert adam.mu["frozen"]["w"] is None and int(adam.count) == 2
    jadam = [s for s in jax.tree.leaves(
        js, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    for a, b in zip(jax.tree.leaves(jadam.mu), topt.tree_leaves(adam.mu)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(jax.tree.leaves(jadam.nu), topt.tree_leaves(adam.nu)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6)
    assert int(ts.mini_step) == int(js.mini_step)
    assert int(ts.gradient_step) == int(js.gradient_step) == 2


def test_label_tree_matches_jax():
    rng = np.random.default_rng(1)
    params = {"darknet": [{"w": np.zeros(2)}, {}], "img_cnn": [{"w": 1}],
              "refine": {"net0": {"w": 0}, "radar_net": {"b": 0}},
              "radar_enc": [{"b": 0}], "ensemble": {"fc1": {"w": 0}}}
    del rng
    assert (topt.label_tree(params, topt.STAGE3_FROZEN)
            == jopt.label_tree(params, jopt.STAGE3_FROZEN))


# ------------------------------------------------------------ train steps
@functools.lru_cache(maxsize=None)
def _yolo_models():
    tdark = TDarknet(tdefs(num_classes=12, img_size=SMALL), img_size=SMALL)
    jdark = JDarknet(jdefs(num_classes=12, img_size=SMALL), img_size=SMALL)
    return tdark, jdark


def test_yolo_train_step_matches_jax(tmp_path):
    tdark, jdark = _yolo_models()
    tp, ts = tdark.init(torch.Generator().manual_seed(0))
    jp, js = _jax_from_port(jdark, tp, ts, tmp_path)
    jtx = jopt.frozen_adam(jp, lr=LR, every_k=2)
    ttx = topt.frozen_adam(tp, lr=LR, every_k=2)
    jb, tb = _batches(SMALL, radar=False)
    jb = {k: jb[k] for k in ("images", "targets", "tmask")}
    jts, tts, jm, tm, acc = _run(
        jax.jit(jsteps.make_yolo_train_step(jdark, jtx)),
        tsteps.make_yolo_train_step(tdark, ttx),
        jsteps.init_train_state(jp, js, jtx),
        tsteps.init_train_state(tp, ts, ttx), jb, tb,
        jax.random.split(jax.random.PRNGKey(1), 2))
    _check_metrics(jm, tm)
    _check_acc(acc)
    _check_tree(tts.state, jts.state, 1e-5, 1e-6, "bn state")
    _check_params(tts, jts)
    assert tts.step == int(jts.step) == 2


def _on_detections(model, params, state, jb, tb):
    """The batch's targets moved onto the frozen detector's boxes (each
    box's centre shifted by 2% of its size), so that the image proposals
    of module2 at 96 px, whose persons are 5-15 px wide, have positives."""
    from millieye_torch.ops.boxes import xyxy_to_xywh
    from millieye_torch.ops.nms import batched_nms
    cfg = model.cfg
    with torch.no_grad():
        d = model.darknet.apply(params["darknet"], state["darknet"],
                                tb["images"])
        det, valid = batched_nms(d["detections"], cfg.conf_thresh,
                                 cfg.nms_thresh, max_det=cfg.max_det,
                                 pre_top_k=cfg.pre_nms_top_k)
    xywh = xyxy_to_xywh(det[..., :4]).numpy() / S
    targets = np.zeros((len(valid), 8, 5), np.float32)
    tmask = np.zeros((len(valid), 8), bool)
    for i, v in enumerate(valid.numpy()):
        n = min(int(v.sum()), 8)
        targets[i, :n, 0] = det[i, :n, 6].numpy()
        targets[i, :n, 1:3] = xywh[i, :n, :2] + 0.02 * xywh[i, :n, 2:]
        targets[i, :n, 3:5] = xywh[i, :n, 2:]
        tmask[i, :n] = True
    assert tmask.any()
    out = {"images": tb["images"].numpy(), "targets": targets,
           "tmask": tmask}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v.copy()) for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def _jax_refine():
    darknet = JDarknet(jdefs(num_classes=12, img_size=S), img_size=S)
    return JRefine(darknet, JConfig(class_num=12, loss_variant="module2",
                                    loss_lambda=(15.0, 5.0),
                                    nms_use_pallas=False, **REFINE_OVER))


def test_refine_train_step_matches_jax(tmp_path):
    """module2 on the checkpoint's Darknet and score-map stack (seed-0
    heads, ``build_refine``): dropout and negatives from the JAX step's
    key."""
    tmodel, tp, ts = build_refine(CKPT, img_size=S, device="cpu",
                                  **REFINE_OVER)
    jmodel = _jax_refine()
    jp, js = _jax_from_port(jmodel, tp, ts, tmp_path)
    jtx = jopt.frozen_adam(jp, lr=LR, frozen_prefixes=jopt.STAGE2_FROZEN,
                           every_k=2)
    ttx = topt.frozen_adam(tp, lr=LR, frozen_prefixes=topt.STAGE2_FROZEN,
                           every_k=2)
    jb, tb = _on_detections(tmodel, tp, ts, *_batches(S))
    jts, tts, jm, tm, acc = _run(
        jax.jit(jsteps.make_refine_train_step(
            jmodel, jtx, frozen_prefixes=jopt.STAGE2_FROZEN)),
        tsteps.make_refine_train_step(tmodel, ttx,
                                      frozen_prefixes=topt.STAGE2_FROZEN),
        jsteps.init_train_state(jp, js, jtx),
        tsteps.init_train_state(tp, ts, ttx), jb, tb,
        jax.random.split(jax.random.PRNGKey(2), 2), refine=True)
    assert float(tm[0]["true"]) > 0          # the batch has positives
    _check_metrics(jm, tm)
    _check_acc(acc)
    _check_tree(tts.state, jts.state, 1e-5, 1e-6, "bn state")
    _check_params(tts, jts, topt.label_tree(tp, topt.STAGE2_FROZEN))
    # the frozen Darknet and its BN statistics did not move
    for a, b in zip(topt.tree_leaves(tts.params["darknet"]),
                    topt.tree_leaves(tp["darknet"])):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_fusion(fold):
    kw = {}
    if fold:
        # TRAIN_FOLD's network, unfolded: the JAX --fold_frozen model
        kw = dict(hi_prec_stages=(0, 2, 4), pallas_stem_stages=(0, 2),
                  pallas_stem_pair=True, pallas_stem_precision="default",
                  pallas_stem_pair_variant="phase_s01")
    darknet = JDarknet(jdefs(num_classes=12, img_size=S), img_size=S, **kw)
    cfg = JConfig(nms_use_pallas=False,
                  compute_dtype="bfloat16" if fold else "float32", **OVER)
    return JFusion(darknet, cfg)


def _fusion_both(tmp_path, fold, jfold=None):
    tmodel, tp, ts = build_fusion(CKPT, TRAIN_FOLD if fold else "f32",
                                  img_size=S, device="cpu", **OVER)
    jmodel = _jax_fusion(fold if jfold is None else jfold)
    jp, js = _jax_from_port(jmodel, tp, ts, tmp_path)
    return tmodel, tp, ts, jmodel, jp, js


def test_fusion_train_step_matches_jax(tmp_path):
    tmodel, tp, ts, jmodel, jp, js = _fusion_both(tmp_path, False)
    frozen = topt.STAGE3_FROZEN
    jtx = jopt.frozen_adam(jp, lr=LR, frozen_prefixes=frozen, every_k=2)
    ttx = topt.frozen_adam(tp, lr=LR, frozen_prefixes=frozen, every_k=2)
    jb, tb = _batches(S)
    jts, tts, jm, tm, acc = _run(
        jax.jit(jsteps.make_fusion_train_step(jmodel, jtx,
                                              frozen_prefixes=frozen)),
        tsteps.make_fusion_train_step(tmodel, ttx, frozen_prefixes=frozen),
        jsteps.init_train_state(jp, js, jtx),
        tsteps.init_train_state(tp, ts, ttx), jb, tb,
        jax.random.split(jax.random.PRNGKey(5), 2))
    assert float(tm[0]["true"]) > 0
    _check_metrics(jm, tm)
    _check_acc(acc)
    _check_tree(tts.state, jts.state, 1e-5, 1e-6, "bn state")
    labels = topt.label_tree(tp, frozen)
    _check_params(tts, jts, labels)
    for lab, a, b in zip(topt.tree_leaves(labels),
                         topt.tree_leaves(tts.params), topt.tree_leaves(tp)):
        if lab == "freeze":
            assert torch.equal(a, b)


def test_fusion_fold_step(tmp_path):
    """The --fold_frozen step (``TRAIN_FOLD``: bf16 convolutions, the stem
    pair's plain version at "default" on the folded Darknet) against the
    JAX unfolded step of the same network (XLA's bf16 convolutions; the
    JAX fold step interprets the Pallas pair, ~100 s of compile, so it is
    not run here), and against the port's own unfolded step. bf16 class:
    the frozen forward's detections move by bf16 roundings, so the loss
    terms are held within 2e-2 relative and the positive counts equal; the
    frozen leaves are bit-identical and the trained ones moved."""
    tmodel, tp, ts, jmodel, jp, js = _fusion_both(tmp_path, True)
    frozen = topt.STAGE3_FROZEN
    jtx = jopt.frozen_adam(jp, lr=LR, frozen_prefixes=frozen, every_k=2)
    jb, tb = _batches(S)
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    jstep = jax.jit(jsteps.make_fusion_train_step(jmodel, jtx,
                                                  frozen_prefixes=frozen))
    jts = jsteps.init_train_state(jp, js, jtx)
    runs = {}
    for fold in (True, False):
        ttx = topt.frozen_adam(tp, lr=LR, frozen_prefixes=frozen, every_k=2)
        step = tsteps.make_fusion_train_step(tmodel, ttx,
                                             frozen_prefixes=frozen,
                                             fold_frozen=fold)
        tts = tsteps.init_train_state(tp, ts, ttx)
        mets = []
        for k in keys:
            tts, m = step(tts, tb, _draws(k))
            mets.append(m)
        runs[fold] = (tts, mets)
    jmets = []
    for k in keys:
        jts, m = jstep(jts, jb, k)
        jmets.append(m)
    for other in (jmets, runs[False][1]):
        for a, b in zip(other, runs[True][1]):
            for k in ("true", "positive", "tp", "total"):
                assert float(b[k]) == float(a[k]), k
            for k in ("loss", "masks_loss", "conf_loss"):
                assert float(b[k]) == pytest.approx(float(a[k]), rel=2e-2), k
    tts = runs[True][0]
    assert int(runs[True][1][-1]["nonfinite_reverted"]) == 0
    labels = topt.label_tree(tp, frozen)
    moved = []
    for lab, a, b in zip(topt.tree_leaves(labels),
                         topt.tree_leaves(tts.params), topt.tree_leaves(tp)):
        if lab == "freeze":
            assert torch.equal(a, b)
        else:
            moved.append(not torch.equal(a, b))
    assert all(moved)
    for a, b in zip(topt.tree_leaves(tts.state["darknet"]),
                    topt.tree_leaves(ts["darknet"])):
        assert torch.equal(a, b)


def test_nonfinite_reverted_on_poisoned_batch(tmp_path):
    """A batch that poisons the forward (1e30 images: NaN loss) leaves the
    parameters and BN statistics finite (the step reverts them) and
    reports the same count of reverted elements as the JAX step; a sane
    batch afterwards trains on. grad_clip 10, every_k 1."""
    tdark, jdark = _yolo_models()
    tp, ts = tdark.init(torch.Generator().manual_seed(0))
    jp, js = _jax_from_port(jdark, tp, ts, tmp_path)
    jtx = jopt.frozen_adam(jp, lr=1e-3, grad_clip=10.0)
    ttx = topt.frozen_adam(tp, lr=1e-3, grad_clip=10.0)
    targets = np.zeros((2, 3, 5), np.float32)
    targets[:, 0] = (0, 0.5, 0.5, 0.3, 0.3)
    tmask = np.zeros((2, 3), bool)
    tmask[:, 0] = True
    poison = {"images": np.full((2, SMALL, SMALL, 3), 1e30, np.float32),
              "targets": targets, "tmask": tmask}
    jstep = jax.jit(jsteps.make_yolo_train_step(jdark, jtx))
    tstep = tsteps.make_yolo_train_step(tdark, ttx)
    jts, jm = jstep(jsteps.init_train_state(jp, js, jtx), poison,
                    jax.random.PRNGKey(1))
    tts, tm = tstep(tsteps.init_train_state(tp, ts, ttx),
                    {k: torch.from_numpy(v) for k, v in poison.items()})
    assert int(tm["nonfinite_reverted"]) == int(jm["nonfinite_reverted"]) > 0
    for leaf in topt.tree_leaves((tts.params, tts.state, tts.opt_state)):
        if leaf.is_floating_point():
            assert torch.isfinite(leaf).all()
    sane = dict(poison, images=np.random.default_rng(0).uniform(
        size=(2, SMALL, SMALL, 3)).astype(np.float32))
    tts, tm = tstep(tts, {k: torch.from_numpy(v) for k, v in sane.items()})
    assert torch.isfinite(tm["loss"]) and int(tm["nonfinite_reverted"]) == 0


def test_transfer_module2_to_fusion():
    """module2 -> module3: the refine tree's fcn into img_cnn and nets 0-2
    into the fusion head, as the JAX function does; radar_net and the rest
    kept."""
    gen = torch.Generator().manual_seed(3)
    rp, rs = th.conv_bn_stack_init(gen, (256, 490))
    rref, _ = th.refinement_head_init(gen, net2_out=13, with_radar=False)
    fp = {"img_cnn": th.conv_bn_stack_init(gen, (256, 490))[0],
          "refine": th.refinement_head_init(gen)[0], "ensemble": {"x": 1}}
    fs = {"img_cnn": [{"mean": torch.zeros(490), "var": torch.ones(490)}],
          "refine": {}}
    r_params, r_state = {"fcn": rp, "refine": rref}, {"fcn": rs}
    tp, ts = trec.transfer_module2_to_fusion(r_params, r_state, fp, fs)
    jtree = jax.tree.map(lambda t: np.asarray(t) if isinstance(
        t, torch.Tensor) else t, (r_params, r_state, fp, fs))
    jp, js = jrec.transfer_module2_to_fusion(*jtree)
    assert tp["img_cnn"] is not fp["img_cnn"]
    for a, b in zip(topt.tree_leaves((tp, ts)),
                    jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tp["refine"]["radar_net"] is fp["refine"]["radar_net"]
    assert tp["refine"]["net0"] is rref["net0"]
