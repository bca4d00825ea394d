"""``chip_smoke.py``'s proof that a path differs from its fully plain run
by NMS decisions alone (``nms_flip_proof``, ``nms_flips``), on the CPU.

On the card the tensor-core kernels move the network's outputs by a few
bf16 steps, and a greedy NMS decision near a tie or a threshold can go
the other way. Here a stand-in for ``cuda_lib`` marks the "kernel" run
(outside ``plain_versions()``), and the network's detections are nudged
in that run only. The proof must accept decisions flipped that way and
refuse a box that moved, an answer that is not the NMS of its inputs, and
a score beyond the tolerance."""
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from millieye_torch.cli._common import build_fusion
from millieye_torch.runtime.engine import FusionEngine

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parents[1] / "artifacts/stage3_final.npz"
TOL = cs.PAIR_PATH_TOL


class _Lib:
    """``cuda_lib``'s switch: ``plain`` is True inside plain_versions()."""
    plain = False

    @contextlib.contextmanager
    def plain_versions(self, keep=()):
        prev, _Lib.plain = _Lib.plain, True
        try:
            yield
        finally:
            _Lib.plain = prev


@pytest.fixture(scope="module")
def engine():
    model, params, state = build_fusion(str(CKPT), "pallas_max4",
                                        device="cpu")
    return FusionEngine(model, params, state, device="cpu")


def _inputs(engine, d, move=0.0, score=0.0):
    """Post-merge NMS inputs [K, 7]: a box, one at shift ``d`` whose IoU
    with it is near 0.3, one overlapping that, and a fourth apart (moved
    by ``move`` px, its score raised by ``score``)."""
    k = engine.model.cfg.max_det + engine.model.cfg.max_radar
    rows, valid = np.zeros((k, 7), np.float32), np.zeros(k, bool)
    boxes = [[100, 100, 200, 200, .9], [100 + d, 100, 200 + d, 200, .8],
             [140 + d, 100, 240 + d, 200, .7],
             [50 + move, 300, 90 + move, 380, .6 + score]]
    for i, b in enumerate(boxes):
        rows[i, :5], rows[i, 6], valid[i] = b, 1, True
    return torch.from_numpy(rows), torch.from_numpy(valid)


def _post(engine, inputs):
    return tuple(a.numpy() for a in engine._post(*inputs))


@pytest.mark.parametrize("case", ["flip", "moved", "not_nms", "score"])
def test_nms_flip_proof(engine, case):
    """IoU 0.3 lies between shifts 53.7 and 54.0 px: the second box is
    suppressed on one side and kept on the other, which suppresses the
    third: two rows on one side only, proven. A fourth box moved 5 px, a
    row dropped from the answer, or a score raised 0.05 is refused."""
    want_in = _inputs(engine, 54.0)
    got_in = _inputs(engine, 53.7, move=5.0 * (case == "moved"),
                     score=0.05 * (case == "score"))
    got, want = _post(engine, got_in), _post(engine, want_in)
    if case == "not_nms":
        got[1][np.flatnonzero(got[1])[-1]] = False
    assert not cs.rows_match(got, want, TOL)[0]
    ok, why, moved = cs.nms_flip_proof(torch, _Lib(), engine, got, want,
                                       got_in, want_in, TOL)
    assert ok == (case == "flip"), why
    if ok:
        assert moved == 2


@pytest.mark.parametrize("fault", [None, "shift", "drop"])
def test_nms_flips_on_perturbed_detections(engine, monkeypatch, fault):
    """Detections nudged in the "kernel" run (objectness by up to 0.005,
    centres by up to 0.2 px) flip pre-merge NMS decisions, which
    ``nms_flips`` proves by taking the other run's decisions. It refuses
    every frame beyond the tolerance when the best anchor's box also
    shifts 8 px ("shift"), or when the "kernel" run's pre-merge NMS drops
    its first row ("drop"): an answer that is not the NMS of its
    detections."""
    from millieye_torch.models import fusion
    dn = engine.model.darknet
    real_apply, real_nms = dn.apply, fusion.batched_nms

    def nudged(*args, **kw):
        out = real_apply(*args, **kw)
        if _Lib.plain:
            return out
        d = out["detections"].clone()
        g = torch.Generator().manual_seed(0)
        d[..., 4] += (torch.rand(d.shape[:-1], generator=g) - 0.5) * 0.01
        d[..., :2] += (torch.rand(d.shape[:-1] + (2,), generator=g)
                       - 0.5) * 0.4
        if fault == "shift":
            d[0, d[0, :, 4].argmax(), 0] += 8.0
        return dict(out, detections=d)

    def dropping(*args, **kw):
        out, valid = real_nms(*args, **kw)
        if not _Lib.plain:
            valid = valid.clone()
            valid[:, 0] = False
        return out, valid

    dn.apply = nudged
    if fault == "drop":
        monkeypatch.setattr(fusion, "batched_nms", dropping)
    try:
        beyond, anchors = 0, 0
        for req in cs.requests(np.random.default_rng(1), 3):
            def call(req=req):
                return engine.infer(*req)
            got = call()
            with _Lib().plain_versions():
                want = call()
            if cs.rows_match(got, want, TOL)[0]:
                continue
            beyond += 1
            if fault:
                with pytest.raises(AssertionError):
                    cs.nms_flips(torch, _Lib(), engine, lambda: [call()],
                                 [got], TOL)
            else:
                anchors += cs.nms_flips(torch, _Lib(), engine,
                                        lambda: [call()], [got], TOL)[0]
    finally:
        del dn.apply
    assert beyond
    assert fault or anchors


@pytest.mark.parametrize("fault", [None, "shift"])
def test_window_flips_on_perturbed_window(engine, fault):
    """A window's detections nudged as the batched convolutions move them
    (objectness by up to 0.005, centres by up to 0.2 px, in the window's
    run only) flip NMS decisions against the frames run one at a time;
    ``window_flips`` proves them by taking the other side's decisions,
    and refuses the window when its best anchor's box also shifts 8 px."""
    dn = engine.model.darknet
    real_apply = dn.apply

    def nudged(*args, **kw):
        out = real_apply(*args, **kw)
        d = out["detections"]
        if d.shape[0] == 1:                      # a frame alone
            return out
        d = d.clone()
        g = torch.Generator().manual_seed(0)
        d[..., 4] += (torch.rand(d.shape[:-1], generator=g) - 0.5) * 0.01
        d[..., :2] += (torch.rand(d.shape[:-1] + (2,), generator=g)
                       - 0.5) * 0.4
        if fault == "shift":
            d[0, d[0, :, 4].argmax(), 0] += 8.0
        return dict(out, detections=d)

    reqs = cs.requests(np.random.default_rng(1), 2)
    tens = [torch.from_numpy(np.ascontiguousarray(np.stack(a)))
            for a in [[f for f, _, _ in reqs]]
            + [list(c) for c in zip(*[engine.pack_radar(p, b)
                                      for _, p, b in reqs])]]
    step = engine.batched_step_fn(0)

    def window():
        return list(zip(*(a.numpy() for a in step(*tens))))

    frame_calls = [lambda r=r: engine.infer(*r) for r in reqs]
    dn.apply = nudged
    try:
        got = window()
        assert not all(cs.rows_match(g, c(), TOL)[0]
                       for g, c in zip(got, frame_calls))
        if fault:
            with pytest.raises(AssertionError, match="not by NMS"):
                cs.window_flips(torch, _Lib(), engine, window, frame_calls,
                                got, TOL)
        else:
            anchors, moved = cs.window_flips(torch, _Lib(), engine, window,
                                             frame_calls, got, TOL)
            assert anchors > 0
    finally:
        del dn.apply
