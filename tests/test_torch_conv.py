"""The float32 convolution K15 (``ops/conv.py``) on the CPU: its plain
version against ``F.conv2d``, the packed weights, the forms the op
refuses, the shapes and ints the profiler records for the op (what the
benchmark's ``conv.roofline`` counts from), and the Darknet runner's
choice: a float32 plain inference convolution on the card's kernels
(``darknet.on_card``) reaches the op, on a channels_last input;
training, 16-bit compute, int8 slots and the s2d stages never do. The
kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``)."""
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from millieye_torch.models import darknet as tdark
from millieye_torch.models.darknet import Darknet
from millieye_torch.models.zoo import (tiny_yolov3_defs, yolov3_defs,
                                       yolov4_defs)
from millieye_torch.ops import conv as kconv
from millieye_torch.ops import quantize as tq

E = 64                  # the routing tests' image size


def _on_card(t, mode):
    """A fake CUDA copy of ``t`` (layout and ``requires_grad`` kept): what
    the runner's predicate sees on the card."""
    with mode:
        return torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype,
            device="cuda").requires_grad_(t.requires_grad)


def _nhwc(n, c, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, h, w, c), generator=g).permute(0, 3, 1, 2)


# (batch, Cin, Cout, k, stride, H, W)
_SHAPES = [(2, 3, 32, 3, 1, 13, 14), (2, 3, 32, 3, 2, 12, 13),
           (2, 8, 255, 1, 1, 9, 9), (1, 16, 24, 3, 2, 11, 10),
           (2, 12, 8, 1, 2, 10, 10), (2, 4, 5, 3, 1, 7, 8),
           (1, 32, 255, 1, 1, 5, 5), (3, 3, 16, 3, 2, 9, 9)]


@pytest.mark.parametrize("n,cin,cout,k,s,h,w", _SHAPES)
def test_plain_version_equals_conv2d(n, cin, cout, k, s, h, w):
    """The plain version (unfold in (r, s, c) order, one float32 product)
    is ``F.conv2d`` within 1e-5 of its largest output, channels_last
    float32 out, and on the CPU no kernel launches."""
    x = _nhwc(n, cin, h, w, cin + cout)
    g = torch.Generator().manual_seed(k * 100 + s)
    wt = torch.randn((cout, cin, k, k), generator=g) / (k * k * cin) ** 0.5
    before = kconv.conv2d_nhwc.launches
    got = kconv.conv2d_nhwc(x, wt, s, (k - 1) // 2)
    want = F.conv2d(x, wt, stride=s, padding=(k - 1) // 2)
    assert kconv.conv2d_nhwc.launches == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_packed_weights_are_made_once_a_weight_tensor():
    """``pack_weight``: dense [kh, kw, Cin, Cout] with Cout padded with
    zero channels to a multiple of 4; the same tensor on a second call, a
    new one after an in-place change."""
    w = torch.randn((255, 8, 3, 3), generator=torch.Generator().manual_seed(1))
    wp = kconv.pack_weight(w)
    assert wp.shape == (3, 3, 8, 256) and wp.is_contiguous()
    assert torch.equal(wp[..., :255], w.permute(2, 3, 1, 0))
    assert torch.equal(wp[..., 255], torch.zeros(3, 3, 8))
    assert kconv.pack_weight(w) is wp
    with torch.no_grad():
        w.add_(1.0)
    again = kconv.pack_weight(w)
    assert again is not wp
    assert torch.equal(again[..., :255], w.permute(2, 3, 1, 0))
    assert kconv.pack_weight(torch.zeros(32, 3, 3, 3)).shape == (3, 3, 3, 32)


def _bad_forms():
    x = _nhwc(1, 8, 6, 6, 0)
    w3 = torch.randn(4, 8, 3, 3)
    return [
        ("bf16", x.bfloat16(), w3.bfloat16(), 1, 1),
        ("f16", x.half(), w3, 1, 1),
        ("nchw input", x.contiguous(), w3, 1, 1),
        ("groups 2", x, torch.randn(4, 4, 3, 3), 1, 1),
        ("kernel 5", x, torch.randn(4, 8, 5, 5), 1, 2),
        ("kernel 3x1", x, torch.randn(4, 8, 3, 1), 1, 1),
        ("stride 3", x, w3, 3, 1),
        ("padding 0", x, w3, 1, 0),
        ("6 channels, 3x3", _nhwc(1, 6, 6, 6, 0), torch.randn(4, 6, 3, 3),
         1, 1),
    ]


@pytest.mark.parametrize("case", _bad_forms(), ids=lambda c: c[0])
def test_the_op_refuses_what_the_kernel_does_not_take(case):
    """``conv2d_nhwc`` raises on every form but an NCHW input, which it
    makes channels_last itself; ``takes_form``, the form's shapes alone,
    refuses the kernel sizes, strides, paddings and channel counts."""
    name, x, w, s, p = case
    if name == "nchw input":
        got = kconv.conv2d_nhwc(x, w, s, p)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, kconv.conv2d_nhwc(
            x.contiguous(memory_format=torch.channels_last), w, s, p))
    else:
        with pytest.raises(ValueError, match="conv2d_nhwc"):
            kconv.conv2d_nhwc(x, w, s, p)
    assert kconv.takes_form(x.shape[1], w.shape[2], w.shape[3], s, p) == (
        name in ("bf16", "f16", "nchw input", "groups 2"))


def _vectors(cout, bn, seed):
    g = torch.Generator().manual_seed(seed)
    beta = 0.1 * torch.randn(cout, generator=g)
    if not bn:
        return (beta,)
    return (beta, 0.1 * torch.randn(cout, generator=g),
            torch.rsqrt(torch.rand(cout, generator=g) + 0.5 + 1e-5),
            1 + 0.1 * torch.randn(cout, generator=g))


# (batch, Cin, Cout, k, stride, side, batch norm, activation)
_TAILS = [(2, 16, 32, 3, 1, 9, True, "leaky"),
          (2, 16, 32, 3, 2, 9, True, "leaky"),
          (1, 32, 64, 1, 1, 6, True, "leaky"),
          (2, 3, 32, 3, 1, 10, True, "leaky"),
          (1, 32, 255, 1, 1, 5, False, "linear"),
          (1, 16, 24, 3, 1, 7, False, "leaky"),
          (1, 16, 20, 1, 1, 7, False, "linear")]


@pytest.mark.parametrize("add", [False, True], ids=["tail", "tail+add"])
@pytest.mark.parametrize("n,cin,cout,k,s,side,bn,act", _TAILS)
def test_the_tail_in_the_store_is_conv_then_epilogue_then_add(
        n, cin, cout, k, s, side, bn, act, add):
    """The op with a tail in its store (batch norm + leaky, the bias +
    linear of the 255-channel heads, and the other pairs), with and
    without a shortcut's residual: its plain version is the plain
    convolution, then ``epilogue_eager``, then the eager add, the same
    bits, channels_last float32; on the CPU no launch."""
    from millieye_torch.ops import epilogue as epi
    x = _nhwc(n, cin, side, side, cin + cout + k)
    g = torch.Generator().manual_seed(side)
    w = torch.randn((cout, cin, k, k), generator=g) / (k * k * cin) ** 0.5
    vecs = _vectors(cout, bn, cout)
    pad = (k - 1) // 2
    y = kconv.conv2d_nhwc(x, w, s, pad)
    res = torch.randn(y.shape, generator=g) if add else None
    before = kconv.conv2d_nhwc.launches
    got = kconv.conv2d_nhwc(x, w, s, pad, *vecs, act=act, residual=res)
    assert kconv.conv2d_nhwc.launches == before
    want = epi.epilogue_eager(y, *vecs, act=act)
    if add:
        want = want + res
    assert got.dtype == torch.float32 and got.shape == y.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    # the op itself, handed the packed weights and the code
    op = kconv._op(x.contiguous(memory_format=torch.channels_last),
                   kconv.pack_weight(w), cout, s, pad, *vecs,
                   *(None,) * (4 - len(vecs)), epi.act_code(act),
                   None if res is None
                   else res.contiguous(memory_format=torch.channels_last))
    assert torch.equal(op, want)


def _bad_tails():
    y = torch.empty((2, 8, 5, 5)).contiguous(memory_format=torch.channels_last)
    v = torch.rand(8)
    bn = (v, torch.rand(8), torch.rand(8), torch.rand(8))
    return [
        ("float64 bias", (v.double(),), None, 1),
        ("bias of 7", (torch.rand(7),), None, 1),
        ("bias strided", (torch.rand(16)[::2],), None, 1),
        ("bias of 8 x 1", (torch.rand(8, 1),), None, 1),
        ("mean without gamma", (v, bn[1], bn[2], None), None, 1),
        ("inv without mean", (v, None, bn[2], bn[3]), None, 1),
        ("inv float16", (v, bn[1], bn[2].half(), bn[3]), None, 1),
        ("batch norm then linear", bn, None, 0),
        ("nchw residual", bn, torch.rand(2, 8, 5, 5), 1),
        ("residual of another shape", bn, torch.rand(
            2, 8, 5, 4).contiguous(memory_format=torch.channels_last), 1),
        ("float16 residual", bn, torch.rand(2, 8, 5, 5).half().contiguous(
            memory_format=torch.channels_last), 1),
    ], y


@pytest.mark.parametrize("case", _bad_tails()[0], ids=lambda c: c[0])
def test_the_op_refuses_tails_the_kernel_does_not_take(case):
    """What the kernel's store takes, and the op checks on the card: [Cout]
    dense float32 vectors on the output's device (batch norm's four, then
    leaky, or the bias alone), and a channels_last float32 residual of
    the output's shape. It raises on every other; it never falls back.
    (That they are 16-byte aligned the kernel's C entry checks: a card
    test.)"""
    _, vecs, res, act = case
    y = _bad_tails()[1]
    vecs = tuple(vecs) + (None,) * (4 - len(vecs))
    with pytest.raises(ValueError, match="conv2d_nhwc"):
        kconv._tail_ptrs(y, 8, *vecs, act, res)


def test_the_op_takes_linear_and_leaky_tails_only():
    """A tail is batch norm then leaky, or the bias then leaky or linear
    (``takes_tail``): Mish, batch norm then linear, and a residual with
    no tail before it, are refused, on the CPU as on the card; the
    vectors and residual the kernel takes pass its check."""
    assert [kconv.takes_tail(bn, act) for bn in (True, False)
            for act in ("leaky", "linear", "mish")] == [
        True, False, False, True, True, False]
    x, w = _nhwc(1, 8, 6, 6, 0), torch.randn(4, 8, 3, 3)
    b = torch.rand(4)
    with pytest.raises(ValueError, match="Mish runs in K14"):
        kconv.conv2d_nhwc(x, w, 1, 1, b, act="mish")
    with pytest.raises(ValueError, match="batch norm then linear"):
        kconv.conv2d_nhwc(x, w, 1, 1, b, b, b, b, act="linear")
    with pytest.raises(ValueError, match="tail"):
        kconv.conv2d_nhwc(x, w, 1, 1, residual=torch.rand(1, 4, 6, 6))
    y = kconv.conv2d_nhwc(x, w, 1, 1)
    ptrs = kconv._tail_ptrs(y, 4, b, None, None, None, 1,
                            torch.rand(y.shape).contiguous(
                                memory_format=torch.channels_last))
    assert ptrs[0] == b.data_ptr() and ptrs[1:4] == (None,) * 3
    assert ptrs[4] is not None


def test_takes_kernel_wants_the_card_float32_and_no_gradient():
    """``darknet.on_card``, the runner's one predicate: a block's input on
    the card and no gradient wanted from it, its parameters or its state.
    Float32 is the block's own test (the s2d, int8 and 16-bit tests
    below)."""
    mode = FakeTensorMode()
    x, w = _nhwc(1, 8, 6, 6, 0), torch.randn(4, 8, 3, 3)
    xc, wc = _on_card(x, mode), _on_card(w, mode)
    assert tdark.on_card(xc, {"w": wc}, {})
    assert not tdark.on_card(x, {"w": w}, {})          # a CPU tensor
    wg = _on_card(w.clone().requires_grad_(True), mode)
    assert not tdark.on_card(xc, {"w": wg}, {})
    assert not tdark.on_card(xc, {"w": wc}, {"var": wg})
    assert not tdark.on_card(xc.requires_grad_(True), {"w": wc}, {})
    with torch.no_grad():
        assert tdark.on_card(xc, {"w": wg}, {"var": wg})


@pytest.mark.parametrize("defs", [tiny_yolov3_defs, yolov3_defs,
                                  yolov4_defs])
def test_the_built_answer_is_what_the_op_takes(defs):
    """For every convolution block of tiny-YOLOv3, YOLOv3 and YOLOv4 the
    answer fixed when the model is built (``_k15``) is whether
    ``conv2d_nhwc`` takes the block's shapes (meta tensors: no data);
    and every one of them does, as the benchmark's shares need."""
    model = Darknet(defs(img_size=64), img_size=64)
    took = []
    for i, info in enumerate(model._plan):
        if info["type"] != "convolutional":
            assert not model._k15[i]
            continue
        k = info["size"]
        x = torch.empty((1, info["in_ch"], 8, 8), device="meta")
        w = torch.empty((info["filters"], info["in_ch"], k, k), device="meta")
        try:
            kconv.conv2d_nhwc(x, w, info["stride"], (k - 1) // 2)
        except ValueError:
            took.append(False)
        else:
            took.append(True)
        assert model._k15[i] == took[-1], i
    assert all(took)


def test_the_profiler_records_the_shapes_and_ints_the_roofline_counts():
    """Inside a profiler session with shapes recorded, the op's event
    holds the input's [N, Cin, H, W], the packed weights' [kh, kw, Cin,
    Cout padded to 4] and Cout, the stride and the padding as ints: 2 * N
    * Ho * Wo * Cout * Cin * kh * kw follows from them exactly."""
    from torch.profiler import ProfilerActivity, profile
    x = _nhwc(2, 8, 11, 11, 3)
    w = torch.randn(21, 8, 3, 3)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        y = kconv.conv2d_nhwc(x, w, 2, 1)
    ev = [e for e in p.events() if e.name == "millieye::conv2d_nhwc"]
    assert len(ev) == 1
    assert ev[0].input_shapes[:2] == [[2, 8, 11, 11], [3, 3, 8, 24]]
    assert list(ev[0].concrete_inputs[2:5]) == [21, 2, 1]
    n, cin, h, _ = ev[0].input_shapes[0]
    kh, kw = ev[0].input_shapes[1][:2]
    cout, stride, pad = ev[0].concrete_inputs[2:5]
    ho = (h + 2 * pad - kh) // stride + 1
    assert y.shape == (n, cout, ho, ho) and ho == 6
    # a launch with its tail and a residual in the store records the same
    # at 0-4, and the benchmark's reader counts it as the plain launch
    from perfbench.run import load_module
    flops = load_module("metrics", "conv.roofline").launch_flops
    vecs = [torch.rand(21) + 0.5 for _ in range(4)]
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        kconv.conv2d_nhwc(x, w, 2, 1, *vecs, act="leaky",
                          residual=torch.randn(y.shape))
    fused = [e for e in p.events() if e.name == "millieye::conv2d_nhwc"]
    assert len(fused) == 1
    assert fused[0].input_shapes[:2] == ev[0].input_shapes[:2]
    assert list(fused[0].concrete_inputs[2:5]) == [21, 2, 1]
    assert fused[0].input_shapes[5:9] == [[21]] * 4
    assert fused[0].input_shapes[10] == list(y.shape)
    want = 2 * n * ho * ho * cout * cin * kh * kw
    assert flops(ev[0].input_shapes, list(ev[0].concrete_inputs)) == want
    assert flops(fused[0].input_shapes,
                 list(fused[0].concrete_inputs)) == want


def _model(form, **kw):
    """tiny-YOLO at E px: "bn" unfolded, "folded" BN folded in float32,
    "folded_bf16" folded and cast to bfloat16."""
    g = torch.Generator().manual_seed(5)
    model = Darknet(tiny_yolov3_defs(num_classes=12, img_size=E), img_size=E,
                    **kw)
    params, state = model.init(g)
    if form != "bn":
        params, state = model.fold_batchnorm(
            params, state, torch.bfloat16 if form == "folded_bf16" else None)
    return model, params, state


def _images(n=2):
    return torch.rand((n, E, E, 3), generator=torch.Generator().manual_seed(6))


@pytest.fixture
def routed(monkeypatch):
    """The runner's predicate ``on_card`` answered for fake CUDA copies of
    the tensors (as the card would answer), and the op replaced by its
    plain version on the CPU, counting a launch: yields (answers, calls,
    tails), the predicate's answers, the inputs that reached the op as
    (shape, channels_last, stride) and each call's tail in the store as
    (activation code, whether a residual came), or None."""
    mode = FakeTensorMode()
    real = tdark.on_card
    answers, calls, tails = [], [], []

    def spy(x, p, s):
        answers.append(real(_on_card(x, mode), *(
            {k: _on_card(v, mode) for k, v in d.items()} for d in (p, s))))
        return answers[-1]

    def op(x, wp, cout, stride, pad, *tail):
        calls.append((tuple(x.shape), x.is_contiguous(
            memory_format=torch.channels_last), stride))
        tails.append((tail[4], tail[5] is not None)
                     if tail and tail[0] is not None else None)
        kconv.conv2d_nhwc.launches += 1
        return kconv._plain(x, wp, cout, stride, pad, *tail)

    monkeypatch.setattr(tdark, "on_card", spy)
    monkeypatch.setattr(kconv, "_op", op)
    monkeypatch.setattr(kconv.conv2d_nhwc, "launches",
                        kconv.conv2d_nhwc.launches)
    return answers, calls, tails


@pytest.mark.parametrize("form", ["bn", "folded"])
def test_a_float32_inference_convolution_reaches_the_op(routed, form):
    """Every one of tiny-YOLO's 13 plain float32 convolutions asks and
    reaches the op, on a channels_last input, and the answer is the one
    off the card's kernels (within float32 rounding: the CPU's
    convolution sums a channels_last input in another order than a
    contiguous one); each takes its tail (leaky, the heads' linear) in
    the op's store; the profiler's counters ``darknet.conv_kernel`` and
    ``darknet.tail_in_conv`` count them."""
    from torch.profiler import ProfilerActivity, profile

    from millieye_torch.runtime import profiler
    answers, calls, tails = routed
    model, params, state = _model(form)
    images = _images()
    profiler.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = model.apply(params, state, images)
    assert answers == [True] * 13 and len(calls) == 13
    assert all(cl for _, cl, _ in calls)
    assert tails == [(1, False)] * 9 + [(0, False)] + [(1, False)] * 2 + [
        (0, False)]
    counts = profiler.counters()
    assert counts["darknet.conv_kernel"] == counts["darknet.tail_in_conv"] \
        == counts["darknet.epilogue"] == 13
    answers.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdark, "on_card", lambda *a: False)
        want = model.apply(params, state, images)
    for k in ("feature_map", "detections"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("defs,tails,adds", [
    (tiny_yolov3_defs, 13, 0), (yolov3_defs, 75, 23), (yolov4_defs, 38, 0)],
    ids=["tiny", "darknet53", "yolov4"])
def test_the_tail_kinds_are_fixed_when_the_model_is_built(defs, tails,
                                                          adds):
    """Every plain convolution with a leaky or linear tail that K15 takes
    is "conv_tail" or, where a linear shortcut follows and nothing else
    reads its output, "conv_add" with the shortcut "pass": Darknet-53's
    75 tails and all 23 shortcut adds, YOLOv4's 35 leaky and 3 linear
    tails (its 72 Mish convolutions stay plain, so do the shortcuts after
    them), tiny-YOLO's 13. A store type for the float32 stages keeps
    them all plain."""
    model = Darknet(defs(img_size=64), img_size=64)
    kinds = model._kinds
    assert kinds.count("conv_tail") + kinds.count("conv_add") == tails
    assert len(model._fused) == tails
    assert kinds.count("conv_add") == adds
    assert kinds.count("shortcut") == sum(
        info["type"] == "shortcut" for info in model._plan) - adds
    referenced = model._referenced()
    for i, kind in enumerate(kinds):
        info = model._plan[i]
        if kind == "conv_add":
            assert kinds[i + 1] == "pass" and i not in referenced
            assert model._plan[i + 1]["type"] == "shortcut"
        if info["type"] == "convolutional" and info["act"] == "mish":
            assert kind == "convolutional"
    assert kinds.count("convolutional") == sum(
        info.get("act") == "mish" for info in model._plan)
    kept = Darknet(defs(img_size=64), img_size=64, hi_prec_stages=(0,),
                   hi_prec_store=torch.float16)
    assert kept._fused == () and "conv_tail" not in kept._kinds


def test_the_tail_leaves_the_store_where_the_call_needs_it(routed):
    """Training, a gradient wanted, 16-bit compute, int8 slots,
    ``collect_outputs`` (every block's own output) and a CPU call run
    today's path: no tail reaches the convolution's store (K14 or the
    eager tail, then the eager add); a float32 inference call on the
    card's kernels sends all 13 of tiny-YOLO's tails there."""
    answers, calls, tails = routed
    model, params, state = _model("bn")
    model.apply(params, state, _images())
    assert len(tails) == 13 and None not in tails
    tails.clear()
    calls.clear()
    model.apply(params, state, _images(), train=True)
    grads = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
             for p in params]
    model.apply(grads, state, _images())
    assert calls == [] and tails == []
    model.apply(params, state, _images(), collect_outputs=True)
    assert len(calls) == 13 and tails == [None] * 13
    tails.clear()
    calls.clear()
    qp = tq.quantize_darknet(model.fold_batchnorm(params, state)[0])
    model.apply(qp, state, _images())
    assert calls == [] and tails == []
    bf, bs = _model("folded_bf16")[1:]
    model.apply(bf, bs, _images(), compute_dtype=torch.bfloat16)
    assert calls == [] and tails == []
    # bfloat16 weights at float32 compute: K15 on their float32 copies,
    # the tails after it
    model.apply(bf, bs, _images())
    assert len(calls) == 13 and tails == [None] * 13


def test_a_cpu_call_sends_no_tail_to_the_op(monkeypatch):
    """On CPU tensors the runner's predicate says no: every block runs
    ``F.conv2d`` and the eager tail, and nothing reaches the op."""
    calls = []
    real = kconv._op

    def op(*args):
        calls.append(len(args))
        return real(*args)
    monkeypatch.setattr(kconv, "_op", op)
    model, params, state = _model("bn")
    model.apply(params, state, _images())
    assert calls == []


def test_the_fused_shortcuts_give_the_bits_of_the_eager_adds(monkeypatch):
    """YOLOv3 on Darknet-53 at 64 px with the card's path forced (the
    ops' plain versions on the CPU): the tails and adds in the
    convolution's store give the bits of the same convolutions, then the
    eager tails, then the eager shortcut adds (``collect_outputs``)."""
    monkeypatch.setattr(tdark, "on_card", lambda *a: True)
    model = Darknet(yolov3_defs(img_size=64), img_size=64)
    g = torch.Generator().manual_seed(21)
    params, state = model.init(g)
    for p, s in zip(params, state):
        if "gamma" in p:
            c = p["gamma"].shape[0]
            p["beta"] = 0.1 * torch.randn(c, generator=g)
            s["mean"] = 0.1 * torch.randn(c, generator=g)
            s["var"] = 0.5 + torch.rand(c, generator=g)
    images = torch.rand((1, 64, 64, 3), generator=g)
    with torch.no_grad():
        got = model.apply(params, state, images)
        want = model.apply(params, state, images, collect_outputs=True)
    for k in ("feature_map", "detections"):
        assert torch.equal(got[k], want[k])


def test_training_and_16_bit_compute_never_reach_the_op(routed):
    answers, calls, _ = routed
    model, params, state = _model("bn")
    model.apply(params, state, _images(), train=True)
    assert answers == [] and calls == []
    grads = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
             for p in params]
    model.apply(grads, state, _images())
    assert answers == [False] * 13 and calls == []
    answers.clear()
    model, params, state = _model("folded_bf16")
    model.apply(params, state, _images(), compute_dtype=torch.bfloat16)
    # on the card's kernels (K14 takes the tails), but not float32
    assert answers == [True] * 13 and calls == []


@pytest.mark.parametrize("acts", [False, True])
def test_int8_slots_never_reach_the_op(routed, acts):
    """int8 weights (dequantized in the graph) and int8 activations
    (``int8_conv2d``) keep their paths, on the card's kernels too (K14
    takes their tails)."""
    answers, calls, _ = routed
    model, params, state = _model("folded")
    absmax = None
    if acts:
        absmax = model.apply(params, state, _images(),
                             collect_act_stats=True)["act_absmax"]
        answers.clear()
        calls.clear()
    qp = tq.quantize_darknet(params, act_absmax=absmax)
    model.apply(qp, state, _images())
    assert calls == [] and answers == [True] * 13


def test_the_s2d_stages_never_reach_the_op(routed):
    """With stages 0 and 2 as space-to-depth convolutions, those two stay
    ``F.conv2d``; the 11 plain convolutions reach the op."""
    answers, calls, _ = routed
    model, params, state = _model("folded", s2d_stages=(0, 2))
    model.apply(model.fold_s2d(params), state, _images())
    assert answers == [True] * 11 and len(calls) == 11
    assert all(shape[1] != 12 for shape, _, _ in calls)   # 4 * 3 channels


def test_tensors_made_in_inference_mode_are_packed_at_each_call(routed):
    """A weight or a running variance made under ``torch.inference_mode``
    has no version counter: its packing and ``rsqrt(var + eps)`` are
    made at each call and not kept, and the op runs on it; so does the
    runner, taking all 13 convolutions of a model made in inference
    mode, and the float32 block 4 of a bfloat16 model, which casts its
    weights at each call."""
    from millieye_torch.models.darknet import _BN_EPS, _bn_inv
    answers, calls, _ = routed
    with torch.inference_mode():
        x = _nhwc(2, 8, 9, 9, 3)
        w = torch.randn((20, 8, 3, 3)) / 72 ** 0.5
        var = torch.rand(20) + 0.5
        wp = kconv.pack_weight(w)
        assert kconv.pack_weight(w) is not wp
        assert torch.equal(kconv.pack_weight(w), wp)
        inv = _bn_inv(var)
        assert _bn_inv(var) is not inv
        assert torch.equal(inv, torch.rsqrt(var + _BN_EPS))
        got = kconv.conv2d_nhwc(x, w, 2, 1)
        want = F.conv2d(x, w, stride=2, padding=1)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        calls.clear()
        model = Darknet(tiny_yolov3_defs(num_classes=12, img_size=E),
                        img_size=E)
        params, state = model.init(torch.Generator().manual_seed(5))
        out = model.apply(params, state, _images())
    assert params[0]["w"].is_inference()
    assert answers == [True] * 13 and len(calls) == 13
    assert torch.isfinite(out["detections"]).all()
    answers.clear()
    calls.clear()
    model, params, state = _model("folded_bf16", hi_prec_stages=(4,))
    with torch.inference_mode():
        model.apply(params, state, _images(), compute_dtype=torch.bfloat16)
    # block 4, the third convolution: 32 channels at 16 px
    assert answers == [True] * 13
    assert calls == [((2, 32, 16, 16), True, 1)]
