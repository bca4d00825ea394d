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
    plain version on the CPU, counting a launch: yields (answers, calls),
    the predicate's answers and the inputs that reached the op as (shape,
    channels_last, stride)."""
    mode = FakeTensorMode()
    real = tdark.on_card
    answers, calls = [], []

    def spy(x, p, s):
        answers.append(real(_on_card(x, mode), *(
            {k: _on_card(v, mode) for k, v in d.items()} for d in (p, s))))
        return answers[-1]

    def op(x, wp, cout, stride, pad):
        calls.append((tuple(x.shape), x.is_contiguous(
            memory_format=torch.channels_last), stride))
        kconv.conv2d_nhwc.launches += 1
        return kconv._plain(x, wp, cout, stride, pad)

    monkeypatch.setattr(tdark, "on_card", spy)
    monkeypatch.setattr(kconv, "_op", op)
    monkeypatch.setattr(kconv.conv2d_nhwc, "launches",
                        kconv.conv2d_nhwc.launches)
    return answers, calls


@pytest.mark.parametrize("form", ["bn", "folded"])
def test_a_float32_inference_convolution_reaches_the_op(routed, form):
    """Every one of tiny-YOLO's 13 plain float32 convolutions asks and
    reaches the op, on a channels_last input, and the answer is the one
    off the card's kernels (within float32 rounding: the CPU's
    convolution sums a channels_last input in another order than a
    contiguous one); the profiler's counter ``darknet.conv_kernel``
    counts them."""
    from torch.profiler import ProfilerActivity, profile

    from millieye_torch.runtime import profiler
    answers, calls = routed
    model, params, state = _model(form)
    images = _images()
    profiler.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = model.apply(params, state, images)
    assert answers == [True] * 13 and len(calls) == 13
    assert all(cl for _, cl, _ in calls)
    assert profiler.counters()["darknet.conv_kernel"] == 13
    answers.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdark, "on_card", lambda *a: False)
        want = model.apply(params, state, images)
    for k in ("feature_map", "detections"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_training_and_16_bit_compute_never_reach_the_op(routed):
    answers, calls = routed
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
    answers, calls = routed
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
    answers, calls = routed
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
    answers, calls = routed
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
