"""The readers of the program's convolution kernel: ``backbone.conv_share``
reads the program's counters ``darknet.conv_kernel`` over
``darknet.convs``, and ``conv.roofline`` counts each traced
``millieye::conv2d_nhwc`` launch's operations exactly from its recorded
shapes and its ints (Cout, stride and padding); both read nothing where
the program has no such counter or launch."""
import pytest

from perfbench import run

PEAK = 67e12


def _reader(name):
    return run.load_module("metrics", name)


def _trace(ops):
    return run.Run(trace=type("T", (), {"ops": ops}))


def test_the_conv_share_reads_the_counters(monkeypatch):
    share = _reader("backbone.conv_share")
    counts = {"darknet.convs": 75, "darknet.conv_kernel": 75,
              "darknet.epilogue": 75}
    monkeypatch.setattr(share, "counters", lambda r: counts)
    assert share.read(run.Run(trace=object())) == 100.0
    counts["darknet.conv_kernel"] = 60
    assert share.read(run.Run(trace=object())) == 80.0
    # a program without the counter (the parent's) reads nothing
    counts.pop("darknet.conv_kernel")
    assert share.read(run.Run(trace=object())) is None
    monkeypatch.setattr(share, "counters", lambda r: None)
    assert share.read(run.Run(trace=object())) is None


# (x [N, Cin, H, W], packed w [kh, kw, Cin, Cout padded to 4], Cout,
# stride, pad, Ho)
_LAUNCHES = [
    ([8, 256, 52, 52], [3, 3, 256, 512], 512, 2, 1, 26),   # stride 2
    ([8, 512, 26, 26], [1, 1, 512, 256], 255, 1, 0, 26),   # 1x1 head
    ([8, 3, 416, 416], [3, 3, 3, 32], 32, 1, 1, 416),      # first conv
    ([1, 1024, 19, 19], [3, 3, 1024, 512], 512, 2, 1, 10), # odd side
]


def _op(x, w, cout, stride, pad, us):
    return ("conv2d_nhwc", [x, w, [], [], []], None,
            [None, None, cout, stride, pad], us)


@pytest.mark.parametrize("x,w,cout,stride,pad,ho", _LAUNCHES)
def test_the_conv_roofline_counts_each_launch_exactly(x, w, cout, stride,
                                                      pad, ho):
    roof = _reader("conv.roofline")
    want = 2 * x[0] * ho * ho * cout * x[1] * w[0] * w[1]
    op = _op(x, w, cout, stride, pad, 0.0)
    assert roof.launch_flops(op[1], op[3]) == want
    # one launch whose device time is its bound reads 100
    op = _op(x, w, cout, stride, pad, want / PEAK * 1e6)
    assert roof.read(_trace([op])) == pytest.approx(100.0)


def test_the_conv_roofline_sums_over_launches_and_ignores_other_ops():
    roof = _reader("conv.roofline")
    ops = [_op(x, w, c, s, p, 1000.0) for x, w, c, s, p, _ in _LAUNCHES[:2]]
    ops += [("conv_epilogue", [[8, 64, 52, 52], [64], [], [], [], []], None,
             [None] * 5 + [1], 500.0), ("nms", [[8, 512, 4]], None, None,
                                        10.0)]
    flops = sum(roof.launch_flops(o[1], o[3]) for o in ops[:2])
    assert roof.read(_trace(ops)) == pytest.approx(
        100 * flops / PEAK / 2e-3)
    # a stride counted as 1 where it was 2 would read four times as much
    x, w, c = _LAUNCHES[0][:3]
    s1, s2 = _op(x, w, c, 1, 1, 1000.0), _op(x, w, c, 2, 1, 1000.0)
    assert roof.read(_trace([s1])) == pytest.approx(
        4 * roof.read(_trace([s2])), rel=0.02)


def test_the_conv_roofline_reads_nothing_without_launches_or_ints():
    roof = _reader("conv.roofline")
    assert roof.read(run.Run(trace=None)) is None
    assert roof.read(_trace([("nms", [[8, 512, 4]], None, None, 10.0)])) \
        is None
    bare = [("conv2d_nhwc", [[8, 64, 52, 52], [1, 1, 64, 32], [], [], []],
             None, None, 100.0)]
    assert roof.read(_trace(bare)) is None
