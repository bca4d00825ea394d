"""The reader of the program's fused convolution tails:
``backbone.tail_in_conv_share`` reads the program's counters
``darknet.tail_in_conv`` over ``darknet.convs``, and reads nothing where
the program keeps no such counter."""
import pytest

from perfbench import run


def test_the_tail_in_conv_share_reads_the_counters(monkeypatch):
    share = run.load_module("metrics", "backbone.tail_in_conv_share")
    counts = {"darknet.convs": 110, "darknet.conv_kernel": 110,
              "darknet.epilogue": 110, "darknet.tail_in_conv": 38,
              "darknet.add_in_conv": 0}
    monkeypatch.setattr(share, "counters", lambda r: counts)
    assert share.read(run.Run(trace=object())) == pytest.approx(
        100 * 38 / 110)
    counts["darknet.tail_in_conv"] = 110
    assert share.read(run.Run(trace=object())) == 100.0
    # a program without the counter (the parent's) reads nothing
    counts.pop("darknet.tail_in_conv")
    assert share.read(run.Run(trace=object())) is None
    monkeypatch.setattr(share, "counters", lambda r: None)
    assert share.read(run.Run(trace=object())) is None
