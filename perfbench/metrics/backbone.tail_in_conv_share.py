"""The share, in percent, of the backbone's plain convolution blocks whose
tail (batch norm's affine step or the bias, then leaky or linear) ran in
the program's convolution kernel's store, with no pass of its own: the
program's counter ``darknet.tail_in_conv`` over ``darknet.convs``,
through the traced stretch. None for a program that keeps neither
counter."""
from perfbench.program import counters


def read(run):
    c = counters(run)
    if not c or not c.get("darknet.convs") or "darknet.tail_in_conv" not in c:
        return None
    return 100.0 * c["darknet.tail_in_conv"] / c["darknet.convs"]
