"""The whole step's share of the card's peak, in percent: the
configuration's model FLOPs a frame (``perfbench/flops.py``) times the
frames a second of the same run's untraced window, over the peak of the
configuration's precision (``perfbench/roofline.py:PEAKS``)."""


def read(run):
    if run.window_s <= 0:
        return None
    return (100.0 * run.flops_per_frame * run.frames / run.window_s
            / run.peak_flop_s)
