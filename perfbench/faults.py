"""Faults a cell's timed path can have, planted where the program produces
its answer, for the checks that ``correct`` comes out false when the path
is broken underneath: the CPU tests (``tests/test_perfbench_faults.py``)
and the readings on the card (``perfbench/calibrate.py --faults``). Never
planted by the benchmark's own runs.

A fault is either an ``answer`` fault, a function (boxes, valid) ->
(boxes, valid) applied to the detector's rows where they are produced,
or an ``nms`` fault, an IoU threshold the detector's NMS is called with
in place of the configuration's. Each driver module's ``plant(name)``
puts one into its program for the length of a ``with`` block."""
from __future__ import annotations


def half_left_out(boxes, valid):
    """The second half of the batch answers nothing."""
    valid = valid.clone()
    valid[valid.shape[0] // 2:] = False
    return boxes, valid


def altered(boxes, valid):
    """Each frame's first row moved 50 px to the right."""
    boxes = boxes.clone()
    boxes[:, 0, 0] += 50.0
    boxes[:, 0, 2] += 50.0
    return boxes, valid


FAULTS = {
    "half_left_out": ("answer", half_left_out),
    "altered": ("answer", altered),
    # no row overlaps another by more than IoU 1: NMS suppresses nothing
    "no_suppression": ("nms", 1.0),
}


def nms_with(batched_nms, fault):
    """``batched_nms`` with ``fault`` planted: the NMS fault's IoU
    threshold in place of the caller's, or the answer fault applied to
    its rows."""
    kind, what = FAULTS[fault]
    if kind == "nms":
        def broken(pred, conf_thresh, iou_thresh=0.5, *a, **kw):
            return batched_nms(pred, conf_thresh, what, *a, **kw)
    else:
        def broken(*a, **kw):
            return what(*batched_nms(*a, **kw))
    return broken
