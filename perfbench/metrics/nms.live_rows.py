"""Candidate rows a frame that the NMS keep mask scans: the program's
counter ``nms.live`` (rows that passed the confidence filter into the top
``pre_nms_top_k`` of ``ops/nms.py:batched_nms``) over ``nms.frames``,
through the traced stretch."""
from perfbench.program import counters


def read(run):
    c = counters(run)
    if not c or not c.get("nms.frames"):
        return None
    return c["nms.live"] / c["nms.frames"]
