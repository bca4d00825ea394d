"""The comparison that decides ``correct``: the program's answers, as the
timed path produced them, against the plain reference
(``perfbench/reference``).

A detector's answer is a set of rows (x1, y1, x2, y2, score, class
score) for a frame. Two rows lie ``distance`` apart: 100 times the
largest of their coordinates' differences over the second row's size
(its width or height, at least ``MIN_SIZE`` pixels) and of their
scores' differences, so one unit is 1% of a box or 0.01 of a score. A
relative measure, because a detector's boxes span from a few pixels to
far beyond the frame (a random-weight network's widths reach 10^6 px),
and float32 rounding alone moves such a box by pixels. The reference
gives, for a frame, every row its answer could hold (``Scene.rows``: one
for every decoded anchor and radar proposal, whatever NMS keeps) and the
rows it keeps itself (``Scene.kept``). The numbers:

* ``row_gap``: the widest distance from a row the program answered to
  the nearest row the reference could give: a box or score that no
  candidate explains (an altered answer, a lower precision) reads high,
  while a row that NMS keeps on one side and not on the other does not;
* ``row_mean``: the mean of those distances over the rows answered;
* ``rows_missing``: the share of the reference's kept rows with no row
  of the program within ``MATCH``: answers left out, or not reproduced;
* ``rows_extra``: the share of the program's rows with no kept row of
  the reference within ``MATCH``: rows that NMS should have suppressed
  (no suppression, a wrong threshold), or rows that are not answers.

Those a cell compares have their limits in its workload file
(``perfbench/workloads/<cell>.json``).
"""
from __future__ import annotations

import torch

MATCH = 2.0        # units (2% of a box, 0.02 of a score): a kept row
                   # with a program row this near is answered
MIN_SIZE = 16.0    # pixels: the least size a box's coordinates scale by


def distance(a, b):
    """a [n, 6] x b [m, 6] -> [n, m], in units of ``b``'s sizes."""
    size = torch.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]).clamp_min(
        MIN_SIZE)
    box = (a[:, None, :4] - b[None, :, :4]).abs().amax(-1) / size[None, :]
    score = (a[:, None, 4:6] - b[None, :, 4:6]).abs().amax(-1)
    return torch.maximum(box, score) * 100.0


def row_numbers(answers, scenes):
    """``answers``: [(rows [n, 6] float32 tensor of the valid rows, scene
    key)], one for every frame compared; ``scenes``: {key: Scene}.
    Returns {"row_gap", "row_mean", "rows_missing", "rows_extra"}."""
    gap, total, missing, extra, kept, answered = 0.0, 0.0, 0, 0, 0, 0
    for rows, key in answers:
        sc = scenes[key]
        rows = rows.to(sc.rows.device, torch.float32)
        answered += len(rows)
        kept += len(sc.kept)
        if len(rows):
            near = distance(rows, sc.rows).amin(1)
            gap = max(gap, float(near.amax()))
            total += float(near.sum())
        if len(sc.kept) and len(rows):
            d = distance(rows, sc.kept)
            missing += int((d.amin(0) > MATCH).sum())
            extra += int((d.amin(1) > MATCH).sum())
        else:
            missing += len(sc.kept)
            extra += len(rows)
    return {"row_gap": gap, "row_mean": total / max(answered, 1),
            "rows_missing": missing / max(kept, 1),
            "rows_extra": extra / max(answered, 1)}


def map_gap(pairs):
    """[(program map, reference map)] -> the largest absolute
    difference."""
    gap = 0.0
    for got, want in pairs:
        gap = max(gap, float((got.float().to(want.device) - want)
                             .abs().amax()))
    return gap


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) over the numbers ``limits``
    names: each at or under its limit; a missing or non-finite one
    fails, and so do no limits at all."""
    lines, ok = [], bool(limits)
    for name in sorted(limits):
        value, limit = numbers.get(name, float("nan")), limits[name]
        good = value == value and value <= limit
        ok &= good
        lines.append((name, value, limit))
    return ok, lines
