"""Synthetic camera+radar scenes: the benchmark's traffic generator, a
frozen copy of ``millieye_torch/data/synthetic.py`` with its own numpy
letterbox, so that a change to the program cannot change the traffic.
The same (seed, index) gives the same arrays as the program's generator
(``perfbench/tests/test_traffic.py`` holds the two together).

Scene model (a pure function of (seed, idx), no files):

* background: low-frequency textured gray field + structured clutter;
* 1-3 "person" objects (class 0): torso ellipse + head disc + leg split,
  size 0.15-0.45 of frame height;
* radar: a point cluster inside each person box plus uniform clutter
  points; proposal boxes = jittered copies of ~85% of the true boxes plus
  cold false proposals;
* illumination: "L" frames are the scene scaled by gamma~U(.012,.035)
  plus sensor noise (sigma 0.02), mean intensity under the 0.1 auto-mode
  threshold; "H" frames are the scene as drawn.
"""
from __future__ import annotations

import numpy as np


def pad_to_square(img, pad_value=0.0):
    """[H, W, C] -> ([S, S, C], (left, right, top, bottom))."""
    h, w = img.shape[:2]
    diff = abs(h - w)
    p1, p2 = diff // 2, diff - diff // 2
    if h <= w:
        out = np.pad(img, ((p1, p2), (0, 0), (0, 0)),
                     constant_values=pad_value)
        pad = (0, 0, p1, p2)
    else:
        out = np.pad(img, ((0, 0), (p1, p2), (0, 0)),
                     constant_values=pad_value)
        pad = (p1, p2, 0, 0)
    return out, pad


def _letterbox_item(img, boxes_xyxy_abs, classes):
    """Pad image to square; absolute xyxy boxes -> normalized (class, cx,
    cy, w, h) over the padded square."""
    img, pad = pad_to_square(img, 0.0)
    s = img.shape[0]
    if len(boxes_xyxy_abs) == 0:
        return img, np.zeros((0, 5), np.float32), pad
    b = np.array(boxes_xyxy_abs, np.float64)
    b[:, 0] += pad[0]
    b[:, 2] += pad[1]
    b[:, 1] += pad[2]
    b[:, 3] += pad[3]
    out = np.zeros((len(b), 5), np.float32)
    out[:, 0] = classes
    out[:, 1] = (b[:, 0] + b[:, 2]) / 2 / s
    out[:, 2] = (b[:, 1] + b[:, 3]) / 2 / s
    out[:, 3] = (b[:, 2] - b[:, 0]) / s
    out[:, 4] = (b[:, 3] - b[:, 1]) / s
    return img, out, pad


def _texture(rng, h, w, base=0.38, amp=0.18):
    """Low-frequency multiplicative texture via bilinear-upsampled noise.
    The smooth field is blended at quarter resolution and block-upsampled
    — 16x less arithmetic, visually identical background decoration (the
    generator has to outrun the train loop)."""
    gh, gw = 6, 8
    coarse = rng.uniform(-1.0, 1.0, size=(gh, gw))
    hq, wq = (h + 3) // 4, (w + 3) // 4
    ys = np.linspace(0, gh - 1, hq)
    xs = np.linspace(0, gw - 1, wq)
    y0 = np.clip(ys.astype(int), 0, gh - 2)
    x0 = np.clip(xs.astype(int), 0, gw - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    c = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
         + coarse[y0 + 1][:, x0] * fy * (1 - fx)
         + coarse[y0][:, x0 + 1] * (1 - fy) * fx
         + coarse[y0 + 1][:, x0 + 1] * fy * fx)
    field = (base + amp * c).astype(np.float32)
    field = np.repeat(np.repeat(field, 4, 0), 4, 1)[:h, :w]
    img = np.empty((h, w, 3), np.float32)
    img[:] = field[:, :, None]            # broadcast store beats np.repeat
    return img


def _draw_person(img, rng, cx, cy, bw, bh):
    """Torso ellipse + head disc + leg split into img (in place).
    Masks are computed only inside the shape's bounding region — the
    generator must keep up with the train loop (a full-frame mgrid per
    shape made item generation the stage-1 bottleneck)."""
    h, w = img.shape[:2]
    color = rng.uniform(0.45, 0.95, size=3).astype(np.float32)
    head_c = np.clip(color * rng.uniform(0.6, 0.9), 0, 1)
    y0 = max(0, int(cy - 0.6 * bh))
    y1 = min(h, int(cy + 0.6 * bh) + 1)
    x0 = max(0, int(cx - 0.6 * bw))
    x1 = min(w, int(cx + 0.6 * bw) + 1)
    yy = np.arange(y0, y1, dtype=np.float32)[:, None]
    xx = np.arange(x0, x1, dtype=np.float32)[None, :]
    # torso: ellipse over the middle 55% of the box height
    ty, th = cy - 0.05 * bh, 0.3 * bh
    torso = (((xx - cx) / (0.32 * bw)) ** 2
             + ((yy - ty) / th) ** 2) <= 1.0
    # head: disc at the top
    hy, hr = cy - 0.38 * bh, 0.14 * bh
    head = ((xx - cx) ** 2 + (yy - hy) ** 2) <= hr ** 2
    # legs: two vertical bars at the bottom
    ly0, ly1 = cy + 0.18 * bh, cy + 0.5 * bh
    lw = 0.1 * bw
    legs = ((yy >= ly0) & (yy <= ly1)
            & ((np.abs(xx - (cx - 0.16 * bw)) <= lw)
               | (np.abs(xx - (cx + 0.16 * bw)) <= lw)))
    region = img[y0:y1, x0:x1]
    region[torso | legs] = color
    region[head] = head_c


def _draw_clutter(img, rng, n):
    h, w = img.shape[:2]
    for _ in range(n):
        x0 = rng.integers(0, w - 20)
        y0 = rng.integers(0, h - 20)
        cw = int(rng.integers(15, 90))
        ch = int(rng.integers(8, 50))
        shade = rng.uniform(0.15, 0.75, size=3).astype(np.float32)
        x1, y1 = min(x0 + cw, w), min(y0 + ch, h)
        if rng.uniform() < 0.5:          # filled block
            img[y0:y1, x0:x1] = shade
        else:                            # hollow frame
            t = 3
            img[y0:y1, x0:x0 + t] = shade
            img[y0:y1, max(x1 - t, 0):x1] = shade
            img[y0:y0 + t, x0:x1] = shade
            img[max(y1 - t, 0):y1, x0:x1] = shade


class SyntheticScenes:
    """Deterministic synthetic dataset; same item contract as
    RadarFusionDataset (stage-3) and, via image/targets only, as the
    stage-1/2 image datasets."""

    def __init__(self, n, seed=0, illumination=("H", "L"), frame_hw=(480, 640),
                 p_dark=0.5, p_radar_det=0.85, clutter=True, radar=True):
        self.n = n
        self.seed = seed
        self.illumination = tuple(illumination)
        self.frame_hw = frame_hw
        self.p_dark = p_dark
        self.p_radar_det = p_radar_det
        self.clutter = clutter
        self.radar = radar
        # index parity keeps the H/L split exactly balanced & filterable
        self.items = [i for i in range(n)
                      if self._light(i) in self.illumination]

    def _light(self, idx):
        return "L" if (idx % 2 == 1 and self.p_dark > 0) else "H"

    def __len__(self):
        return len(self.items)

    def light_of(self, i):
        return self._light(self.items[i])

    def get(self, i):
        idx = self.items[i]
        rng = np.random.default_rng((self.seed, idx))
        h, w = self.frame_hw
        img = _texture(rng, h, w)
        if self.clutter:
            _draw_clutter(img, rng, int(rng.integers(2, 7)))

        n_obj = int(rng.integers(1, 4))
        boxes, depths, vels = [], [], []
        for _ in range(n_obj):
            bh = rng.uniform(0.15, 0.45) * h
            bw = bh * rng.uniform(0.35, 0.55)
            cx = rng.uniform(0.55 * bw, w - 0.55 * bw)
            cy = rng.uniform(0.55 * bh, h - 0.55 * bh)
            _draw_person(img, rng, cx, cy, bw, bh)
            boxes.append([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2])
            depths.append(rng.uniform(1.5, 8.0))
            vels.append(rng.normal(0.0, 1.2))
        boxes = np.asarray(boxes, np.float64)

        light = self._light(idx)
        if light == "L":
            # per-pixel SNR ~0.3-0.9: the camera degrades hard but the
            # frames remain dim IMAGES, not iid noise — real night frames
            # keep spatial structure, and the frozen module2 nets must
            # stay in-distribution on them (module3 train.py:117-149
            # freezes nets trained on camera-functional data). Tuning
            # history: gamma .02-.06/noise .012 left tiny-YOLO at 0.86
            # dark mAP (nothing to recover); gamma .006-.02/noise .03 was
            # sub-noise-floor and the frozen refinement's regressions
            # exploded on OOD noise (fusion dark mAP 0.0003).
            gamma = rng.uniform(0.012, 0.035)
            # single-channel sensor noise broadcast over RGB: 3x cheaper
            # to generate, same detectability floor
            noise = rng.standard_normal(
                img.shape[:2]).astype(np.float32) * 0.02
            img = np.clip(img * np.float32(gamma) + noise[:, :, None],
                          0, 1, out=img)
        img = np.ascontiguousarray(img, np.float32)

        classes = np.zeros(len(boxes))
        sq, targets, pad = _letterbox_item(img, boxes.copy(), classes)
        s = sq.shape[0]
        item = {"path": f"synthetic://{self.seed}/{idx}", "image": sq,
                "targets": targets}
        if not self.radar:
            return item

        pts, props = [], []
        for b, z, v in zip(boxes, depths, vels):
            # cluster of returns inside the person box
            cnt = int(np.clip((b[2] - b[0]) * (b[3] - b[1]) / 900, 5, 24))
            u = rng.normal((b[0] + b[2]) / 2, (b[2] - b[0]) / 5, cnt)
            vv = rng.normal((b[1] + b[3]) / 2, (b[3] - b[1]) / 5, cnt)
            zz = np.maximum(z + rng.normal(0, 0.15, cnt), 0.1)
            sp = v + rng.normal(0, 0.1, cnt)
            pts.append(np.stack([u, vv, zz, sp], -1))
            if rng.uniform() < self.p_radar_det:
                for _ in range(int(rng.integers(1, 3))):
                    scale = rng.uniform(0.9, 1.35)
                    dx = rng.normal(0, 0.04) * (b[2] - b[0])
                    dy = rng.normal(0, 0.04) * (b[3] - b[1])
                    cxp = (b[0] + b[2]) / 2 + dx
                    cyp = (b[1] + b[3]) / 2 + dy
                    hw2 = (b[2] - b[0]) / 2 * scale
                    hh2 = (b[3] - b[1]) / 2 * scale
                    props.append([cxp - hw2, cyp - hh2,
                                  cxp + hw2, cyp + hh2])
        # clutter returns + cold false proposals
        n_cl = int(rng.integers(0, 7))
        if n_cl:
            pts.append(np.stack([rng.uniform(0, w, n_cl),
                                 rng.uniform(0, h, n_cl),
                                 rng.uniform(0.5, 11.0, n_cl),
                                 rng.normal(0, 1.5, n_cl)], -1))
        for _ in range(int(rng.integers(0, 3))):
            fw = rng.uniform(0.08, 0.25) * w
            fh = rng.uniform(0.1, 0.35) * h
            fx = rng.uniform(0, w - fw)
            fy = rng.uniform(0, h - fh)
            props.append([fx, fy, fx + fw, fy + fh])

        points = (np.concatenate(pts, 0) if pts
                  else np.zeros((0, 4))).astype(np.float32)
        rbox = np.asarray(props, np.float64).reshape(-1, 4)
        if len(rbox):                    # same normalization as the real set
            rbox[:, 0] += pad[0]
            rbox[:, 2] += pad[1]
            rbox[:, 1] += pad[2]
            rbox[:, 3] += pad[3]
            rbox = np.clip(rbox / s, 0.0, 1.0)
            rbox = rbox[(rbox[:, 0] < rbox[:, 2]) & (rbox[:, 1] < rbox[:, 3])]
        item.update({"radar_boxes": rbox.astype(np.float32),
                     "radar_points": points,
                     "frame_size": (w, h)})
        return item
