"""Training observability: JSONL metrics, an optional TensorBoard sink
and PNG image grids (a copy of ``millieye_tpu/train/logging.py``).

The reference logs to TensorBoard (scalars and image grids of radar maps
and attention). The primary sink here is an append-only ``metrics.jsonl``;
where ``torch.utils.tensorboard`` imports (it needs the tensorboard
package) it is a second sink. Image summaries are saved as PNG grids
(PIL). Scalars may be tensors on any device: each is read with
``float``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsLogger:
    def __init__(self, logdir):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
        except Exception:
            pass
        self.t0 = time.time()

    def scalars(self, step, tag_values):
        rec = {"step": int(step), "t": round(time.time() - self.t0, 2)}
        rec.update({k: float(v) for k, v in tag_values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb:
            for k, v in tag_values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def image_grid(self, step, tag, images, max_n=16):
        """images [N, H, W, C] float 0..1 (numpy or a tensor) -> a PNG
        grid (the reference's radar-map and attention dumps)."""
        from PIL import Image
        if hasattr(images, "detach"):
            images = images.detach().float().cpu().numpy()
        images = np.asarray(images)[:max_n]
        if images.ndim != 4 or not len(images):
            return
        n = len(images)
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        h, w, c = images.shape[1:]
        grid = np.zeros((rows * h, cols * w, 3), np.float32)
        for i, img in enumerate(images):
            if c == 1:
                img = np.repeat(img, 3, -1)
            grid[(i // cols) * h:(i // cols + 1) * h,
                 (i % cols) * w:(i % cols + 1) * w] = img[..., :3]
        path = os.path.join(self.logdir,
                            f"{tag.replace('/', '_')}_{step:07d}.png")
        Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(
            path)
        if self._tb:
            self._tb.add_images(tag, images.transpose(0, 3, 1, 2), step)

    def close(self):
        self._f.close()
        if self._tb:
            self._tb.close()
