"""A Darknet detector alone on batches from the card, as the eval CLI's
``--what yolo --device_cache`` step runs it (``eval/harness.py:
evaluate_yolo``): the batch gathered by the port's ``DeviceCache``
loader, ``Darknet.apply`` in the configuration's precision, then
``ops/nms.py:batched_nms`` at the configuration's thresholds, and the
rows and their mask copied to the host.

The weights are the benchmark's: ``reference/darknet.py:seeded_weights``
made on the card from the seed, with the running statistics of batch
norm set on the pool's first scenes (``calibrate_bn``), handed to the
program as its parameter lists. The check makes them again from the
seed, and compares every frame's rows with the reference's."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import faults
from perfbench.batch import BatchDriver
from perfbench.reference import darknet, fusion
from perfbench.reference.precision import REFERENCE

CALIBRATION_SCENES = 8


class Driver(BatchDriver):

    def _weights(self):
        """(layers, params, state) of the reference: seeded, then batch
        norm calibrated on the first scenes, as the reference takes
        them."""
        layers = darknet.plan(self.config["blocks"])
        params, state = darknet.seeded_weights(layers, self.seed,
                                               self.device)
        n = min(CALIBRATION_SCENES, len(self.pool.items))
        images = torch.stack([self._image(i) for i in range(n)]).permute(
            0, 3, 1, 2)
        darknet.calibrate_bn(layers, params, state, images)
        return layers, params, state

    def build(self):
        from millieye_torch.device import set_numerics
        from millieye_torch.models.darknet import Darknet
        set_numerics()
        c = self.config
        self.model = Darknet([dict(b) for b in c["blocks"]],
                             img_size=c["img_size"])
        layers, params, state = self._weights()
        self.params = [params.get(str(i), {}) for i in range(len(layers))]
        self.state = [state.get(str(i), {}) for i in range(len(layers))]

    def forward(self, batch):
        from millieye_torch.ops.nms import batched_nms
        c = self.config
        out = self.model.apply(self.params, self.state, batch["images"])
        det, valid = batched_nms(out["detections"], c["conf_thresh"],
                                 c["nms_thresh"], max_det=c["max_det"],
                                 pre_top_k=c["pre_nms_top_k"])
        return det, valid

    # -------------------------------------------------------- check
    def _image(self, i):
        """Scene ``i`` as the reference takes it: the collate's resize of
        the letterboxed frame, rounded to float16 as the cache stores
        images."""
        img = fusion.resize_nearest(self.pool.items[i]["image"],
                                    self.config["img_size"])
        return torch.from_numpy(np.ascontiguousarray(img)).to(
            self.device).half().float()

    def check(self, prec=None):
        c = self.config
        layers, params, state = self._weights()
        want = {k: c[k] for k in ("conf_thresh", "nms_thresh", "max_det",
                                  "pre_nms_top_k")}
        needed = sorted({i for s in self.step_scenes().values() for i in s})
        sides = {"ref": REFERENCE} if prec is None else {"ref": REFERENCE,
                                                         "ctl": prec}
        views = {}
        with torch.no_grad():
            for name, p in sides.items():
                for i in needed:
                    views[name, i] = fusion.yolo_scene(
                        params, state, layers, self._image(i), want, prec=p)
        ref = {k: v for (n, k), v in views.items() if n == "ref"}
        ctl = ({k: v for (n, k), v in views.items() if n == "ctl"}
               if prec is not None else None)
        return self.row_numbers(ref, ctl)


@contextlib.contextmanager
def plant(fault):
    """``perfbench.faults``' ``fault`` in the step's ``batched_nms``."""
    from millieye_torch.ops import nms
    batched = nms.batched_nms
    nms.batched_nms = faults.nms_with(batched, fault)
    try:
        yield
    finally:
        nms.batched_nms = batched
