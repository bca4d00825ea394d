"""YOLOv4 alone on batches from the card: ``yolo_batch``'s driver (the
batch gathered by the port's ``DeviceCache`` loader, ``Darknet.apply`` in
the configuration's precision, ``ops/nms.py:batched_nms`` at its
thresholds, the rows and their mask copied to the host), with the
YOLOv4 reference (``reference/yolov4.py``) in the place of
``reference/darknet.py``: its weights made from the seed, its batch norm
calibrated through Mish, and its scenes for the check."""
from __future__ import annotations

import torch

from perfbench.drivers import yolo_batch
from perfbench.reference import yolov4
from perfbench.reference.precision import REFERENCE

plant = yolo_batch.plant


class Driver(yolo_batch.Driver):

    def _weights(self):
        """(layers, params, state) of the reference: seeded, then batch
        norm calibrated on the first scenes."""
        layers = yolov4.plan(self.config["blocks"])
        params, state = yolov4.seeded_weights(layers, self.seed,
                                              self.device)
        n = min(yolo_batch.CALIBRATION_SCENES, len(self.pool.items))
        images = torch.stack([self._image(i) for i in range(n)]).permute(
            0, 3, 1, 2)
        yolov4.calibrate_bn(layers, params, state, images)
        return layers, params, state

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
                    views[name, i] = yolov4.yolo_scene(
                        params, state, layers, self._image(i), want, prec=p)
        ref = {k: v for (n, k), v in views.items() if n == "ref"}
        ctl = ({k: v for (n, k), v in views.items() if n == "ctl"}
               if prec is not None else None)
        return self.row_numbers(ref, ctl)
