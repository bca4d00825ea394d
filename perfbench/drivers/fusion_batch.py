"""The milliEye fusion detector on batches from the card, as the eval
CLI's ``--device_cache`` step runs it (``eval/harness.py:
evaluate_fusion``): the batch gathered by the port's ``DeviceCache``
loader, the radar maps rasterized on the card by
``train/recipes.py:fusion_device_batch``, the mode chosen by
``eval/harness.py:auto_mode`` on the batch's host-side brightness (the
eval CLI's ``--model_mode 3``), ``FusionNetwork.apply`` at that mode,
and ``boxes`` and ``valid`` copied to the host. The network comes from
``cli/_common.py:build_fusion`` at the configuration's preset, its
weights from the configuration's checkpoint folded by
``runtime/engine.py:fold_for_serving``.

The check compares, on the kept steps, every frame's rows with the
reference's over the same scene at the mode the reference picks from the
same frames, and the radar maps the card rasterized with the
reference's."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import check, faults
from perfbench.batch import BatchDriver
from perfbench.reference import darknet, fusion
from perfbench.reference.precision import REFERENCE
from perfbench.reference.weights import read_npz

DARK = 0.1          # test_fusion.py:24-32: a batch darker than this fuses


class Driver(BatchDriver):

    def build(self):
        from millieye_torch.cli._common import build_fusion
        from millieye_torch.runtime.engine import fold_for_serving
        c = self.config
        model, params, state = build_fusion(
            c["weights"], c["preset"], img_size=c["img_size"],
            num_classes=c["num_classes"], device=self.device)
        self.model = model
        self.params, self.state = fold_for_serving(model, params, state)

    def ingest(self, batch):
        from millieye_torch.train.recipes import fusion_device_batch
        return fusion_device_batch(batch, self.config["img_size"],
                                   self.device)

    def forward(self, batch):
        from millieye_torch.eval.harness import auto_mode
        self.mode = mode = auto_mode(batch["images"], batch.get("brightness"))
        out = self.model.apply(self.params, self.state, batch["images"],
                               batch["radar_maps"], batch["radar_boxes"],
                               batch["rmask"], mode=mode)
        return out["boxes"], out["valid"]

    def extras(self, batch):
        return {"maps": batch["radar_maps"]} if self.mix["radar"] else {}

    # -------------------------------------------------------- check
    def _inputs(self, i):
        """Scene ``i`` as the reference takes it: the collate's resize of
        the letterboxed frame, rounded to float16 as the cache stores
        images; the radar maps from the raw points; the valid radar
        proposals (the collate keeps 32 and 256 points)."""
        it = self.pool.items[i]
        size = self.config["img_size"]
        img = fusion.resize_nearest(it["image"], size)
        image = torch.from_numpy(np.ascontiguousarray(img)).to(
            self.device).half().float()
        if not self.mix["radar"]:
            return image, None, None, float(img.mean())
        return (image, it["radar_points"][:256],
                torch.from_numpy(it["radar_boxes"][:32]).to(self.device),
                float(img.mean()))

    @staticmethod
    def _mode(scenes_of_step, bright):
        return 0 if float(np.mean([bright[i] for i in scenes_of_step])) \
            < DARK else 1

    def check(self, prec=None):
        c = self.config
        P, S = read_npz(c["weights"], self.device)
        layers = darknet.plan(c["blocks"])
        want = {"conf_thresh": c["conf_thresh"], "nms_thresh": c["nms_thresh"],
                "max_det": c["max_det"], "pre_nms_top_k": c["pre_nms_top_k"],
                "class_idx": c["class_idx"]}
        per_step = self.step_scenes()
        needed = sorted({i for s in per_step.values() for i in s})
        inputs = {i: self._inputs(i) for i in needed}
        bright = {i: v[3] for i, v in inputs.items()}
        self.modes = {s: self._mode(sc, bright) for s, sc in per_step.items()}
        sides = {"ref": REFERENCE} if prec is None else {"ref": REFERENCE,
                                                         "ctl": prec}
        views, maps = {}, {}
        with torch.no_grad():
            for name, p in sides.items():
                for i in needed:
                    image, pts, rboxes, _ = inputs[i]
                    m = None
                    if pts is not None:
                        m = fusion.radar_maps(pts, self.pool.items[i][
                            "frame_size"], c["img_size"], prec=p).to(
                                self.device)
                        maps[name, i] = m
                    for mode in sorted(set(self.modes.values())):
                        views[name, (i, mode)] = fusion.fusion_scene(
                            P, S, layers, image, m, rboxes, want, mode,
                            prec=p)
        ref = {k: v for (n, k), v in views.items() if n == "ref"}
        ctl = ({k: v for (n, k), v in views.items() if n == "ctl"}
               if prec is not None else None)
        numbers = self.row_numbers(ref, ctl)
        if self.mix["radar"]:
            pairs = []
            for s, (_, _, extra) in self.kept.items():
                for j, i in enumerate(per_step[s]):
                    got = (maps["ctl", i] if prec is not None
                           else extra["maps"][j])
                    pairs.append((got, maps["ref", i]))
            numbers["map_gap"] = check.map_gap(pairs)
        return numbers

    def scene_key(self, idx, step):
        return (idx, self.modes[step])


@contextlib.contextmanager
def plant(fault):
    """``perfbench.faults``' ``fault`` in the network: an NMS fault in the
    detector's NMS inside ``FusionNetwork.apply``, an answer fault on the
    ``boxes`` and ``valid`` it returns."""
    from millieye_torch.models import fusion as net
    kind, what = faults.FAULTS[fault]
    if kind == "nms":
        site, name = net, "batched_nms"
        broken = faults.nms_with(net.batched_nms, fault)
    else:
        site, name = net.FusionNetwork, "apply"
        apply = net.FusionNetwork.apply

        def broken(self, *a, **kw):
            out = apply(self, *a, **kw)
            out["boxes"], out["valid"] = what(out["boxes"], out["valid"])
            return out
    before = getattr(site, name)
    setattr(site, name, broken)
    try:
        yield
    finally:
        setattr(site, name, before)
