"""Ahead-of-time serving artifact (port of ``millieye_tpu/io/export.py``):
the fusion inference step as one ``torch.export`` program, with the
folded weights baked in as constants and the port's kernels as the
custom ops ``millieye::<name>`` (``ops/library.py``).

    blob = export_serving(model, params, state, batch_size=1)
    open("fusion_serving.pt2", "wb").write(blob)
    # deployment side: torch and the op library, no model code
    step = load_serving(open("fusion_serving.pt2", "rb").read())
    out = step(images, radar_maps, radar_boxes, rmask)
    out["boxes"], out["valid"]   # padded [B, K+R, 7] rows + mask

The step takes letterboxed images [B, S, S, 3] float32, radar maps
[B, S/16, S/16, 3] float32, radar boxes [B, R, 4] float32 and their mask
[B, R] bool, at the batch size it was exported for; ``mode`` is baked in,
one program per mode, as the JAX package does. An artifact runs on the
device it was exported for (the JAX blob records its platform): its
constants live there, and ``load_serving`` refuses inputs elsewhere. On
the card every op launches its kernel, and counts it, as the eager step
does; inside ``cuda_lib.plain_versions()`` it runs the plain versions.
"""
from __future__ import annotations

import io
import json

import torch

from millieye_torch.device import resolve_device, set_numerics
from millieye_torch.ops import library  # noqa: F401  (registers the ops)

_META = "millieye_serving.json"


def _on(tree, dev):
    """Every leaf as a tensor on ``dev``. Numpy leaves (the shape a
    checkpoint restore gives) become tensors before any dtype cast: numpy
    promotes a reduced-precision array with a Python float otherwise than
    torch (the JAX package's lesson in its export)."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on(v, dev) for v in tree]
    return torch.as_tensor(tree, device=dev)


class _Step(torch.nn.Module):
    """The serving step over constant weights: their tensors are plain
    attributes, so ``torch.export`` takes them as constants."""

    def __init__(self, model, params, state, mode):
        super().__init__()
        self.model, self.params, self.state, self.mode = (model, params,
                                                          state, mode)

    def forward(self, images, radar_maps, radar_boxes, rmask):
        out = self.model.apply(self.params, self.state, images, radar_maps,
                               radar_boxes, rmask, mode=self.mode)
        return {"boxes": out["boxes"], "valid": out["valid"]}


def export_serving(model, params, state, batch_size=1, mode=0,
                   device="cuda"):
    """The fusion inference step as bytes (``torch.export.save``).

    model/params/state: a built ``FusionNetwork`` and its weights (fold
    the Darknet's BN first for serving: ``runtime.engine.
    fold_for_serving``), moved to ``device``, where the artifact runs.
    ``mode`` is baked in."""
    dev = resolve_device(device)
    params, state = _on(params, dev), _on(state, dev)
    s, r = model.darknet.img_size, model.cfg.max_radar
    b = batch_size
    args = (torch.zeros((b, s, s, 3), device=dev),
            torch.zeros((b, s // 16, s // 16, 3), device=dev),
            torch.zeros((b, r, 4), device=dev),
            torch.zeros((b, r), dtype=torch.bool, device=dev))
    with torch.no_grad():
        program = torch.export.export(_Step(model, params, state, mode),
                                      args)
    buf = io.BytesIO()
    meta = {"device": str(dev), "batch_size": b, "img_size": s,
            "max_radar": r, "mode": mode}
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def load_serving(blob):
    """An ``export_serving`` blob -> ``f(images, radar_maps, radar_boxes,
    rmask) -> {"boxes", "valid"}``, on the device it was exported for
    (raises there without CUDA, and on inputs that lie elsewhere). It
    turns TF32 off (``device.set_numerics``), as the exporting process
    did: the program's float32 convolutions are full float32."""
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    meta = json.loads(extra[_META])
    dev = torch.device(meta["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_serving: the artifact was exported for "
                           f"{dev} and this process has no CUDA device")
    set_numerics()
    step = program.module()

    def serve(images, radar_maps, radar_boxes, rmask):
        for t in (images, radar_maps, radar_boxes, rmask):
            if t.device.type != dev.type:
                raise ValueError(f"load_serving: the artifact runs on "
                                 f"{dev}, an input lies on {t.device}")
        return step(images, radar_maps, radar_boxes, rmask)

    serve.meta = meta
    return serve
