"""Dataset generation: replay a recording through the radar pipeline
(port of ``millieye_tpu/collection/prepare.py``; host code, numpy).

Walk a recorded session (video + timestamps + pointcloud), run
time-matching, projection, clustering and tracking, and emit the training
dataset layout consumed by ``data.datasets.RadarFusionDataset``:

  <out>/image/<stem>.jpg         every ``keep_every``-th video frame
  <out>/radar_point/<stem>.pkl   [n, 4] (u, v, depth, |v|) float array
  <out>/radar_box/<stem>.pkl     [k, 4] xyxy proposals (camera coords)
  <out>/dataset.txt              one image path per emitted frame

Frames come from ``video.mp4`` (OpenCV, when present) or a ``frames/``
image directory (the recorder's fallback, also handy for tests).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from millieye_torch.collection.sync import (load_timestamps, load_pointcloud,
                                            match_frames)
from millieye_torch.radar.pipeline import RadarPipeline, RadarParams


def iter_frames(rec_dir):
    """Yield (index, HxWx3 uint8 RGB frame). Video decode prefers OpenCV,
    falls back to imageio(+ffmpeg), then a ``frames/`` jpg directory (the
    recorder's camera-less output)."""
    video = os.path.join(rec_dir, "video.mp4")
    frames_dir = os.path.join(rec_dir, "frames")
    if os.path.exists(video):
        try:
            import cv2
            cap = cv2.VideoCapture(video)
            i = 0
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                yield i, bgr[:, :, ::-1]
                i += 1
            cap.release()
            return
        except ImportError:
            pass
        try:
            import imageio
            for i, frame in enumerate(imageio.get_reader(video)):
                yield i, np.asarray(frame)[..., :3]
            return
        except Exception:
            pass
    from PIL import Image
    names = sorted(os.listdir(frames_dir))
    for i, name in enumerate(names):
        yield i, np.asarray(Image.open(
            os.path.join(frames_dir, name)).convert("RGB"))


def prepare_dataset(rec_dir, out_dir, calib, params: RadarParams = None,
                    keep_every=5, scene=""):
    """Returns the list of emitted dataset stems. The tracker sees every
    frame, kept or not; ``dataset.txt`` is appended to."""
    from PIL import Image
    params = params or RadarParams()
    for sub in ("image", "radar_point", "radar_box"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    vtimes = load_timestamps(os.path.join(rec_dir, "timestamps.txt"))
    rtimes, rframes = load_pointcloud(
        os.path.join(rec_dir, "pointcloud.pkl"))
    matches = match_frames(vtimes, rtimes, params.num_nearest)
    pipeline = RadarPipeline(calib, params)

    stems = []
    overlay = []
    for idx, frame in iter_frames(rec_dir):
        if idx >= len(matches):
            break
        for ri in matches[idx]:
            overlay.append(rframes[ri])
        overlay = overlay[-params.overlay_num:]
        pts = (np.concatenate(overlay, axis=1) if overlay
               else np.zeros((4, 0)))
        out = pipeline.process(pts)
        if idx % keep_every:
            continue
        stem = f"{scene}{idx:06d}"
        Image.fromarray(frame).save(
            os.path.join(out_dir, "image", stem + ".jpg"))
        with open(os.path.join(out_dir, "radar_point", stem + ".pkl"),
                  "wb") as f:
            pickle.dump(out["points_uvzv"], f)
        with open(os.path.join(out_dir, "radar_box", stem + ".pkl"),
                  "wb") as f:
            pickle.dump(out["proposals"], f)
        stems.append(stem)

    with open(os.path.join(out_dir, "dataset.txt"), "a") as f:
        for stem in stems:
            f.write(os.path.join(out_dir, "image", stem + ".jpg") + "\n")
    return stems
