"""Frames of a recorded session (``iter_frames`` of
``millieye_tpu/collection/prepare.py``; decoding on the host). That
module's dataset generator, ``prepare_dataset``, is not ported yet.
"""
from __future__ import annotations

import os

import numpy as np


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
