"""Two-process synchronized recorder, radar + camera (port of
``millieye_tpu/collection/recorder.py``).

One process per sensor, a Pipe handshake so the camera only starts once
the radar reports ready ("radar-ready", then "camera-go"), artifacts on
disk:

  <out>/pointcloud.pkl   list of {"Data": {...}, "Time", "Frame_ID"}
  <out>/video.mp4        (when OpenCV is available)  OR
  <out>/frames/*.jpg     (PIL fallback per-frame dump)
  <out>/timestamps.txt   "<wallclock> <index>" per captured frame

Hardware-dependent pieces (pyserial, camera) are optional; both loops
accept injected sources for tests, and ``record(reader=...)`` hands a
radar reader to the radar process. The processes start by the platform's
default method (``fork`` on Linux) and touch only the host: no torch, so
a parent that already initialised CUDA can start them.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time


def radar_process(pipe, out_dir, cfg_path, duration_s, reader=None):
    from millieye_torch.collection.uart import RadarReader
    reader = reader or RadarReader(cfg_path)
    reader.boot()
    pipe.send("radar-ready")
    pipe.recv()                                    # wait for camera go
    records = reader.record(duration_s)
    with open(os.path.join(out_dir, "pointcloud.pkl"), "wb") as f:
        pickle.dump(records, f)


def camera_process(pipe, out_dir, duration_s, fps=20, size=(640, 480),
                   camera_index=0):
    pipe.recv()                                    # radar-ready handshake
    pipe.send("camera-go")
    try:
        import cv2
        cap = cv2.VideoCapture(camera_index)
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, size[0])
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, size[1])
        writer = cv2.VideoWriter(
            os.path.join(out_dir, "video.mp4"),
            cv2.VideoWriter_fourcc(*"XVID"), fps, size)
        dump_dir = None
    except Exception:
        cap = writer = None
        dump_dir = os.path.join(out_dir, "frames")
        os.makedirs(dump_dir, exist_ok=True)

    times = []
    idx = 0
    t_end = time.time() + duration_s
    period = 1.0 / fps
    while time.time() < t_end:
        t0 = time.time()
        if cap is not None:
            ok, frame = cap.read()
            if not ok:
                continue
            writer.write(frame)
        else:
            # no camera stack: placeholder frame keeps timing contract
            from PIL import Image
            import numpy as np
            Image.fromarray(
                np.zeros((size[1], size[0], 3), np.uint8)).save(
                os.path.join(dump_dir, f"{idx:06d}.jpg"))
        times.append((t0, idx))
        idx += 1
        time.sleep(max(0.0, period - (time.time() - t0)))

    if writer is not None:
        writer.release()
        cap.release()
    with open(os.path.join(out_dir, "timestamps.txt"), "w") as f:
        for t, i in times:
            f.write(f"{t} {i}\n")


def record(out_dir, cfg_path, duration_s=30, fps=20, reader=None):
    """Spawn both sensor processes with the ready handshake. ``reader``:
    a radar reader for the radar process (default: a ``RadarReader`` of
    ``cfg_path`` on the serial ports)."""
    os.makedirs(out_dir, exist_ok=True)
    a, b = mp.Pipe()
    pr = mp.Process(target=radar_process,
                    args=(a, out_dir, cfg_path, duration_s, reader),
                    daemon=True)
    pc = mp.Process(target=camera_process,
                    args=(b, out_dir, duration_s, fps), daemon=True)
    pr.start()
    pc.start()
    pc.join()
    pr.join(timeout=10)
    if pr.is_alive():
        pr.terminate()
