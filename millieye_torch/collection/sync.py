"""Recording I/O and camera/radar time matching (port of
``millieye_tpu/collection/sync.py``; numpy on the host, operation for
operation as the JAX package's, so both pick the same radar frames).

The recorder writes ``timestamps.txt`` (one wall-clock line a video
frame) and ``pointcloud.pkl`` (a list of ``{"Data": {"numObj", "x", "y",
"z", "velocity"}, "Time", "Frame_ID"}``); for each video frame
``match_frames`` picks the radar frames nearest in time.
"""
from __future__ import annotations

import pickle

import numpy as np


def load_timestamps(path):
    """timestamps.txt -> float seconds [n_video_frames]."""
    times = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            times.append(float(parts[0]))
    return np.asarray(times, np.float64)


def load_pointcloud(path):
    """pointcloud.pkl -> (times [n], frames list of [4, numObj] float arrays).

    Each frame is rows (x, y, z, velocity) — the layout
    ``RadarPipeline.process`` consumes.
    """
    with open(path, "rb") as f:
        records = pickle.load(f)
    times, frames = [], []
    for rec in records:
        d = rec["Data"]
        times.append(float(rec["Time"]))
        frames.append(np.stack([
            np.asarray(d["x"], np.float64),
            np.asarray(d["y"], np.float64),
            np.asarray(d["z"], np.float64),
            np.asarray(d["velocity"], np.float64),
        ]))
    return np.asarray(times, np.float64), frames


def match_frames(video_times, radar_times, num_nearest=3):
    """Per video frame: indices of the ``num_nearest`` radar frames closest
    in wall-clock time, deduplicated against the previous frame's picks so
    each radar frame is consumed once.
    """
    matches = []
    prev = set()
    for t in np.asarray(video_times, np.float64):
        # numpy's default sort kind, as the JAX package calls it: on equal
        # distances a stable sort would pick other radar frames
        order = np.argsort(np.abs(radar_times - t))[:num_nearest]
        picks = [int(i) for i in order if int(i) not in prev]
        prev = set(int(i) for i in order)
        matches.append(picks)
    return matches
