"""TI IWR6843 mmWave sensor I/O: config boot + UART frame stream (port
of ``millieye_tpu/collection/uart.py``, numpy host code as there).

Send a ``.cfg`` command list over the CLI port, derive range/Doppler
resolution from profileCfg/frameCfg, then stream the demo-protocol
binary off the data port. The byte-level frame parsing (magic-word scan,
header, type-1 detected-points TLV) runs in C++ (the port's build of
native/millieye_native.cpp, ``native.parse_mmwave_frame``) with a numpy
fallback. ``FrameAssembler.backends`` counts the frames each branch
parsed, as ``radar/dbscan.py``'s ``dbscan.backends`` does.

The two branches are the reference's and are kept as they are, though
they disagree on one input: in a frame with two type-1 TLVs the C++
parser appends the second TLV's points to the first's, where the numpy
parser keeps only the last TLV's; after a TLV shorter than ``num_obj``
points the C++ parser stops advancing at the frame's end, where the
numpy parser advances by ``num_obj`` points.

pyserial is optional (absent in CI); constructing a RadarReader with
file-like objects works for tests and replay.
"""
from __future__ import annotations

import time
from collections import Counter

import numpy as np

_MAGIC = np.array([2, 1, 4, 3, 6, 5, 8, 7], np.uint8)


def parse_radar_cfg(path):
    """Derive the radar operating parameters from a TI demo .cfg file.

    Returns dict with num_adc_samples, range_resolution_m, range_max_m,
    doppler_resolution_mps, frame_period_ms, commands (the line list to
    send at boot).
    """
    commands, profile, frame = [], None, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            commands.append(line)
            parts = line.split()
            if parts[0] == "profileCfg":
                profile = [float(v) for v in parts[1:]]
            elif parts[0] == "frameCfg":
                frame = [float(v) for v in parts[1:]]
    out = {"commands": commands}
    if profile and frame:
        start_freq = profile[1]                  # GHz
        idle_time = profile[2]                   # us
        ramp_end = profile[4]                    # us
        freq_slope = profile[7]                  # MHz/us
        num_adc = int(profile[9])
        dig_rate = profile[10]                   # ksps
        chirps = (frame[1] - frame[0] + 1) * frame[2]
        c = 3e8
        bandwidth_hz = freq_slope * 1e12 * num_adc / (dig_rate * 1e3)
        out.update(
            num_adc_samples=num_adc,
            range_resolution_m=c / (2 * bandwidth_hz),
            range_max_m=(300 * 0.9 * dig_rate) / (2 * freq_slope * 1e3),
            doppler_resolution_mps=c / (
                2 * start_freq * 1e9 * (idle_time + ramp_end) * 1e-6 * chirps),
            frame_period_ms=frame[4],
        )
    return out


class FrameAssembler:
    """Byte stream -> (frame_number, xyzv [n, 4]) frames.

    Feed arbitrary chunks; complete frames pop out. Uses the native C++
    parser when the shared library builds, numpy otherwise; each frame
    adds one to ``FrameAssembler.backends["native"]`` or ``["numpy"]``.
    """

    backends = Counter()

    def __init__(self, max_points=1024, use_native=True):
        self.buf = bytearray()
        self.max_points = max_points
        self._native = None
        if use_native:
            try:
                from millieye_torch.native import parse_mmwave_frame
                parse_mmwave_frame(b"\x00" * 8)   # force lib build
                self._native = parse_mmwave_frame
            except Exception:
                self._native = None

    def feed(self, chunk):
        self.buf.extend(chunk)
        frames = []
        # loop while a frame pops out OR garbage was consumed (a corrupted
        # header may be skipped without yielding a frame; keep rescanning)
        while True:
            before = len(self.buf)
            got = self._parse_one()
            if got is not None:
                frames.append(got)
            elif len(self.buf) == before:
                break
        return frames

    def _parse_one(self):
        if self._native is not None:
            ok, xyzv, frame_no, consumed = self._native(
                self.buf, self.max_points)
            del self.buf[:consumed]
            if not ok:
                return None
            FrameAssembler.backends["native"] += 1
            return frame_no, xyzv
        got = self._parse_numpy()
        if got is not None:
            FrameAssembler.backends["numpy"] += 1
        return got

    def _parse_numpy(self):
        buf = np.frombuffer(bytes(self.buf), np.uint8)
        n = len(buf)
        if n < 40:
            return None
        # magic-word scan
        start = -1
        for i in range(n - 7):
            if np.array_equal(buf[i:i + 8], _MAGIC):
                start = i
                break
        if start < 0:
            del self.buf[:max(0, n - 7)]
            return None
        view = buf[start:]
        if len(view) < 40:
            del self.buf[:start]
            return None
        u32 = lambda off: int(view[off:off + 4].view(np.uint32)[0])
        total_len = u32(12)
        if total_len < 40 or total_len > (1 << 20):
            # corrupted header: skip this magic and rescan instead of
            # stalling forever waiting for a bogus frame length
            del self.buf[:start + 8]
            return None
        if len(view) < total_len:
            del self.buf[:start]
            return None
        frame_no, num_obj, num_tlvs = u32(20), u32(28), u32(32)
        idx, pts = 40, np.zeros((0, 4), np.float32)
        for _ in range(num_tlvs):
            if idx + 8 > total_len:
                break
            tlv_type, tlv_len = u32(idx), u32(idx + 4)
            idx += 8
            if tlv_type == 1:
                take = min(num_obj, (total_len - idx) // 16,
                           self.max_points)
                pts = view[idx:idx + take * 16].view(np.float32).reshape(-1, 4)
                idx += num_obj * 16
            else:
                idx += tlv_len
        del self.buf[:start + total_len]
        return frame_no, pts.copy()


class RadarReader:
    """Boot the sensor over the CLI port and stream frames off the data
    port. ``cli``/``data`` may be pyserial ports or any file-like objects
    with read/write (tests replay byte dumps)."""

    def __init__(self, cfg_path, cli=None, data=None,
                 cli_port="/dev/ttyACM0", data_port="/dev/ttyACM1"):
        self.cfg = parse_radar_cfg(cfg_path)
        if cli is None or data is None:
            import serial                      # gated optional dependency
            cli = cli or serial.Serial(cli_port, 115200, timeout=0.1)
            data = data or serial.Serial(data_port, 921600, timeout=0.1)
        self.cli, self.data = cli, data
        self.assembler = FrameAssembler()

    def boot(self, inter_command_delay=0.01):
        for cmd in self.cfg["commands"]:
            self.cli.write((cmd + "\n").encode())
            time.sleep(inter_command_delay)

    def poll(self, chunk_size=4096):
        """Read available bytes; return list of (frame_number, xyzv)."""
        chunk = self.data.read(chunk_size)
        return self.assembler.feed(chunk) if chunk else []

    def record(self, duration_s, on_frame=None):
        """Stream for ``duration_s``; returns the recorder's pickle layout
        (list of {"Data": {...}, "Time", "Frame_ID"}) compatible with
        ``collection.sync.load_pointcloud``."""
        records = []
        t_end = time.time() + duration_s
        while time.time() < t_end:
            for frame_no, xyzv in self.poll():
                rec = {"Data": {"numObj": len(xyzv),
                                "x": xyzv[:, 0], "y": xyzv[:, 1],
                                "z": xyzv[:, 2], "velocity": xyzv[:, 3]},
                       "Time": time.time(), "Frame_ID": frame_no}
                records.append(rec)
                if on_frame:
                    on_frame(rec)
        return records
