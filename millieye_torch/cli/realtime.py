"""Live camera + radar demo (port of ``millieye_tpu/cli/realtime.py``,
reference data_collection/realtime_show.py + the live half of
run_mp.py).

  python -m millieye_torch.cli.realtime --calib C.yaml --cfg radar.cfg \\
      [--weights W] [--mode 0] [--device cuda]

A radar thread reads the UART and keeps the newest 8 point clouds; the
main loop captures a camera frame, overlays the newest two clouds, runs
the tracker on the host and ``FusionEngine.infer`` on the card, draws
the boxes and shows the frame. Needs OpenCV (capture, drawing, display)
and pyserial (radar), and says so and returns 1 without them.

``main`` has seams for what a headless machine lacks, each standing in
for one piece and changing no answer: ``capture`` (an object with
``read() -> (ok, bgr)`` and ``release()``, as ``cv2.VideoCapture``),
``reader`` (a ``collection.uart.RadarReader``, e.g. over file-like
ports; then pyserial is not needed), ``display`` (called once a frame
with the annotated BGR image and the frame's record ``{"pts", "boxes",
"valid"}``: the (4, n) points the tracker was given and the engine's
answer; a true return ends the loop, as the window's "q" key does) and
``engine`` (a built ``FusionEngine``; by default one is built from
``--weights`` at the ``f32`` preset). The radar thread stops when
``main`` returns.
"""
from __future__ import annotations

import argparse
import queue
import threading

import numpy as np

from millieye_torch.cli._common import build_fusion
from millieye_torch.collection.uart import RadarReader
from millieye_torch.radar.pipeline import RadarPipeline, RadarParams
from millieye_torch.radar.projection import load_calib
from millieye_torch.runtime.engine import FusionEngine
from millieye_torch.runtime.profiler import StageTimer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--calib", required=True)
    p.add_argument("--cfg", required=True, help="TI radar .cfg")
    p.add_argument("--weights", default=None)
    p.add_argument("--mode", type=int, default=0)
    p.add_argument("--camera", type=int, default=0)
    p.add_argument("--frame_w", type=int, default=640)
    p.add_argument("--frame_h", type=int, default=480)
    p.add_argument("--img_size", type=int, default=416)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def main(argv=None, *, capture=None, reader=None, display=None,
         engine=None):
    args = parse_args(argv)
    try:
        import cv2
    except ImportError:
        print("realtime demo needs OpenCV (cv2) for capture/display; "
              "use `cli.demo` to replay recordings instead")
        return 1
    if reader is None:
        try:
            import serial  # noqa: F401
        except ImportError:
            print("realtime demo needs pyserial for the radar UART")
            return 1

    frame_size = (args.frame_w, args.frame_h)
    if engine is None:
        model, params, state = build_fusion(
            weights=args.weights, preset="f32", img_size=args.img_size,
            device=args.device)
        engine = FusionEngine(model, params, state, frame_size=frame_size,
                              device=args.device)
    engine.warmup(args.mode)

    radar = RadarPipeline(load_calib(args.calib),
                          RadarParams(frame_size=frame_size))
    reader = reader or RadarReader(args.cfg)
    reader.boot()

    point_q = queue.Queue(maxsize=8)
    stop = threading.Event()

    def radar_loop():
        while not stop.is_set():
            for _, xyzv in reader.poll():
                if point_q.full():                  # drop the oldest
                    try:
                        point_q.get_nowait()
                    except queue.Empty:             # the loop drained it
                        pass
                point_q.put(xyzv)

    radar_thread = threading.Thread(target=radar_loop, name="realtime-radar",
                                    daemon=True)
    radar_thread.start()

    window = display is None
    if capture is None:
        capture = cv2.VideoCapture(args.camera)
        capture.set(cv2.CAP_PROP_FRAME_WIDTH, args.frame_w)
        capture.set(cv2.CAP_PROP_FRAME_HEIGHT, args.frame_h)
    if window:
        display = _window(cv2)
    timer = StageTimer(("frame",))
    latest = [np.zeros((0, 4), np.float32)]
    try:
        while True:
            ok, bgr = capture.read()
            if not ok:
                break
            while True:
                try:
                    latest.append(point_q.get_nowait())
                except queue.Empty:
                    break
                latest = latest[-2:]                # overlay_num frames
            # the reference's test: while the older slot is empty the
            # tracker gets no points, whatever the newer slot holds
            pts = (np.concatenate(latest, axis=0).T if latest[0].size
                   else np.zeros((4, 0)))
            with timer("frame"):
                out = radar.process(pts)
                boxes, valid = engine.infer(
                    bgr[:, :, ::-1], out["points_uvzv"], out["proposals"],
                    args.mode)
            for b, v in zip(boxes, valid):
                if v:
                    cv2.rectangle(bgr, (int(b[0]), int(b[1])),
                                  (int(b[2]), int(b[3])), (0, 255, 0), 2)
            cv2.putText(bgr, f"{timer.fps('frame'):.1f} fps", (8, 24),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
            if display(bgr, {"pts": pts, "boxes": boxes, "valid": valid}):
                break
    finally:
        stop.set()
        radar_thread.join()
        capture.release()
    if window:
        cv2.destroyAllWindows()
    return 0


def _window(cv2):
    """The default display: an OpenCV window; "q" ends the loop."""
    def show(bgr, _frame):
        cv2.imshow("millieye_torch", bgr)
        return cv2.waitKey(1) & 0xFF == ord("q")
    return show


if __name__ == "__main__":
    raise SystemExit(main())
