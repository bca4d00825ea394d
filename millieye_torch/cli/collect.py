"""Recorder CLI (port of ``millieye_tpu/cli/collect.py``, reference
data_collection/collect.py). Host code only.

  python -m millieye_torch.cli.collect --out data/$(date +%Y%m%d-%H%M%S) \\
      --cfg cfg/indoor.cfg --duration 30 --fps 20

``main(argv, reader=...)`` hands a radar reader (``collection.uart.
RadarReader`` over file-like ports) to the recorder in place of the
serial ports, which need pyserial.
"""
from __future__ import annotations

import argparse

from millieye_torch.collection.recorder import record


def main(argv=None, reader=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--cfg", required=True, help="TI radar .cfg file")
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--fps", type=int, default=20)
    args = p.parse_args(argv)
    record(args.out, args.cfg, args.duration, args.fps, reader=reader)


if __name__ == "__main__":
    main()
