"""Dataset generation CLI (port of ``millieye_tpu/cli/prepare_data.py``,
reference data_collection/prepare_data.py). Host code only: it runs the
radar chain on the CPU and takes no ``--device``.

  python -m millieye_torch.cli.prepare_data --recording data/20200729-213410 \\
      --out our_dataset --calib yaml/calib_FOV90.yaml --scene H0-
"""
from __future__ import annotations

import argparse

from millieye_torch.collection.prepare import prepare_dataset
from millieye_torch.radar.projection import load_calib
from millieye_torch.radar.pipeline import RadarParams


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--recording", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--keep_every", type=int, default=5)
    p.add_argument("--scene", default="",
                   help="stem prefix, e.g. 'H0-' (illumination + scene id)")
    args = p.parse_args(argv)
    stems = prepare_dataset(args.recording, args.out, load_calib(args.calib),
                            RadarParams(), args.keep_every, args.scene)
    print(f"emitted {len(stems)} frames")


if __name__ == "__main__":
    main()
