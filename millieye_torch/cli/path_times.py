"""Device time a request of serving paths on the card: a ``torch.profiler``
trace of 4 requests (``chip_smoke.py``'s requests, checkpoint and
profile) after one warm-up pass over them, per preset. It uses only the
entry points that every version of the port has, so it also times
another tree's package, to compare two trees in one call:

    python3 -m millieye_torch.cli.path_times [preset ...]
    PYTHONPATH=<other tree> python3 millieye_torch/cli/path_times.py pallas_stem

The default preset is ``pallas_stem`` (K9 at stages 0 and 2, "highest").
Prints the card's name and power limit, then one JSON object a preset.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from millieye_torch.cli._common import build_fusion
from millieye_torch.cli.nms_times import _smoke
from millieye_torch.device import set_numerics
from millieye_torch.ops import cuda_lib
from millieye_torch.runtime.engine import FusionEngine


def main(argv=None):
    presets = (sys.argv[1:] if argv is None else argv) or ["pallas_stem"]
    if not torch.cuda.is_available():
        raise SystemExit("path_times: no CUDA card")
    smoke = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"package": str(Path(cuda_lib.__file__).parents[2])}))
    set_numerics()
    cuda_lib.build()
    reqs = smoke.requests(np.random.default_rng(1), 4)
    for preset in presets:
        model, params, state = build_fusion(smoke.CKPT, preset)
        engine = FusionEngine(model, params, state, frame_size=smoke.FRAME)
        calls = [lambda r=r: engine.infer(*r) for r in reqs]
        for call in calls:
            call()
        print(json.dumps({"preset": preset,
                          **smoke.profile_calls(torch, preset, calls)}))


if __name__ == "__main__":
    main()
