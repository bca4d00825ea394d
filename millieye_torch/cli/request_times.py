"""Host time a request of serving paths on the card: ``FusionEngine.infer``
on ``chip_smoke.py``'s 8 requests after one warm-up pass over them, in
rounds; each request ends in a copy to the host. It uses only the entry
points that every version of the port has, so it also times another
tree's package, to compare two trees in one call:

    python3 -m millieye_torch.cli.request_times [preset ...]
    PYTHONPATH=<other tree> python3 millieye_torch/cli/request_times.py

The default preset is ``pallas_max_s01``. Prints the card's name and
power limit, then one JSON object a preset: the median, least and most
of the rounds' mean host ms a request.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from millieye_torch.cli._common import build_fusion
from millieye_torch.cli.nms_times import _smoke
from millieye_torch.device import set_numerics
from millieye_torch.ops import cuda_lib
from millieye_torch.runtime.engine import FusionEngine

ROUNDS = 15


def main(argv=None):
    presets = (sys.argv[1:] if argv is None else argv) or ["pallas_max_s01"]
    if not torch.cuda.is_available():
        raise SystemExit("request_times: no CUDA card")
    smoke = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"package": str(Path(cuda_lib.__file__).parents[2])}))
    set_numerics()
    cuda_lib.build()
    reqs = smoke.requests(np.random.default_rng(1), smoke.N_REQUESTS)
    for preset in presets:
        model, params, state = build_fusion(smoke.CKPT, preset)
        engine = FusionEngine(model, params, state, frame_size=smoke.FRAME)
        for r in reqs:
            engine.infer(*r)
        rounds = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            for r in reqs:
                engine.infer(*r)
            rounds.append((time.perf_counter() - t0) * 1e3 / len(reqs))
        print(json.dumps({"preset": preset, "requests": len(reqs),
                          "rounds": ROUNDS,
                          "host_ms_per_request": [float(np.median(rounds)),
                                                  min(rounds), max(rounds)]}))


if __name__ == "__main__":
    main()
