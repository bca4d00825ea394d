"""Time the NMS kernels K1 and K5 on the card, per call: the host's time
for the wrapper and for its bare C launch, the loop time (CUDA events over
back-to-back calls) and the device time (``torch.profiler``), at batch 1
and 32, on ``chip_smoke.py``'s knife-edge inputs and on the serving shape
(valid a prefix of ``LIVE`` rows). Each case is first held bit-equal to
the wrapper's plain version. It uses only the wrappers and C entry points
that every version of ``ops/nms_kernel.py`` has, so it also times another
tree's package, to compare two trees in one call:

    python3 -m millieye_torch.cli.nms_times
    PYTHONPATH=<other tree> python3 millieye_torch/cli/nms_times.py

Prints the card's name and power limit, then one JSON object a case.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from millieye_torch.ops import cuda_lib, nms_kernel

CASES = (("nms", (128, 256, 512)), ("nms_full", (512, 135, 96, 232)))
SERVING = (("nms", (128, 512)), ("nms_full", (96, 232)))
LIVE = 26      # the median live rows P1, P2 and the window feed K1 and K5
REPEATS = 5


def _smoke():
    """``chip_smoke.py`` beside this package: its inputs and timers."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spread(xs):
    return statistics.median(xs), min(xs), max(xs)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("nms_times: no CUDA card")
    smoke = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"package": str(Path(nms_kernel.__file__).parents[2])}))
    cuda_lib.build(["nms"])
    wrappers = {
        "nms": (nms_kernel.nms_keep_mask_blocked,
                nms_kernel.nms_keep_mask_blocked_plain,
                "millieye_nms_keep_mask"),
        "nms_full": (nms_kernel.nms_keep_mask_full,
                     nms_kernel.nms_keep_mask_full_plain,
                     "millieye_nms_keep_mask_full")}
    rng = np.random.default_rng(0)
    for b in (1, 32):
        for serving, cases in ((None, CASES), (LIVE, SERVING)):
            for name, ks in cases:
                kern, plain, symbol = wrappers[name]
                for k in ks:
                    boxes, valid = smoke.nms_inputs(rng, b, k)
                    if serving is not None:
                        valid = np.broadcast_to(np.arange(k) < serving,
                                                (b, k)).copy()
                    tb = torch.tensor(boxes, device="cuda")
                    tv = torch.tensor(valid, device="cuda")
                    if not torch.equal(kern(tb, tv, 0.5),
                                       plain(tb, tv, 0.5)):
                        raise AssertionError(f"{name} K={k} b{b}: not "
                                             f"bit-equal to the plain version")
                    keep = torch.empty_like(tv)
                    lib = nms_kernel._lib()
                    c_launch = getattr(lib, symbol)
                    c_args = (cuda_lib.ptr(tb), cuda_lib.ptr(tv),
                              cuda_lib.ptr(keep), b, k, 0.5,
                              cuda_lib.stream_ptr(tb.device))

                    def bare():
                        cuda_lib.check(lib, c_launch(*c_args), symbol)

                    def wrapped():
                        kern(tb, tv, 0.5)

                    print(json.dumps(dict(
                        kernel=name, batch=b, k=k, live=serving,
                        host_ms=_spread([smoke.host_ms(torch, wrapped, 200)
                                         for _ in range(REPEATS)]),
                        host_c_launch_ms=_spread(
                            [smoke.host_ms(torch, bare, 200)
                             for _ in range(REPEATS)]),
                        loop_ms=smoke.cuda_ms(torch, wrapped, 50, REPEATS),
                        device_ms=smoke.device_ms(torch, wrapped)[0])))


if __name__ == "__main__":
    main()
