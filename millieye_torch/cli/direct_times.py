"""Time the direct ops K10 (``ops/stem.py:fused_stem``) and K13
(``ops/quantize.py:quantize_int8_stochastic``) on the card, per call: the
loop time (CUDA events over back-to-back calls, the median of 5 loops),
the device time a call (``torch.profiler``: every kernel the call
launches, summed) and the host's time a call, at ``chip_smoke.py``'s
cases: K10 at stage 0 (416 px, 3 -> 16) and stage 2 (208 px, 16 -> 32) in
the "vconcat" and "im2col" tap orders, and at block 8's shape (26 px,
128 -> 256), float32 in, float16 out, at batch 1 and 32; K13 on block 12's
weight shape [4608, 1024] and the (8, 128) carrier. Inputs and weights
are seeded, not the served ones: the time does not depend on the values.
Each case is first held bit-equal to the wrapper's plain version (a case
the tree's kernel refuses is reported as refused). It uses only the
wrappers that every version of the two modules has, so it also times
another tree's package, to compare two trees in one call:

    python3 -m millieye_torch.cli.direct_times
    PYTHONPATH=<other tree> python3 millieye_torch/cli/direct_times.py

Prints the card's name and power limit, then one JSON object a case.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import torch

from millieye_torch.ops import cuda_lib, quantize, stem

K10_CASES = ((416, 3, 16), (208, 16, 32), (26, 128, 256))
K13_CASES = (("block 12 [4608, 1024]", (4608, 1024)),
             ("carrier [8, 128]", (8, 128)))
REPEATS = 5


def _smoke():
    """``chip_smoke.py`` beside this file: its timers."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _times(smoke, fn, iters):
    host = [smoke.host_ms(torch, fn, 100) for _ in range(REPEATS)]
    return dict(loop_ms=smoke.cuda_ms(torch, fn, iters, REPEATS),
                device_ms=smoke.device_ms(torch, fn)[0],
                host_ms=(statistics.median(host), min(host), max(host)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("direct_times: no CUDA card")
    smoke = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"package": str(Path(stem.__file__).parents[2])}))
    cuda_lib.build(["stem", "quantize"])
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    for b in (1, 32):
        for hw, cin, cout in K10_CASES:
            x = torch.rand((b, hw, hw, cin), generator=gen).cuda()
            w = (0.2 * torch.randn((3, 3, cin, cout), generator=gen)).cuda()
            bias = (0.1 * torch.randn(cout, generator=gen)).cuda()
            for variant in ("vconcat", "im2col"):
                def call():
                    return stem.fused_stem(x, w, bias, 1, torch.float16,
                                           variant)
                row = dict(kernel="fused_stem", batch=b,
                           case=f"{hw} px {cin}->{cout} {variant} f16")
                try:
                    got = call()
                except (RuntimeError, ValueError) as e:
                    print(json.dumps(dict(row, refused=str(e)[:120])))
                    continue
                if not torch.equal(got, stem.fused_stem_plain(
                        x, w, bias, 1, torch.float16, variant)):
                    raise AssertionError(f"K10 {row}: not bit-equal")
                print(json.dumps(dict(row, **_times(smoke, call, 20))),
                      flush=True)
    for label, shape in K13_CASES:
        w = torch.randn(shape, generator=gen).cuda()
        w[0, 0] = 4.0

        def call():
            return quantize.quantize_int8_stochastic(w, 0)

        q, s = call()
        wq, ws = quantize.quantize_int8_stochastic_plain(w, 0)
        if not (torch.equal(q, wq) and torch.equal(s, ws)):
            raise AssertionError(f"K13 {label}: not bit-equal")
        print(json.dumps(dict(kernel="quantize_stochastic", batch=1,
                              case=label, **_times(smoke, call, 50))),
              flush=True)


if __name__ == "__main__":
    main()
