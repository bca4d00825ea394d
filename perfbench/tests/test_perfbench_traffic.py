"""The frozen traffic generator gives the program's generator's arrays for
the same (seed, index), at the driver's large seeds too; the pool
repeats its scenes, and the same seed gives the same pool."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.traffic import Pool
from perfbench.traffic.scenes import SyntheticScenes

BASE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 777, 3_000_000_019])
@pytest.mark.parametrize("light", ["H", "L"])
def test_same_arrays_as_the_program(seed, light):
    from millieye_torch.data.synthetic import SyntheticScenes as Program
    ours = SyntheticScenes(6, seed=seed, illumination=(light,))
    theirs = Program(6, seed=seed, illumination=(light,))
    assert len(ours) == len(theirs) == 3
    for i in range(len(ours)):
        a, b = ours.get(i), theirs.get(i)
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


def test_pool():
    mix = json.loads((BASE / "traffic" / "dark-b256.json").read_text())
    mix = dict(mix, pool=3, repeat=4)
    pool = Pool(mix, 5_000_000_001)
    assert len(pool) == 12
    assert pool.get(7) is pool.get(1)
    again = Pool(mix, 5_000_000_001)
    np.testing.assert_array_equal(pool.get(2)["image"], again.get(2)["image"])
    dark = np.mean([it["image"].mean() for it in pool.items])
    assert dark < 0.1


@pytest.mark.parametrize("name", ["dark-b256", "bright-b256", "bright-b8"])
def test_mixes_are_data(name):
    mix = json.loads((BASE / "traffic" / f"{name}.json").read_text())
    assert set(mix) == {"illumination", "radar", "pool", "repeat", "batch"}
    assert mix["pool"] * mix["repeat"] >= mix["batch"]
