"""One seed gives the same scenes twice; another seed other scenes."""

import numpy as np
import pytest

from portbench.harness import load_json
from portbench.traffic.generate import generate

SMALL = {"scenes_150k_x60": dict(num_scenes=3, points_per_scene=4000),
         "subclouds_r2_x128": dict(num_scenes=1, points_per_scene=20000,
                                   min_points=200, num_subclouds=6)}


@pytest.mark.parametrize("mix_name", sorted(SMALL))
def test_seed_gives_the_same_scenes(mix_name):
    mix = dict(load_json("traffic", mix_name), **SMALL[mix_name])
    big = 2**31 + 12345
    a, b, c = generate(mix, big), generate(mix, big), generate(mix, big + 1)
    assert len(a) == len(b) == len(c) == (mix.get("num_subclouds")
                                          or mix["num_scenes"])
    for x, y in zip(a, b):
        for f in ("points", "colors", "labels"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert any(x.points.shape != z.points.shape
               or not np.array_equal(x.points, z.points)
               for x, z in zip(a, c))


def test_full_mix_sizes():
    mix = load_json("traffic", "scenes_150k_x60")
    scenes = generate(dict(mix, num_scenes=2), 7)
    # the rooms' parts round down: 149,988 of 150,000, on every seed
    n = {s.points.shape[0] for s in scenes + generate(dict(mix, num_scenes=2),
                                                      8)}
    assert len(n) == 1 and 0.999 * mix["points_per_scene"] <= n.pop()
