"""The generator makes the same pool from the same seed, another from
another seed, and gives every seed the same set of sizes."""

import numpy as np
import pytest

from pillarbench import inputs
from pillarbench.tests.tiny import TRAFFIC

LIDAR = dict(scene="lidar", **TRAFFIC["lidar"])
TRAIN = dict(scene="train", **TRAFFIC["train"])
CFG = {"x_min": -20.0, "x_max": 20.0, "y_min": -20.0, "y_max": 20.0,
       "max_points": 4096, "classes": [
           {"width": 1.9, "length": 4.7, "height": 1.7, "z_center": -1.0},
           {"width": 0.8, "length": 0.8, "height": 1.8, "z_center": -0.9}]}


def flat(pool):
    return [a for item in pool for a in (item if isinstance(item, tuple)
                                         else (item,))]


@pytest.mark.parametrize("traffic", [LIDAR, TRAIN], ids=["lidar", "train"])
def test_same_seed_same_pool(traffic):
    a = flat(inputs.make_pool(traffic, CFG, 2 ** 31 + 5))
    b = flat(inputs.make_pool(traffic, CFG, 2 ** 31 + 5))
    c = flat(inputs.make_pool(traffic, CFG, 6))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(a, c))


def test_every_seed_the_same_sizes():
    sizes = [sorted(len(c) for c in inputs.make_pool(LIDAR, CFG, s))
             for s in (1, 2, 3)]
    assert sizes[0] == sizes[1] == sizes[2]


def test_unknown_scene_kind_names_the_missing_file():
    with pytest.raises(FileNotFoundError, match="scenes"):
        inputs.make_pool(dict(LIDAR, scene="nonesuch"), CFG, 1)
