"""The frozen generator: the same seed gives the same frames, another
seed other sensor noise on the same scene, and a frame is what it was
when the copy was made."""

import hashlib
import json
import os

import numpy as np
import pytest

from slam_bench.session import render, seed_of, world_of
from slam_bench.tests.tiny import BENCH


def conf(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ["tum3_walking_rgbd", "tum3_static_rgbd"])
def test_same_seed_same_frames(name):
    a = render(world_of(conf(name), 2**33 + 7), 2)
    b = render(world_of(conf(name), 2**33 + 7), 2)
    c = render(world_of(conf(name), 2**33 + 8), 2)
    for (ga, da, ta), (gb, db, tb) in zip(a, b):
        assert np.array_equal(ga, gb) and np.array_equal(da, db) and ta == tb
    assert not np.array_equal(a[1][0], c[1][0])


def test_frame_as_frozen():
    gray, depth, _ = render(world_of(conf("tum3_walking_rgbd"), 2**31 + 5), 4)[3]
    digest = hashlib.sha256(gray.tobytes() + depth.tobytes()).hexdigest()
    assert digest[:16] == "b09babc69ef70cf4"


@pytest.mark.parametrize("seed", [-1, 0, 2**31 + 1, 2**40 + 3])
def test_any_whole_number_is_a_seed(seed):
    assert 0 <= seed_of(seed) < 2**63
    world_of(conf("tum3_static_rgbd"), seed)
