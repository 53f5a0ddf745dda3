"""The port's stereo front end against a plain reference
(`slam_bench/reference/stereo.py`: `reference_frame` of each eye, then
the row match), on pairs of a static scene seen by the EuRoC stereo rig
at ORB-SLAM2's published settings (`tests/euroc_rig.py`: 752x480, 1200
features, a capacity of 1200 keypoints, bf 47.9064).

On the CPU the rig is cut only in size, to half its pixels (376x240,
fx, cx, cy and bf halved: the same baseline): `SLAMSystem._stereo_frames`
of one pair, and of two pairs in one batch (the chunk path's), gives the
plain pipeline's left keypoints and descriptors, the same matched set,
and `u_right` and `depth` exactly. No tolerance is needed: the match
compares integer Hamming distances, the ratio test multiplies an integer
by 0.9 in float32 on both sides, and a depth is the one float32 division
bf / disparity of the same two pixel columns. A short `track_stereo`
session at that size stays within the stereo ATE bar of
tests/test_mono_stereo_e2e.py (0.05 m) and loses no frame.

On the card (`cuda`-marked, skipped without one) the same comparison at
the rig's published widths, 752x480 and 1200 keypoints, the port with its
fused FAST kernel and the reference in float32 with TF32 off. This file
imports neither jax nor the JAX package (tests/test_torch_stereo.py holds
the port to the JAX package at the same rig):

    python3 -m pytest --noconftest -q tests/test_torch_stereo_reference.py
"""

import numpy as np
import pytest
import torch

import euroc_rig
from lc_crf_slam_torch.config import SLAMConfig
from lc_crf_slam_torch.geometry.camera import Pinhole
from lc_crf_slam_torch.models.system import SLAMSystem
from slam_bench.reference.checks import sessions_ate
from slam_bench.reference.stereo import reference_stereo_frame
from slam_bench.world import Pinhole as WorldPinhole, SyntheticWorld

ATE_BAR = 0.05      # tests/test_mono_stereo_e2e.py's stereo bar [m]


def _setup(scale: float, device: str, **map_caps):
    """(world, system, ORB settings, camera) of the rig at `scale` of its
    pixels."""
    cam = euroc_rig.camera(scale)
    world = SyntheticWorld(cam=WorldPinhole(**cam), **euroc_rig.WORLD)
    cfg = euroc_rig.slam_config(SLAMConfig(), **{f"map.{k}": v for k, v in map_caps.items()})
    slam = SLAMSystem(Pinhole(**cam), cfg, device=device)
    return world, slam, euroc_rig.orb(), cam


def _pair(world, k):
    return world.frame(k, render=True).image, world.right_eye(k)


def _assert_equal_to_plain(slam, orb, cam, pairs, device):
    lefts = torch.tensor(np.stack([p[0] for p in pairs]), device=device)
    rights = torch.tensor(np.stack([p[1] for p in pairs]), device=device)
    frames = slam._stereo_frames(lefts, rights)
    assert len(frames) == len(pairs)
    for (left, right), got in zip(pairs, frames):
        want = reference_stereo_frame(left, right, orb, cam["bf"], device)
        for field in ("uv", "level", "desc", "valid"):
            assert torch.equal(getattr(got, field), getattr(want.left, field)), field
        assert got.capacity == orb["max_keypoints"] == 1200
        matched = want.u_right >= 0
        assert torch.equal(got.u_right >= 0, matched)
        assert torch.equal(got.u_right, want.u_right)
        assert torch.equal(got.depth, want.depth)
        # most keypoints found their right eye, at the scene's depths
        assert matched.sum() > 0.5 * want.left.valid.sum()
        assert 1.0 < float(want.depth[matched].median()) < 6.0


@pytest.fixture(scope="module")
def half_size():
    torch.set_num_threads(2)
    return _setup(0.5, "cpu", max_points=4096, max_keyframes=16)


@pytest.mark.parametrize("ks", [(0,), (17,), (30, 31)], ids=["pair0", "pair17", "batch"])
def test_stereo_frames_equal_the_plain_pipeline(half_size, ks):
    world, slam, orb, cam = half_size
    _assert_equal_to_plain(slam, orb, cam, [_pair(world, k) for k in ks], "cpu")


def test_short_session_within_the_stereo_bar(half_size):
    world = half_size[0]
    _, slam, _, _ = _setup(0.5, "cpu", max_points=4096, max_keyframes=16)
    n = 4
    poses = [slam.track_stereo(*_pair(world, k), k / euroc_rig.FPS).numpy()
             for k in range(n)]
    assert slam.cfg.sensor == "stereo"
    assert [s.get("status", 1) for s in slam.stats] == [1] * n
    assert len(slam.kf_log) >= 1
    ate = sessions_ate([{"frames": list(range(n)), "Tcw": poses}], world)
    assert ate < ATE_BAR, ate


@pytest.mark.cuda
def test_stereo_frames_equal_the_plain_pipeline_on_the_card():
    """At the rig's published widths, 752x480 and 1200 keypoints, on two
    pairs of its scene, one at a time and in one batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused FAST kernel has no CPU mode)")
    world, slam, orb, cam = _setup(1.0, "cuda")
    assert (cam["width"], cam["height"]) == (752, 480)
    pairs = [_pair(world, k) for k in (0, 40)]
    for pair in pairs:
        _assert_equal_to_plain(slam, orb, cam, [pair], "cuda")
    _assert_equal_to_plain(slam, orb, cam, pairs, "cuda")
