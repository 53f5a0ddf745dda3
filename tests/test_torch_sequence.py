"""The chunked throughput path end to end: the reference
`SLAMSystem.track_sequence` and the port's on the same rendered frames,
with mapping, the CRF and loop detection on, the port making the
reference's random draws (`torch_parity.run_sequences`). The reference
fuses a chunk into one program with a padded tail; the port loops over
the frames and pads nothing. Returned poses and the exported trajectory
must agree to 1 mm and 1 mrad; keyframe times and indices, lost-frame
events and the map's keyframe count must be equal
(`torch_parity.compare_sequences`). The billboard world is in
tests/test_torch_sequence_dynamic.py, so that the two reference chunk
programs compile on two workers."""

import numpy as np
import pytest
import torch

from lc_crf_slam_tpu.config import SLAMConfig, TrackingConfig
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.models.system import SLAMSystem
from lc_crf_slam_torch.ops.lk_flow import lk_track, lk_track_batch

from torch_parity import (CAM, CAM_REF, SEQ_CFG, compare_sequences, render,
                          run_sequences)


def test_static_world_matches_reference():
    """8 frames: the first through track_rgbd, then a chunk of 4 and a
    ragged tail of 3."""
    world = RefWorld(cam=CAM_REF, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line")
    ref, port, pr, pp = run_sequences(world, range(8), chunk=4)
    compare_sequences(ref, port, pr, pp, 8, 4)
    assert len(port.kf_log) >= 1


def test_batched_lk_equals_per_pair():
    world = RefWorld(cam=CAM_REF, n_frames=6, n_static=500, n_dynamic=0, seed=5)
    imgs = [torch.from_numpy(render(world, k)[0]) for k in range(4)]
    rng = np.random.default_rng(4)
    uvs = [torch.from_numpy((rng.random((64, 2)) * [300, 220] + 10).astype(np.float32))
           for _ in range(3)]
    valids = [torch.from_numpy(rng.random(64) < 0.8) for _ in range(3)]
    batch = lk_track_batch(imgs[:-1], imgs[1:], uvs, valids, n_levels=3)
    assert batch.uv_next.shape == (3, 64, 2) and batch.ok.shape == (3, 64)
    for k in range(3):
        one = lk_track(imgs[k], imgs[k + 1], uvs[k], valids[k], n_levels=3)
        for a, b in zip(one, batch):
            assert torch.equal(a, b[k])


def test_unported_branches_raise():
    """The stereo branch, which raised before it was ported, runs: both
    stereo entries initialise on their first pair (here black, so without
    features), pin the sensor mode and track the rest in chunks."""
    z = np.zeros((2, 240, 320), np.float32)
    for call in ("track_sequence", "track_sequence_stereo"):
        port = SLAMSystem(CAM, SEQ_CFG, device="cpu")
        kw = dict(stereo=True) if call == "track_sequence" else {}
        poses = getattr(port, call)(z, z, [0.0, 0.1], **kw)
        assert poses.shape == (1, 4, 4) and port.cfg.sensor == "stereo"
        assert port.initialized and int(port.map.n_kfs) == 1


@pytest.mark.slow
def test_full_size_billboard_chunk15_matches_reference():
    """chip_smoke.py's sequence phase on the CPU: TUM3 640x480, bench.py's
    billboard world, frames 0-30, the default configuration and
    capacities, chunk 15. Poses to 3 mm / 3 mrad: the first chunk agrees
    to 0.02 mm, but its one crf_step integrates 15 frames of LK flow
    evidence, whose f32 differences (up to 0.07 px in p_flow_err) move
    p_dyn of a dozen points by up to 0.05, and the next chunk's pose
    solves weigh the points by it (1.5 mm until the next keyframe).
    Keyframes, events and stage counts are equal."""
    world = RefWorld(cam=REF_TUM3, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line", billboard=True, bb_speed=0.04)
    ref, port, pr, pp = run_sequences(world, range(31), 15, REF_TUM3, TUM3, SLAMConfig())
    compare_sequences(ref, port, pr, pp, 31, 15, pos_tol=3e-3, rot_tol=3e-3)


@pytest.mark.slow
def test_blackout_relocalises_at_the_chunk_boundary():
    """The world of tests/test_tracking_e2e.py::
    test_track_sequence_relocalizes_after_blackout: a sweep, two black
    frames, then the start sector again. Both packages lose the same
    frames, relocalise at the same chunk boundary and make the same
    keyframes. Poses of the tracked frames to 5 mm / 5 mrad: the sweep
    turns 2.2 degrees a frame, and over 45 frames with local BA single
    frames come 3 mm apart in f32 (the first 26 stay within 0.6 mm); the
    poses of the lost frames are the motion model's extrapolation and are
    not compared."""
    world = RefWorld(cam=CAM_REF, n_frames=96, n_static=1600, n_dynamic=0, seed=5,
                     trajectory="sweep", pixel_noise=0.0, depth_noise=0.0)
    ks = list(range(36)) + [-1, -1] + list(range(8))
    cfg = SLAMConfig(tracking=TrackingConfig(max_frames_between_kf=4))
    ref, port, pr, pp = run_sequences(world, ks, 4, cfg=cfg)
    events = [s.get("event") for s in port.stats]
    assert "chunk_lost" in events and "chunk_reloc" in events
    assert int(port.ts.status) == 1
    tracked = np.ones(len(ks), bool)
    tracked[36:41] = False      # black at 36-37, lost until the boundary after 40
    compare_sequences(ref, port, pr, pp, len(ks), 4, pos_tol=5e-3, rot_tol=5e-3,
                      frames=tracked)
