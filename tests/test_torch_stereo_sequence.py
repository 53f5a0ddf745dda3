"""The stereo throughput path end to end: the reference's
`track_sequence_stereo` and the port's on the same rendered QVGA stereo
pairs, mapping, the CRF and loop detection on, the port making the
reference's draws (`torch_parity.run_sequences(stereo=True)`). The
reference folds both eyes' front-ends and the row match into its chunk
program; the port builds a chunk's 2 x take images in one `build_frames`
call. Poses and the exported trajectory to 1 mm / 1 mrad; keyframes,
lost-frame events and stage counts as the reference's
(`torch_parity.compare_sequences`). Its own file: the reference's chunk
program takes about a minute to compile on the CPU."""

import numpy as np
import pytest

from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import (CAM, CAM_REF, SEQ_CFG, assert_poses_close, compare_sequences,
                          run_sequences)


def test_stereo_sequence_matches_reference():
    """6 pairs: the first through track_stereo, then a chunk of 4 and a
    ragged tail of 1."""
    world = RefWorld(cam=CAM_REF, n_frames=24, n_static=900, n_dynamic=0, seed=11,
                     trajectory="line", pixel_noise=0.0, depth_noise=0.0)
    ref, port, pr, pp = run_sequences(world, range(6), chunk=4, stereo=True)
    assert ref.cfg.sensor == port.cfg.sensor == "stereo"
    compare_sequences(ref, port, pr, pp, 6, 4)
    assert len(port.kf_log) >= 1


def test_warm_stereo_sequence_keeps_the_sensor_mode():
    """The reference's defect, kept: on a map that already exists,
    `track_sequence(stereo=True)` does not pin the sensor mode (only the
    initialising first frame does)."""
    world = RefWorld(cam=CAM_REF, n_frames=4, n_static=500, n_dynamic=0, seed=5)
    f = world.frame(0, render=True)
    port = SLAMSystem(CAM, SEQ_CFG, enable_mapping=False, enable_crf=False, device="cpu")
    port.track_rgbd(f.image, f.depth_image, 0.0)
    g = np.stack([world.frame(k, render=True).image for k in (1, 2)]).astype(np.float32)
    poses = port.track_sequence_stereo(g, g, [1 / 30.0, 2 / 30.0], chunk=2)
    assert poses.shape == (2, 4, 4) and port.cfg.sensor == "rgbd"


@pytest.mark.slow
def test_stereo_sequence_full_size():
    """bench.py's stereo run (:171-197) on the CPU: the billboard world at
    640×480, frames 0-30 with their right eyes, chunk 15, default
    configuration, both packages. Each passes the reference test's checks
    (tests/test_mono_stereo_e2e.py:152-158: no lost frame, ATE < 0.05 m,
    >= 2 in-chunk keyframes); the port's own front-end flips a few
    descriptor bits, so the two runs are held to the same keyframe count
    within one and poses to 3 mm / 3 mrad."""
    from lc_crf_slam_tpu.config import SLAMConfig
    from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
    from lc_crf_slam_tpu.utils.evaluate import evaluate_ate
    from lc_crf_slam_torch.geometry.camera import TUM3

    world = RefWorld(cam=REF_TUM3, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line", billboard=True, bb_speed=0.04)
    ref, port, pr, pp = run_sequences(world, range(31), 15, cam_ref=REF_TUM3, cam=TUM3,
                                      cfg=SLAMConfig(), stereo=True)
    gt_t, gt = world.groundtruth()
    for s in (ref, port):
        ts, pe = s.get_trajectory()
        assert evaluate_ate(ts, pe, gt_t[:31], gt[:31]).rmse < 0.05
        assert not any(e.get("event") == "chunk_lost" for e in s.stats)
        assert len(s.kf_log) >= 2
    assert abs(len(ref.kf_log) - len(port.kf_log)) <= 1
    assert_poses_close(pr, pp, pos_tol=3e-3, rot_tol=3e-3)
