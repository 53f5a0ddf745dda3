"""The chunked throughput path on bench.py's billboard world at QVGA (a
rigid textured mover crossing a static scene): the reference
`track_sequence` against the port's, as tests/test_torch_sequence.py,
plus the CRF's dynamic probabilities to 1e-3."""

import numpy as np

from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld

from torch_parity import CAM_REF, compare_sequences, run_sequences


def test_billboard_world_matches_reference():
    """10 frames: the first through track_rgbd, then chunks of 4, 4 and a
    ragged tail of 1; the backward-flow spawn gate fires inside a chunk."""
    world = RefWorld(cam=CAM_REF, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line", billboard=True, bb_speed=0.04)
    ref, port, pr, pp = run_sequences(world, range(10), chunk=4)
    compare_sequences(ref, port, pr, pp, 10, 4)
    assert len(port.kf_log) >= 2
    assert (port.map.kf_obs == -2).any()
    np.testing.assert_allclose(np.asarray(ref.map.p_dyn), port.map.p_dyn.numpy(),
                               atol=1e-3)
