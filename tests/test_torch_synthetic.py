"""The port's numpy-only SyntheticWorld renders exactly the reference's
images and depth (bit-identical), for two seeds, with and without the
moving billboard."""

import numpy as np
import pytest

from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

from torch_parity import CAM, CAM_REF


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("billboard", [False, True])
def test_rendered_frames_bit_identical(seed, billboard):
    kw = dict(n_frames=4, n_static=300, n_dynamic=20, seed=seed,
              billboard=billboard)
    ref, port = RefWorld(cam=CAM_REF, **kw), SyntheticWorld(cam=CAM, **kw)
    for k in (0, 3):
        a, b = ref.frame(k, render=True), port.frame(k, render=True)
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.depth_image, b.depth_image)
        np.testing.assert_array_equal(a.T_cw, b.T_cw)
    np.testing.assert_array_equal(ref.groundtruth()[1], port.groundtruth()[1])
