"""The JAX reference one frame at a time with XLA's backend optimisations
off, so that its float arithmetic runs op for op, as the port's does: the
unfused counterpart of tests/test_torch_loop_close.py's per-frame pan
world. The caller starts it in a fresh process with
XLA_FLAGS=--xla_backend_optimization_level=0 (JAX reads the flag at
start-up) and reads the npz it writes:

    python tests/ref_unfused_worker.py OUT.npz N_FRAMES
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from lc_crf_slam_tpu.config import SLAMConfig  # noqa: E402
from lc_crf_slam_tpu.models.system import SLAMSystem  # noqa: E402
from lc_crf_slam_tpu.utils.evaluate import evaluate_ate  # noqa: E402
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld  # noqa: E402

from torch_parity import CAM_REF, PAN_WORLD, render  # noqa: E402


def main(out: str, n: int) -> None:
    world = SyntheticWorld(cam=CAM_REF, n_frames=n, **PAN_WORLD)
    slam = SLAMSystem(CAM_REF, SLAMConfig(), enable_mapping=True, enable_crf=True)
    for k in range(n):
        gray, depth = render(world, k)
        slam.track_rgbd(gray, depth, k / 30.0)
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    stats = slam.stats[1:]
    np.savez(out, n_inliers=np.array([s["n_inliers"] for s in stats]),
             need_kf=np.array([bool(s["need_kf"]) for s in stats]),
             status=np.array([s["status"] for s in stats]),
             kf_log=np.array([(t, int(k)) for t, k in slam.kf_log], dtype=np.float64),
             loop_log=np.array([(a["kf"], a["cand"], a["inliers"]) for a in slam.loop_log],
                               dtype=np.int64).reshape(-1, 3),
             ate=evaluate_ate(ts, np.asarray(poses), gt_t, gt).rmse)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
