"""Shared fixtures for the port's parity tests (tests/test_torch_*.py):
the small camera and configuration both packages run, rendered frames,
and the reference's own random draws for the consensus audit."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import LoopConfig, MapConfig, SLAMConfig
from lc_crf_slam_tpu.geometry.camera import Pinhole as RefPinhole
from lc_crf_slam_torch.geometry.camera import Pinhole

# 6 xdist workers share the machine
torch.set_num_threads(2)

# the QVGA camera of tests/test_tracking_e2e.py
QVGA = dict(fx=268.0, fy=270.0, cx=160.0, cy=120.0, width=320, height=240,
            bf=20.0)
CAM_REF = RefPinhole(**QVGA)
CAM = Pinhole(**QVGA)

# the slice: tracking + keyframe insertion, no loop closing; LOCAL_POINTS
# (4096) is a top-k over all points, so capacity must reach it
SLICE_CFG = SLAMConfig(loop=LoopConfig(enabled=False),
                       map=MapConfig(max_points=4096))


def render(world, k):
    f = world.frame(k, render=True)
    return f.image.astype(np.float32), f.depth_image.astype(np.float32)


def reference_consensus_sampler(frame_idx: int):
    """A port `Sampler` that makes the reference track_step's own draws
    (tracking.py: fold_in(PRNGKey(17), frame_idx), then pose_consensus's
    split into the hypothesis choice and the audit uniforms)."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), frame_idx)
    k_sample, k_audit = jax.random.split(key)

    def sampler(p: torch.Tensor, n_hyp: int):
        p_j = jnp.asarray(p.detach().cpu().numpy())
        n = p_j.shape[0]
        idx = jax.random.choice(k_sample, n, shape=(n_hyp, 3), p=p_j)
        u = jax.random.uniform(k_audit, (n,))
        return (torch.from_numpy(np.asarray(idx).astype(np.int64)).to(p.device),
                torch.from_numpy(np.array(u)).to(p.device))

    return sampler
