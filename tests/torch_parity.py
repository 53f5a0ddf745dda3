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


def use_reference_draws(port) -> None:
    """Make a port SLAMSystem draw what the reference SLAMSystem draws:
    the audit's per-frame keys, and the relocalisation keys split off
    PRNGKey(7) one attempt at a time."""
    state = {"key": jax.random.PRNGKey(7)}

    def reloc_sampler():
        state["key"], sub = jax.random.split(state["key"])
        return reference_pnp_sampler(sub, batched=True)

    port._sampler = lambda: reference_consensus_sampler(int(port.ts.frame_idx))
    port._reloc_sampler = reloc_sampler


def reference_pnp_sampler(key, batched: bool = False):
    """A port `PnPSampler` that makes the reference pnp_ransac's draws
    (`randint(key, (n_hyp, 6), 0, max(n_valid, 1))`); `batched`: one key
    per candidate from `split(key, n)`, as relocalize splits its key."""
    from lc_crf_slam_tpu.ops.pnp import SAMPLE

    def sampler(n_valid: torch.Tensor, n_hyp: int):
        nv = np.atleast_1d(n_valid.cpu().numpy())
        keys = jax.random.split(key, len(nv)) if batched else [key]
        out = np.stack([np.asarray(jax.random.randint(
            k, (n_hyp, SAMPLE), 0, max(int(n), 1))) for k, n in zip(keys, nv)])
        out = out if batched else out[0]
        return torch.from_numpy(out.astype(np.int64)).to(n_valid.device)

    return sampler
