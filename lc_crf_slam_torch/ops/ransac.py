"""Batched-hypothesis RANSAC for 3D-3D alignment (counterpart of
lc_crf_slam_tpu/ops/ransac.py; Sim3Solver::iterate).

All hypotheses at once: minimal sets of three correspondences, a Horn /
Umeyama solve for each, inliers scored by 3D consistency against every
correspondence, and a weighted refit on the best hypothesis' inliers.

The minimal sets come from `sampler(p, n_hypotheses)`, which returns
(n_hypotheses, 3) indices drawn with replacement with probabilities `p`
(uniform over the valid correspondences): the pipeline draws them from a
`torch.Generator`, the parity tests pass the reference's `jax.random`
draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .._ops import take_row
from ..geometry.align import umeyama_alignment

MIN_SET = 3

# (p (N,) probabilities, n_hypotheses) -> (n_hypotheses, MIN_SET) int64
HornSampler = Callable[[torch.Tensor, int], torch.Tensor]


class RansacResult(NamedTuple):
    s: torch.Tensor          # () scale
    R: torch.Tensor          # (3, 3)
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def multinomial_sampler(generator: torch.Generator,
                        set_size: int = MIN_SET) -> HornSampler:
    """Sets of `set_size` indices ~ p with replacement from `generator`, on
    the device. An all-zero p (no valid correspondence) draws uniformly:
    every hypothesis then scores 0 inliers and the caller's gates reject
    it."""
    def sampler(p: torch.Tensor, n_hyp: int) -> torch.Tensor:
        safe = torch.where(torch.sum(p) > 0, p, torch.ones_like(p))
        return torch.multinomial(safe, n_hyp * set_size, replacement=True,
                                 generator=generator).reshape(n_hyp, set_size)
    return sampler


def horn_ransac(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                sampler: HornSampler, n_hypotheses: int = 256,
                inlier_tol: float = 0.10, fix_scale: bool = True) -> RansacResult:
    """Robust similarity dst ≈ s R src + t over the correspondences
    (src, dst (N, 3); valid (N,)); `inlier_tol` in metres."""
    p_valid = valid.to(torch.float32)
    p_valid = p_valid / torch.clamp(torch.sum(p_valid), min=1.0)
    idx = sampler(p_valid, n_hypotheses)                        # (H, 3)
    s_h, R_h, t_h = umeyama_alignment(src[idx], dst[idx], with_scale=not fix_scale)
    # score every hypothesis against every correspondence
    mapped = s_h[:, None, None] * torch.einsum("hij,nj->hni", R_h, src) + t_h[:, None, :]
    err = torch.linalg.norm(mapped - dst[None, :, :], dim=-1)  # (H, N)
    inl = (err < inlier_tol) & valid[None, :]
    best = torch.argmax(torch.sum(inl.to(torch.int32), dim=-1))  # first maximum
    # refit on the best inlier set
    w = take_row(inl, best).to(torch.float32)
    s, R, t = umeyama_alignment(src, dst, w=w, with_scale=not fix_scale)
    err = torch.linalg.norm(s * src @ R.T + t - dst, dim=-1)
    inliers = (err < inlier_tol) & valid
    return RansacResult(s=s, R=R, t=t, inliers=inliers,
                        n_inliers=torch.sum(inliers.to(torch.int32)))
