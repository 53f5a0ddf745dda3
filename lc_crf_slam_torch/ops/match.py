"""Batched binary-descriptor matching (counterpart of lc_crf_slam_tpu/ops/match.py).

Dense masked distance matrices over fixed-capacity descriptor sets, with
the reference's gates: nearest neighbour with ratio / mutual checks,
duplicate resolution, the 30-bin rotation histogram, projection windows.
Descriptors are (N, 8) int32 bit-views.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .._ops import as_value, popcount32, scatter_add, stable_topk

INVALID_DIST = 10_000


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances."""
    dist = torch.zeros((desc_a.shape[0], desc_b.shape[0]), dtype=torch.int32,
                       device=desc_a.device)
    for w in range(desc_a.shape[1]):
        dist += popcount32(desc_a[:, None, w] ^ desc_b[None, :, w])
    return dist


class MatchResult(NamedTuple):
    idx: torch.Tensor      # (N,) best candidate index in b
    dist: torch.Tensor     # (N,) best distance
    valid: torch.Tensor    # (N,) bool


def match_nn(dist: torch.Tensor, mask: Optional[torch.Tensor] = None,
             max_dist: int = 50, ratio: float = 1.0,
             mutual: bool = False) -> MatchResult:
    """Row-wise nearest neighbour with optional gate mask, Lowe ratio
    (best < ratio * second) and mutual-best checks; ties go to the lower
    candidate index, as `lax.top_k`."""
    d = dist if mask is None else torch.where(mask, dist, INVALID_DIST)
    top2, top2_idx = stable_topk(-d, 2)
    best = -top2[:, 0]
    second = -top2[:, 1]
    idx = top2_idx[:, 0]
    valid = best <= max_dist
    if ratio < 1.0:
        valid &= best.to(torch.float32) < ratio * second.to(torch.float32)
    if mutual:
        col_best = torch.argmin(d, dim=0)
        valid &= col_best[idx] == torch.arange(d.shape[0], device=d.device)
    return MatchResult(idx=idx, dist=best, valid=valid)


def resolve_duplicates(idx: torch.Tensor, dist: torch.Tensor,
                       valid: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """Keep only the lowest-distance row per candidate column (first row
    on exact ties). Returns the updated valid mask."""
    d = torch.where(valid, dist, INVALID_DIST)
    col_min = torch.full((n_candidates,), INVALID_DIST, dtype=d.dtype,
                         device=d.device).scatter_reduce(0, idx, d, "amin")
    keep = d <= col_min[idx]
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)
    first_row = torch.full((n_candidates,), n, dtype=rows.dtype,
                           device=idx.device).scatter_reduce(
        0, idx, torch.where(keep & valid, rows, n), "amin")
    return valid & keep & (rows == first_row[idx])


def rotation_consistency(angle_q: torch.Tensor, angle_c: torch.Tensor,
                         valid: torch.Tensor, n_bins: int = 30,
                         keep_top: int = 3) -> torch.Tensor:
    """Rotation-histogram filter: keep matches whose angle difference
    falls in the top-`keep_top` bins (secondary bins need >= 10% of the
    best bin's votes)."""
    two_pi = 2.0 * math.pi
    diff = torch.remainder(angle_q - angle_c, two_pi)
    bins = torch.clamp((diff * n_bins / two_pi).to(torch.int32), 0, n_bins - 1).long()
    counts = scatter_add(
        torch.zeros((n_bins,), dtype=torch.int32, device=valid.device),
        bins, valid.to(torch.int32))
    top_counts, top_bins = stable_topk(counts, keep_top)
    keep_bin = top_counts.to(torch.float32) >= 0.1 * top_counts[0].to(torch.float32)
    keep_bin &= top_counts > 0
    in_top = torch.any((bins[:, None] == top_bins[None, :]) & keep_bin[None, :], dim=-1)
    return valid & in_top


def projection_gate(uv_query: torch.Tensor, uv_proj: torch.Tensor, radius,
                    level_q: Optional[torch.Tensor] = None,
                    level_c: Optional[torch.Tensor] = None,
                    level_tolerance: int = 1) -> torch.Tensor:
    """(N, 2) query pixels vs (M, 2) projected candidates -> (N, M) bool;
    `radius` scalar or per-candidate (M,)."""
    d2 = torch.sum((uv_query[:, None, :] - uv_proj[None, :, :]) ** 2, dim=-1)
    r = as_value(radius, d2).expand(uv_proj.shape[0])
    gate = d2 <= (r * r)[None, :]
    if level_q is not None and level_c is not None:
        dl = torch.abs(level_q[:, None] - level_c[None, :])
        gate &= dl <= level_tolerance
    return gate
