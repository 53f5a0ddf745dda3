"""The CRF's kNN graph and mean field with tracks sharded over the ranks of
an "edge" mesh (counterpart of lc_crf_slam_tpu/parallel/dist_crf.py).

Each rank owns a contiguous shard of the tracks: its rows of the
positions, validity, unaries and graph. The kNN graph is built row by row
against the all-gathered positions (the N x N distance work is what
scales); neighbours are global track ids. Each mean-field iteration
all-gathers the belief vector (one float per track), the halo of the
edges that cross shards. The update order and the fixed iteration count
are those of `models/crf.py`, which the results equal up to float order.
"""

from __future__ import annotations

import torch

from ..config import SLAMConfig
from ..models.crf import _smallest_k
from .mesh import Mesh, all_gather_rows, shard_bounds


def dist_knn_graph(cfg: SLAMConfig, xyz: torch.Tensor, ok: torch.Tensor,
                   mesh: Mesh):
    """Row-sharded fixed-degree kNN with Gaussian weights. xyz (n, 3) and
    ok (n,) are this rank's rows of N = n x mesh.size tracks; returns its
    rows (nbr (n, k) global track ids, w (n, k)), zero weight on invalid
    pairs. Neighbours are the k nearest in ascending distance, ties to the
    lower id (`lax.top_k`'s order, as `crf.knn_graph`)."""
    c = cfg.crf
    xyz_f = all_gather_rows(mesh, xyz)          # the column side: every track
    ok_f = all_gather_rows(mesh, ok)
    N = xyz_f.shape[0]
    k = min(c.knn, N - 1)
    row0, _ = shard_bounds(N, mesh)
    gids = row0 + torch.arange(xyz.shape[0], device=xyz.device)
    d2 = torch.sum(torch.square(xyz[:, None, :] - xyz_f[None, :, :]), dim=-1)
    d2 = torch.where(ok[:, None] & ok_f[None, :], d2, float("inf"))
    cols = torch.arange(N, device=xyz.device)
    d2 = torch.where(gids[:, None] == cols[None, :], float("inf"), d2)   # no self
    d2k, nbr = _smallest_k(d2, k)
    w = c.pairwise_weight * torch.exp(-d2k / (2.0 * c.spatial_sigma ** 2))
    return nbr, torch.where(torch.isfinite(d2k), w, 0.0)


def dist_mean_field(cfg: SLAMConfig, u_static, u_dyn, nbr, w, ok,
                    mesh: Mesh) -> torch.Tensor:
    """Track-sharded fixed-iteration two-label mean field. Every argument
    is this rank's rows (nbr holds global ids); each rank updates its own
    rows, and the one collective of an iteration is the all-gather of the
    belief vector. Returns the whole q_dyn (N,) on every rank."""
    q_l = torch.where(ok, 1.0 - cfg.crf.prior_static, 0.0)
    for _ in range(cfg.crf.mean_field_iters):
        q_f = all_gather_rows(mesh, q_l)
        msg_dyn = torch.sum(w * (1.0 - q_f)[nbr], dim=-1)
        msg_static = torch.sum(w * q_f[nbr], dim=-1)
        ls = -(u_static + msg_static)
        ld = -(u_dyn + msg_dyn)
        mx = torch.maximum(ls, ld)
        q = torch.exp(ld - mx) / (torch.exp(ls - mx) + torch.exp(ld - mx))
        q_l = torch.where(ok, q, 0.0)
    return all_gather_rows(mesh, q_l)
