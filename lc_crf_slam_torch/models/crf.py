"""CRF dynamic-point labeler (counterpart of lc_crf_slam_tpu/models/crf.py).

A two-label (static/dynamic) CRF over the recently observed map points:
unary energies from the per-point consistency evidence the tracker
accumulates (reprojection, depth and flow error EMAs, each normalised by
a self-calibrating noise floor), Potts pairwise terms over a fixed-degree
kNN graph with Gaussian spatial weights, and fixed-iteration mean-field
inference. q(dynamic) is written back to `MapState.p_dyn`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .._ops import scatter_set, stable_topk
from ..config import SLAMConfig
from .capacities import CRF_TRACKS, RECENCY_WINDOW
from .mapstate import MapState


class CRFInfo(NamedTuple):
    n_tracks: torch.Tensor
    n_dynamic: torch.Tensor
    mean_q: torch.Tensor


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask (upper median; 0 when mask is empty)."""
    s = torch.sort(torch.where(mask, x, float("inf"))).values
    n = torch.sum(mask.to(torch.int32))
    i = torch.clamp(n // 2, 0, x.shape[0] - 1).long()
    v = s.index_select(0, i.reshape(1))[0]
    return torch.where(n > 0, v, 0.0)


def noise_floors(cfg: SLAMConfig, m: MapState):
    """Per-cue effective sigmas: the configured sigma, or 1.5 × the median
    of the cue's EMA over mature alive tracks where that is larger."""
    c = cfg.crf
    mature = m.p_alive & (m.p_visible >= 4)
    reproj_s = torch.clamp(1.5 * masked_median(m.p_err_ema, mature), min=c.reproj_sigma)
    depth_s = torch.clamp(1.5 * masked_median(m.p_depth_err_ema, mature),
                          min=c.depth_sigma)
    flow_s = torch.clamp(1.5 * masked_median(m.p_flow_err, mature), min=c.flow_sigma)
    return reproj_s, depth_s, flow_s


def unary_energies(cfg: SLAMConfig, m: MapState, ids: torch.Tensor):
    """(static-label energy per track, dynamic-label energy): accumulated
    inconsistency per cue, clipped at 25, plus the label priors."""
    c = cfg.crf
    reproj_s, depth_s, flow_s = noise_floors(cfg, m)
    e_static = (
        c.w_reproj * torch.square(m.p_err_ema[ids] / reproj_s)
        + c.w_depth * torch.square(m.p_depth_err_ema[ids] / depth_s)
        + c.w_flow * torch.square(m.p_flow_err[ids] / flow_s)
    )
    u_static = torch.clamp(e_static, max=25.0) - math.log(c.prior_static)
    u_dyn = c.dynamic_bias - math.log(1.0 - c.prior_static)
    return u_static, torch.full_like(u_static, u_dyn)


def _smallest_k(d2: torch.Tensor, k: int):
    """Row-wise k smallest of non-negative d2 (inf allowed), ascending,
    ties to the lower column: `lax.top_k(-d2, k)` without a full sort.
    The float bits of a non-negative float32 order as its value, so
    bits × N + column is a unique key with the same order."""
    N = d2.shape[-1]
    key = d2.view(torch.int32).to(torch.int64) * N + torch.arange(N, device=d2.device)
    _, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return torch.gather(d2, -1, idx), idx


def knn_graph(cfg: SLAMConfig, xyz: torch.Tensor, ok: torch.Tensor):
    """Fixed-degree kNN over 3D positions with Gaussian weights:
    (nbr (N, k), w (N, k)), zero weight on invalid pairs."""
    c = cfg.crf
    N = xyz.shape[0]
    k = min(c.knn, N - 1)
    d2 = torch.sum(torch.square(xyz[:, None, :] - xyz[None, :, :]), dim=-1)
    d2 = torch.where(ok[:, None] & ok[None, :], d2, float("inf"))
    d2 = d2.fill_diagonal_(float("inf"))                # no self
    d2k, nbr = _smallest_k(d2, k)
    w = c.pairwise_weight * torch.exp(-d2k / (2.0 * c.spatial_sigma ** 2))
    return nbr, torch.where(torch.isfinite(d2k), w, 0.0)


def mean_field(cfg: SLAMConfig, u_static, u_dyn, nbr, w, ok) -> torch.Tensor:
    """Fixed-iteration two-label mean field; returns q_dyn (N,)."""
    q_dyn = torch.where(ok, 1.0 - cfg.crf.prior_static, 0.0)
    for _ in range(cfg.crf.mean_field_iters):
        q_static = 1.0 - q_dyn
        # Potts messages: the cost of disagreeing with the neighbours
        msg_dyn = torch.sum(w * q_static[nbr], dim=-1)
        msg_static = torch.sum(w * q_dyn[nbr], dim=-1)
        ls = -(u_static + msg_static)
        ld = -(u_dyn + msg_dyn)
        mx = torch.maximum(ls, ld)
        q = torch.exp(ld - mx) / (torch.exp(ls - mx) + torch.exp(ld - mx))
        q_dyn = torch.where(ok, q, 0.0)
    return q_dyn


def crf_step(cfg: SLAMConfig, m: MapState,
             frame_idx: torch.Tensor) -> Tuple[MapState, CRFInfo]:
    """Label the recently seen tracks and write q(dynamic) to the map."""
    recent = m.p_alive & ((frame_idx - m.p_last_seen) <= RECENCY_WINDOW) \
        & (m.p_visible >= 2)
    _, ids = stable_topk(recent.to(torch.float32), CRF_TRACKS)
    ok = recent[ids]
    u_static, u_dyn = unary_energies(cfg, m, ids)
    nbr, w = knn_graph(cfg, m.p_xyz[ids], ok)
    q_dyn = mean_field(cfg, u_static, u_dyn, nbr, w, ok)
    m = m._replace(p_dyn=scatter_set(m.p_dyn, torch.where(ok, ids, m.capacity_points),
                                     q_dyn))
    n_tracks = torch.sum(ok.to(torch.int32))
    info = CRFInfo(
        n_tracks=n_tracks,
        n_dynamic=torch.sum((ok & (q_dyn > cfg.crf.dynamic_threshold)).to(torch.int32)),
        mean_q=torch.sum(torch.where(ok, q_dyn, 0.0)) / torch.clamp(n_tracks, min=1),
    )
    return m, info
