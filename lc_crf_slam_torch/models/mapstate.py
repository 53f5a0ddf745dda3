"""The map as fixed-capacity structure-of-arrays tensors (counterpart of
lc_crf_slam_tpu/models/mapstate.py).

Same fields, shapes and semantics as the reference's `MapState`, so the
parity tests compare state array by array. Descriptors are int32
bit-views. Updates are functional (each returns a new `MapState`); the
`.at[idx](mode="drop")` writes go through the drop-mode helpers of
`_ops`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SLAMConfig
from .._ops import put_row, scatter_add, scatter_set, stable_topk, take_row
from ..ops.orb import unpack_bits
from .frame import Frame

TOMB_CAP = 512            # dynamic-tombstone ring capacity


class MapState(NamedTuple):
    # --- points (capacity P) ---
    p_xyz: torch.Tensor        # (P, 3) world position
    p_desc: torch.Tensor       # (P, 8) int32 representative descriptor
    p_normal: torch.Tensor     # (P, 3) mean viewing direction
    p_min_dist: torch.Tensor   # (P,) scale-invariance range
    p_max_dist: torch.Tensor   # (P,)
    p_visible: torch.Tensor    # (P,) int32 times predicted visible
    p_found: torch.Tensor      # (P,) int32 times actually matched
    p_first_kf: torch.Tensor   # (P,) int32 creating keyframe
    p_n_obs: torch.Tensor      # (P,) int32 keyframe observations
    p_dyn: torch.Tensor        # (P,) float32 P(dynamic)
    p_err_ema: torch.Tensor    # (P,) float32 reprojection error EMA
    p_depth_err_ema: torch.Tensor  # (P,) float32 depth-consistency EMA
    p_flow_err: torch.Tensor   # (P,) float32 short-term track error
    p_last_seen: torch.Tensor  # (P,) int32 frame index of last visibility
    p_alive: torch.Tensor      # (P,) bool
    # --- keyframes (capacity F, features K) ---
    kf_Tcw: torch.Tensor       # (F, 4, 4)
    kf_time: torch.Tensor      # (F,) float64 seconds (the reference: float32)
    kf_alive: torch.Tensor     # (F,) bool
    kf_uv: torch.Tensor        # (F, K, 2)
    kf_ur: torch.Tensor        # (F, K) virtual right coord (-1 = mono)
    kf_depth: torch.Tensor     # (F, K)
    kf_level: torch.Tensor     # (F, K) int32
    kf_angle: torch.Tensor     # (F, K)
    kf_desc: torch.Tensor      # (F, K, 8) int32
    kf_valid: torch.Tensor     # (F, K) bool
    kf_obs: torch.Tensor       # (F, K) int32 point id per feature (-1 none)
    kf_emb: torch.Tensor       # (F, 256) float32 retrieval embedding
    kf_anchor: torch.Tensor    # (F,) int32 anchor KF set at cull time (-1 alive)
    kf_Tca: torch.Tensor       # (F, 4, 4)
    # --- dynamic tombstones (ring buffer, capacity D) ---
    tomb_xyz: torch.Tensor     # (D, 3)
    tomb_valid: torch.Tensor   # (D,) bool
    tomb_n: torch.Tensor       # () int32 ring cursor
    # --- counters ---
    n_points: torch.Tensor     # () int32 high-water allocation mark
    n_kfs: torch.Tensor        # () int32

    @property
    def capacity_points(self) -> int:
        return self.p_xyz.shape[0]

    @property
    def capacity_kfs(self) -> int:
        return self.kf_Tcw.shape[0]


def empty_map(cfg: SLAMConfig, device: torch.device) -> MapState:
    P, F, K = cfg.map.max_points, cfg.map.max_keyframes, cfg.map.max_features
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    eye = torch.eye(4, dtype=f32, device=device)
    return MapState(
        p_xyz=full((P, 3), 0.0, f32),
        p_desc=full((P, 8), 0, i32),
        p_normal=full((P, 3), 0.0, f32),
        p_min_dist=full((P,), 0.0, f32),
        p_max_dist=full((P,), 1e9, f32),
        p_visible=full((P,), 1, i32),
        p_found=full((P,), 1, i32),
        p_first_kf=full((P,), 0, i32),
        p_n_obs=full((P,), 0, i32),
        p_dyn=full((P,), 0.0, f32),
        p_err_ema=full((P,), 0.0, f32),
        p_depth_err_ema=full((P,), 0.0, f32),
        p_flow_err=full((P,), 0.0, f32),
        p_last_seen=full((P,), 0, i32),
        p_alive=full((P,), False, torch.bool),
        kf_Tcw=eye.repeat(F, 1, 1),
        kf_time=full((F,), 0.0, torch.float64),
        kf_alive=full((F,), False, torch.bool),
        kf_uv=full((F, K, 2), 0.0, f32),
        kf_ur=full((F, K), -1.0, f32),
        kf_depth=full((F, K), 0.0, f32),
        kf_level=full((F, K), 0, i32),
        kf_angle=full((F, K), 0.0, f32),
        kf_desc=full((F, K, 8), 0, i32),
        kf_valid=full((F, K), False, torch.bool),
        kf_obs=full((F, K), -1, i32),
        kf_emb=full((F, 256), 0.0, f32),
        kf_anchor=full((F,), -1, i32),
        kf_Tca=eye.repeat(F, 1, 1),
        tomb_xyz=full((TOMB_CAP, 3), 0.0, f32),
        tomb_valid=full((TOMB_CAP,), False, torch.bool),
        tomb_n=full((), 0, i32),
        n_points=full((), 0, i32),
        n_kfs=full((), 0, i32),
    )


def _descriptor_embedding(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(K, 8) int32 -> (256,) centred, normalised mean-bit embedding."""
    bits = unpack_bits(desc).to(torch.float32)
    w = valid.to(torch.float32)[:, None]
    mean = torch.sum(bits * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    emb = mean - 0.5
    return emb / torch.clamp(torch.linalg.norm(emb), min=1e-6)


def obs_weight(u_right: torch.Tensor) -> torch.Tensor:
    """MapPoint::AddObservation weight: 2 with depth (virtual right
    coordinate present), 1 mono."""
    return torch.where(u_right >= 0, 2, 1).to(torch.int32)


def add_keyframe(m: MapState, frame: Frame, Tcw: torch.Tensor,
                 timestamp: torch.Tensor,
                 obs_point: torch.Tensor) -> Tuple[MapState, torch.Tensor]:
    """Insert a keyframe at the allocation cursor; past capacity the new
    KF is dropped. obs_point: (K,) int32 point id per feature (-1 none)."""
    f = torch.clamp(m.n_kfs, max=m.capacity_kfs - 1).long()
    in_cap = m.n_kfs < m.capacity_kfs

    def upd(arr, val):
        return put_row(arr, f, torch.where(in_cap, val, take_row(arr, f)))

    m = m._replace(
        kf_Tcw=upd(m.kf_Tcw, Tcw),
        kf_time=upd(m.kf_time, timestamp),
        kf_alive=upd(m.kf_alive, in_cap),
        kf_uv=upd(m.kf_uv, frame.uv),
        kf_ur=upd(m.kf_ur, frame.u_right),
        kf_depth=upd(m.kf_depth, frame.depth),
        kf_level=upd(m.kf_level, frame.level),
        kf_angle=upd(m.kf_angle, frame.angle),
        kf_desc=upd(m.kf_desc, frame.desc),
        kf_valid=upd(m.kf_valid, frame.valid),
        kf_obs=upd(m.kf_obs, torch.where(frame.valid, obs_point, -1)),
        kf_emb=upd(m.kf_emb, _descriptor_embedding(frame.desc, frame.valid)),
        n_kfs=m.n_kfs + in_cap.to(torch.int32),
    )
    obs = torch.where(in_cap & frame.valid & (obs_point >= 0), obs_point,
                      m.capacity_points)
    m = m._replace(p_n_obs=scatter_add(m.p_n_obs, obs, obs_weight(frame.u_right)))
    return m, f.to(torch.int32)


def add_points(
    m: MapState,
    xyz: torch.Tensor,        # (M, 3)
    desc: torch.Tensor,       # (M, 8) int32
    normal: torch.Tensor,     # (M, 3)
    min_dist: torch.Tensor,   # (M,)
    max_dist: torch.Tensor,   # (M,)
    create: torch.Tensor,     # (M,) bool: which rows allocate
    owner_kf: torch.Tensor,   # () int32
    tomb_dyn_threshold: float = 0.5,
    n_obs_init: int = 0,
) -> Tuple[MapState, torch.Tensor]:
    """Allocate up to M new points (virgin slots first, then dead ones,
    lowest index first); returns per-row ids (-1 where not created).
    Keyframe references to a recycled slot are condemned to -2, and
    recycled slots still serving the dynamic veto go to the tombstone ring."""
    P = m.capacity_points
    dev = xyz.device
    order = torch.cumsum(create.to(torch.int32), 0) - 1
    idx = torch.arange(P, device=dev)
    virgin = ~m.p_alive & (idx >= m.n_points)
    key = torch.where(virgin, 0, torch.where(m.p_alive, 2, 1))
    free = torch.sort(key, stable=True).indices
    n_free = P - torch.sum(m.p_alive.to(torch.int32))
    ok = create & (order < n_free)
    ids = torch.where(ok, free[torch.where(ok, order, 0).long()], -1).to(torch.int32)
    tgt = torch.where(ids >= 0, ids, P)
    recycled = scatter_set(torch.zeros(P, dtype=torch.bool, device=dev), tgt, True)
    stale = (m.kf_obs >= 0) & recycled[torch.clamp(m.kf_obs, min=0).long()]
    m = m._replace(kf_obs=torch.where(stale, -2, m.kf_obs))
    was_veto = recycled & (m.p_dyn > tomb_dyn_threshold) & (m.p_n_obs > 0)
    D = m.tomb_xyz.shape[0]
    t_order = torch.cumsum(was_veto.to(torch.int32), 0) - 1
    t_pos = torch.where(was_veto, (m.tomb_n + t_order) % D, D)
    m = m._replace(
        tomb_xyz=scatter_set(m.tomb_xyz, t_pos, m.p_xyz),
        tomb_valid=scatter_set(m.tomb_valid, t_pos, True),
        tomb_n=m.tomb_n + torch.sum(was_veto, dtype=torch.int32),
    )
    m = m._replace(
        p_xyz=scatter_set(m.p_xyz, tgt, xyz),
        p_desc=scatter_set(m.p_desc, tgt, desc),
        p_normal=scatter_set(m.p_normal, tgt, normal),
        p_min_dist=scatter_set(m.p_min_dist, tgt, min_dist),
        p_max_dist=scatter_set(m.p_max_dist, tgt, max_dist),
        p_first_kf=scatter_set(m.p_first_kf, tgt, owner_kf),
        p_n_obs=scatter_set(m.p_n_obs, tgt, n_obs_init),
        p_visible=scatter_set(m.p_visible, tgt, 1),
        p_found=scatter_set(m.p_found, tgt, 1),
        p_dyn=scatter_set(m.p_dyn, tgt, 0.0),
        p_err_ema=scatter_set(m.p_err_ema, tgt, 0.0),
        p_depth_err_ema=scatter_set(m.p_depth_err_ema, tgt, 0.0),
        p_flow_err=scatter_set(m.p_flow_err, tgt, 0.0),
        p_last_seen=scatter_set(m.p_last_seen, tgt, 0),
        p_alive=scatter_set(m.p_alive, tgt, True),
        n_points=torch.maximum(
            m.n_points, torch.max(torch.where(ids >= 0, ids + 1, 0))),
    )
    return m, ids


def incidence_matrix(m: MapState) -> torch.Tensor:
    """(F, P) float32 keyframe-point incidence from kf_obs (alive rows
    only), 0/1."""
    F, K = m.kf_obs.shape
    P = m.capacity_points
    cols = torch.where((m.kf_obs >= 0) & m.kf_valid & m.kf_alive[:, None],
                       m.kf_obs, P).long()
    A = torch.zeros((F, P + 1), dtype=torch.float32, device=cols.device)
    A.scatter_(1, cols, 1.0)
    return A[:, :P]


def covisibility(m: MapState) -> torch.Tensor:
    """(F, F) shared-point counts, diagonal zeroed (one matmul in place of
    KeyFrame::UpdateConnections). Exact: counts stay far below 2**24 and
    the port keeps TF32 off."""
    A = incidence_matrix(m)
    W = A @ A.T
    return W.fill_diagonal_(0.0)


def near_dynamic_envelope(m: MapState, xyz: torch.Tensor, dyn_threshold: float,
                          sigma: float) -> torch.Tensor:
    """(Q,) bool: query positions within `sigma` of a slot labelled
    dynamic that is still observed, or of a tombstone."""
    dyn_sel = (m.p_dyn > dyn_threshold) & (m.p_n_obs > 0)
    k = min(512, m.capacity_points)
    _, dyn_ids = stable_topk(dyn_sel.to(torch.float32), k)
    dyn_ok = dyn_sel[dyn_ids]
    d2 = torch.sum((xyz[:, None, :] - m.p_xyz[dyn_ids][None, :, :]) ** 2, dim=-1)
    near = torch.any((d2 <= sigma * sigma) & dyn_ok[None, :], dim=1)
    d2t = torch.sum((xyz[:, None, :] - m.tomb_xyz[None, :, :]) ** 2, dim=-1)
    return near | torch.any((d2t <= sigma * sigma) & m.tomb_valid[None, :], dim=1)


def observed_mask(m: MapState, kf_ids: torch.Tensor) -> torch.Tensor:
    """(P,) bool: the alive points observed by any of the given keyframes
    ((n,) indices padded with -1)."""
    obs = torch.where(kf_ids[:, None] >= 0,
                      m.kf_obs[torch.clamp(kf_ids, min=0).long()], -1)
    P = m.capacity_points
    mask = scatter_set(torch.zeros(P, dtype=torch.bool, device=obs.device),
                       torch.where(obs >= 0, obs, P).reshape(-1), True)
    return mask & m.p_alive


def scrub_dead_obs(m: MapState) -> MapState:
    """Condemn (-2) every keyframe observation of a dead slot. Not part
    of the pipeline, where such references persist on purpose (covisibility
    weight, feature blocking) until `add_points` recycles the slot: a test
    and maintenance utility. The sentinel is -2, not the free-feature -1:
    a culled point's features stay blocked from re-triangulation."""
    dead_ref = (m.kf_obs >= 0) & ~m.p_alive[torch.clamp(m.kf_obs, min=0).long()]
    return m._replace(kf_obs=torch.where(dead_ref, -2, m.kf_obs))
