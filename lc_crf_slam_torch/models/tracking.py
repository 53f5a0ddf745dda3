"""Tracking: per-frame pose against the last frame and the local map
(counterpart of lc_crf_slam_tpu/models/tracking.py).

motion-model prediction -> projection-gated matching against the last
frame -> motion-only pose optimisation (with the reference-keyframe
fallback) -> local-map matching -> final pose optimisation -> capture-
resistance audit -> per-point statistics -> keyframe decision; and
keyframe insertion with depth-backed point spawning.

The reference's two `lax.cond`s (the reference-keyframe fallback and the
audit's re-polish) become "compute both, select with `torch.where`", so a
frame issues no host read. The audit's random draws come from `sampler`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from ..config import SLAMConfig
from .._ops import scatter_add, scatter_set, stable_topk, take_row
from ..geometry.camera import Pinhole
from ..geometry.se3 import orthonormalize_se3, se3_inverse
from ..ops.match import (
    hamming_matrix,
    match_nn,
    projection_gate,
    resolve_duplicates,
    rotation_consistency,
)
from ..utils.profiling import Sections, sections
from .ba import consensus_weights, pose_consensus, pose_optimize
from .capacities import LOCAL_POINTS
from .crf import masked_median
from .frame import Frame
from .mapstate import MapState, add_keyframe, add_points, near_dynamic_envelope

# (p (N,) sampling weights, n_hypotheses) -> (hyp_idx (n_hyp, 3), audit_u (N,))
Sampler = Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


class TrackState(NamedTuple):
    Tcw: torch.Tensor          # (4, 4) current camera pose (world->cam)
    vel: torch.Tensor          # (4, 4) constant-velocity model
    last_uv: torch.Tensor      # (K, 2) last frame features
    last_ur: torch.Tensor      # (K,)
    last_depth: torch.Tensor   # (K,)
    last_level: torch.Tensor   # (K,) int32
    last_angle: torch.Tensor   # (K,)
    last_desc: torch.Tensor    # (K, 8) int32
    last_valid: torch.Tensor   # (K,) bool
    last_obs: torch.Tensor     # (K,) int32 map point per last-frame feature
    frame_idx: torch.Tensor    # () int32 frames processed
    ref_kf: torch.Tensor       # () int32
    ref_matches: torch.Tensor  # () int32
    n_since_kf: torch.Tensor   # () int32
    status: torch.Tensor       # () int32: 0 uninit / 1 ok / 2 lost


class TrackInfo(NamedTuple):
    n_mm_matches: torch.Tensor
    n_inliers: torch.Tensor
    n_local_matches: torch.Tensor
    n_tracked_close: torch.Tensor
    n_untracked_close: torch.Tensor
    need_kf: torch.Tensor
    obs: torch.Tensor          # (K,) int32 final per-feature map-point ids
    inlier: torch.Tensor       # (K,) bool final per-feature inlier mask
    near_map: torch.Tensor     # (K,) bool feature on an existing point
    rescued: torch.Tensor      # () bool: the audit replaced the solve
    ref_fallback: torch.Tensor  # () bool: reference-keyframe path used


def empty_track_state(cfg: SLAMConfig, device: torch.device) -> TrackState:
    K = cfg.map.max_features
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    eye = torch.eye(4, dtype=f32, device=device)
    return TrackState(
        Tcw=eye, vel=eye.clone(),
        last_uv=full((K, 2), 0.0, f32),
        last_ur=full((K,), -1.0, f32),
        last_depth=full((K,), 0.0, f32),
        last_level=full((K,), 0, i32),
        last_angle=full((K,), 0.0, f32),
        last_desc=full((K, 8), 0, i32),
        last_valid=full((K,), False, torch.bool),
        last_obs=full((K,), -1, i32),
        frame_idx=full((), 0, i32),
        ref_kf=full((), 0, i32),
        ref_matches=full((), 0, i32),
        n_since_kf=full((), 0, i32),
        status=full((), 0, i32),
    )


def _depth_threshold(cam: Pinhole, cfg: SLAMConfig) -> float:
    """Close/far split: ThDepth * baseline."""
    return cfg.tracking.th_depth * cam.bf / cam.fx


def _unproject_world(cam: Pinhole, Twc, uv, depth):
    x = (uv[:, 0] - cam.cx) / cam.fx * depth
    y = (uv[:, 1] - cam.cy) / cam.fy * depth
    pc = torch.stack([x, y, depth], dim=-1)
    return pc @ Twc[:3, :3].T + Twc[:3, 3]


def _project_uv(cam: Pinhole, pc):
    z = torch.clamp(pc[:, 2], min=1e-6)
    return torch.stack(
        [cam.fx * pc[:, 0] / z + cam.cx, cam.fy * pc[:, 1] / z + cam.cy], dim=-1)


def _scale_radii(level, base: float, scale_factor: float):
    return base * scale_factor ** level.to(torch.float32)


def _point_scale_range(depth, level, n_levels: int, scale_factor: float):
    """MapPoint scale-invariance distances from creation depth + level."""
    max_dist = depth * scale_factor ** level.to(torch.float32)
    return max_dist / scale_factor ** (n_levels - 1), max_dist


def _ids(x: torch.Tensor) -> torch.Tensor:
    """Point ids (-1/-2 = none) as gather indices (negatives -> slot 0)."""
    return torch.clamp(x, min=0).long()


def initialize_map(cfg: SLAMConfig, cam: Pinhole, m: MapState, frame: Frame,
                   timestamp: torch.Tensor) -> Tuple[MapState, TrackState]:
    """StereoInitialization: the first frame becomes KF0 at identity and
    every keypoint with depth becomes a map point."""
    dev = frame.uv.device
    Tcw = torch.eye(4, dtype=torch.float32, device=dev)
    create = frame.valid & (frame.depth > 0)
    pw = _unproject_world(cam, Tcw, frame.uv, frame.depth)
    normal = -pw / torch.clamp(torch.linalg.norm(pw, dim=-1, keepdim=True), min=1e-9)
    min_d, max_d = _point_scale_range(
        torch.linalg.norm(pw, dim=-1), frame.level,
        cfg.orb.n_levels, cfg.orb.scale_factor)
    m, ids = add_points(
        m, pw, frame.desc, normal, min_d, max_d, create,
        torch.zeros((), dtype=torch.int32, device=dev),
        tomb_dyn_threshold=cfg.crf.dynamic_threshold, n_obs_init=0)
    m, kf_idx = add_keyframe(m, frame, Tcw, timestamp, ids)
    ts = empty_track_state(cfg, dev)._replace(
        Tcw=Tcw,
        last_uv=frame.uv, last_ur=frame.u_right, last_depth=frame.depth,
        last_level=frame.level, last_angle=frame.angle, last_desc=frame.desc,
        last_valid=frame.valid, last_obs=ids,
        ref_kf=kf_idx,
        ref_matches=torch.sum(ids >= 0, dtype=torch.int32),
        status=torch.ones((), dtype=torch.int32, device=dev),
    )
    return m, ts


def _select(cond, a, b):
    """Field-wise torch.where over two results of one NamedTuple type."""
    return type(a)(*[torch.where(cond, x, y) for x, y in zip(a, b)])


# the spans of track_step's sections, in order (utils/profiling.Sections)
SECTIONS = ("track.motion", "track.fallback", "track.local_map", "track.final",
            "track.audit", "track.point_stats", "track.kf_decision")


def track_step(cfg: SLAMConfig, cam: Pinhole, m: MapState, ts: TrackState,
               frame: Frame, sampler: Sampler
               ) -> Tuple[TrackState, MapState, TrackInfo]:
    """One tracking iteration: updated track state, map with updated
    point statistics, and per-frame info. Inside a `SLAMSystem` entry its
    seven sections are contiguous spans that cover its body (SECTIONS)."""
    with sections() as section:
        return _track_step(cfg, cam, m, ts, frame, sampler, section)


def _track_step(cfg: SLAMConfig, cam: Pinhole, m: MapState, ts: TrackState,
                frame: Frame, sampler: Sampler, section: Sections
                ) -> Tuple[TrackState, MapState, TrackInfo]:
    # ---- 1. match against last frame (motion model) ------------------------
    section("track.motion")
    mcfg = cfg.matcher
    dev = frame.uv.device
    T_pred = ts.vel @ ts.Tcw
    Twc_last = se3_inverse(ts.Tcw)
    pw_last = torch.where(
        (ts.last_obs >= 0)[:, None],
        m.p_xyz[_ids(ts.last_obs)],
        _unproject_world(cam, Twc_last, ts.last_uv, ts.last_depth))
    has3d = ts.last_valid & ((ts.last_obs >= 0) | (ts.last_depth > 0))
    pc_pred = pw_last @ T_pred[:3, :3].T + T_pred[:3, 3]
    uv_proj = _project_uv(cam, pc_pred)
    cand_ok = has3d & (pc_pred[:, 2] > 0.05)
    dist = hamming_matrix(frame.desc, ts.last_desc)

    def _motion_match(radius_mult):
        gate = projection_gate(
            frame.uv, uv_proj,
            _scale_radii(ts.last_level, radius_mult * mcfg.search_radius_motion,
                         cfg.orb.scale_factor),
            frame.level, ts.last_level, level_tolerance=1)
        gate &= frame.valid[:, None] & cand_ok[None, :]
        mm = match_nn(dist, mask=gate, max_dist=mcfg.th_high,
                      ratio=mcfg.nn_ratio_tracking)
        mm_valid = mm.valid
        if mcfg.check_orientation:
            mm_valid = rotation_consistency(
                frame.angle, ts.last_angle[mm.idx], mm_valid, mcfg.histo_bins)
        return mm, resolve_duplicates(mm.idx, mm.dist, mm_valid, frame.capacity)

    # retry with a doubled window when the first search finds too few
    mm_a, valid_a = _motion_match(1.0)
    mm_b, valid_b = _motion_match(2.0)
    use_wide = torch.sum(valid_a.to(torch.int32)) < 20
    mm = _select(use_wide, mm_b, mm_a)
    mm_valid = torch.where(use_wide, valid_b, valid_a)
    n_mm = torch.sum(mm_valid.to(torch.int32))

    pw_mm = pw_last[mm.idx]
    obs_mm = torch.where(mm_valid, ts.last_obs[mm.idx], -1)
    r1 = pose_optimize(cam, T_pred, pw_mm, frame.uv, frame.u_right, frame.level,
                       mm_valid, cfg.pose_opt, cfg.orb.scale_factor)
    T1 = r1.Tcw

    # ---- 1b. reference-keyframe fallback (both branches computed) ----------
    section("track.fallback")
    mm_failed = (n_mm < 20) | (r1.n_inliers < 10)
    kf = ts.ref_kf
    obs_ref = take_row(m.kf_obs, kf)
    valid_ref = take_row(m.kf_valid, kf) & (obs_ref >= 0)
    dist_r = hamming_matrix(frame.desc, take_row(m.kf_desc, kf))
    gate_r = frame.valid[:, None] & valid_ref[None, :]
    mr = match_nn(dist_r, mask=gate_r, max_dist=mcfg.th_low, ratio=0.7, mutual=True)
    mr_valid = mr.valid
    if mcfg.check_orientation:
        mr_valid = rotation_consistency(
            frame.angle, take_row(m.kf_angle, kf)[mr.idx], mr_valid, mcfg.histo_bins)
    mr_valid = resolve_duplicates(mr.idx, mr.dist, mr_valid, frame.capacity)
    obs_fb = torch.where(mr_valid, obs_ref[mr.idx], -1)
    val_fb = obs_fb >= 0
    rr = pose_optimize(cam, ts.Tcw, m.p_xyz[_ids(obs_fb)], frame.uv,
                       frame.u_right, frame.level, val_fb, cfg.pose_opt,
                       cfg.orb.scale_factor)
    use_fb = mm_failed & (rr.n_inliers >= 10)
    T1 = torch.where(use_fb, rr.Tcw, T1)
    obs_mm = torch.where(use_fb, obs_fb, obs_mm)
    mm_valid = torch.where(use_fb, val_fb, mm_valid)
    pw_mm = torch.where(use_fb, m.p_xyz[_ids(obs_fb)], pw_mm)

    # ---- 2. track local map ------------------------------------------------
    section("track.local_map")
    pc1 = m.p_xyz @ T1[:3, :3].T + T1[:3, 3]
    z1 = pc1[:, 2]
    uv1 = _project_uv(cam, pc1)
    dist_cam = torch.linalg.norm(m.p_xyz - se3_inverse(T1)[:3, 3][None, :], dim=-1)
    in_frustum = (
        m.p_alive
        & (z1 > 0.05)
        & (uv1[:, 0] >= 5) & (uv1[:, 0] < cam.width - 5)
        & (uv1[:, 1] >= 5) & (uv1[:, 1] < cam.height - 5)
        & (dist_cam >= 0.8 * m.p_min_dist)
        & (dist_cam <= 1.2 * m.p_max_dist)
        & (m.p_dyn < cfg.crf.dynamic_threshold)
    )
    # fixed-capacity local window: frustum points first, ties by index
    _, local_ids = stable_topk(in_frustum.to(torch.float32), LOCAL_POINTS)
    local_ok = in_frustum[local_ids]
    ratio = torch.clamp(m.p_max_dist[local_ids], min=1e-6) / torch.clamp(
        dist_cam[local_ids], min=1e-6)
    pred_level = torch.clamp(
        torch.ceil(torch.log(ratio) / math.log(cfg.orb.scale_factor)),
        0, cfg.orb.n_levels - 1).to(torch.int32)
    gate2 = projection_gate(
        frame.uv, uv1[local_ids],
        _scale_radii(pred_level, mcfg.search_radius_map, cfg.orb.scale_factor),
        frame.level, pred_level, level_tolerance=1)
    unmatched_q = ~(mm_valid & (obs_mm >= 0))
    gate2 &= (frame.valid & unmatched_q)[:, None] & local_ok[None, :]
    dist2 = hamming_matrix(frame.desc, m.p_desc[local_ids])
    lm = match_nn(dist2, mask=gate2, max_dist=mcfg.th_high, ratio=mcfg.nn_ratio_reloc)
    lm_valid = resolve_duplicates(lm.idx, lm.dist, lm.valid, LOCAL_POINTS)
    n_local = torch.sum(lm_valid.to(torch.int32))
    # duplicate guard for keyframe insertion: features on an existing
    # point's projection with compatible depth
    z_local = z1[local_ids]
    depth_compat = torch.abs(frame.depth[:, None] - z_local[None, :]) <= (
        0.15 * torch.clamp(frame.depth[:, None], min=0.3))
    near_gate = projection_gate(frame.uv, uv1[local_ids], 4.0)
    near_map = torch.any(near_gate & depth_compat & local_ok[None, :], dim=1) & frame.valid

    # ---- 3. final pose optimisation over the map associations --------------
    section("track.final")
    obs = torch.where(
        mm_valid & (obs_mm >= 0), obs_mm,
        torch.where(lm_valid, local_ids[lm.idx].to(torch.int32), -1))
    pw_fin = torch.where((obs >= 0)[:, None], m.p_xyz[_ids(obs)], pw_mm)
    assoc = (obs >= 0) & (m.p_dyn[_ids(obs)] < cfg.crf.dynamic_threshold)
    if cfg.crf.solve_flow_gate > 0:
        assoc &= m.p_flow_err[_ids(obs)] < cfg.crf.solve_flow_gate
    r2 = pose_optimize(cam, T1, pw_fin, frame.uv, frame.u_right, frame.level,
                       assoc, cfg.pose_opt, cfg.orb.scale_factor)

    # ---- 3b. capture-resistance audit (both branches computed) -------------
    section("track.audit")
    pcfg = cfg.pose_opt
    if pcfg.consensus_hypotheses > 0:
        pc_cam_q = torch.stack([
            (frame.uv[:, 0] - cam.cx) / cam.fx * frame.depth,
            (frame.uv[:, 1] - cam.cy) / cam.fy * frame.depth,
            frame.depth], dim=-1)
        valid3d = assoc & (frame.depth > 0)
        n3d = torch.sum(valid3d.to(torch.int32))
        obs_c = _ids(obs)
        trust = torch.where(
            obs >= 0,
            (1.0 + torch.log2(1.0 + torch.clamp(
                m.p_found[obs_c].to(torch.float32), max=64.0)))
            * (1.0 - m.p_dyn[obs_c]),
            1.0)
        hyp_idx, audit_u = sampler(consensus_weights(valid3d, trust),
                                   pcfg.consensus_hypotheses)
        T_hyp, s_hyp, s_lm, hyp_mask = pose_consensus(
            cam, r2.Tcw, pw_fin, pc_cam_q, frame.uv, frame.level, assoc,
            hyp_idx, audit_u,
            tight_chi2=pcfg.consensus_chi2, scale_factor=cfg.orb.scale_factor,
            audit_points=pcfg.consensus_audit_points, trust=trust)
        use_rescue = (s_hyp > pcfg.consensus_ratio * s_lm) & (
            n3d >= pcfg.consensus_min_3d)
        r_hyp = pose_optimize(cam, T_hyp, pw_fin, frame.uv, frame.u_right,
                              frame.level, assoc & hyp_mask, cfg.pose_opt,
                              cfg.orb.scale_factor)
        r3 = _select(use_rescue, r_hyp, r2)
    else:
        r3 = r2
        use_rescue = torch.zeros((), dtype=torch.bool, device=dev)
    T2 = orthonormalize_se3(r3.Tcw)
    inlier = r3.inliers
    n_inliers = torch.sum((inlier & (obs >= 0)).to(torch.int32))

    # ---- 4. per-point statistics (CRF evidence) ----------------------------
    section("track.point_stats")
    P = m.capacity_points
    pc2 = m.p_xyz @ T2[:3, :3].T + T2[:3, 3]
    z2 = pc2[:, 2]
    uv2 = _project_uv(cam, pc2)
    vis_ids = torch.where(local_ok, local_ids, P)
    m = m._replace(
        p_visible=scatter_add(m.p_visible, vis_ids, 1),
        p_last_seen=scatter_set(m.p_last_seen, vis_ids, ts.frame_idx + 1),
    )
    matched_pts = torch.where(inlier & (obs >= 0), obs, P)
    m = m._replace(p_found=scatter_add(m.p_found, matched_pts, 1))
    reproj_err = torch.linalg.norm(frame.uv - uv2[_ids(obs)], dim=-1)
    depth_err = torch.where(
        frame.depth > 0,
        torch.abs(frame.depth - z2[_ids(obs)]) / torch.clamp(frame.depth, min=1e-6),
        0.0)
    upd_ids = torch.where((obs >= 0) & frame.valid, obs, P)
    decay = cfg.crf.history_decay
    err_old = m.p_err_ema[_ids(obs)]
    derr_old = m.p_depth_err_ema[_ids(obs)]
    m = m._replace(
        p_err_ema=scatter_set(m.p_err_ema, upd_ids,
                              decay * err_old + (1 - decay) * reproj_err),
        p_depth_err_ema=scatter_set(m.p_depth_err_ema, upd_ids,
                                    decay * derr_old + (1 - decay) * depth_err),
    )
    # visible-but-not-found evidence, away from the image border
    assoc_mask = scatter_set(torch.zeros(P, dtype=torch.bool, device=dev),
                             upd_ids, True)
    bm = cfg.crf.miss_border_px
    uv_loc = uv2[local_ids]
    interior = (
        (uv_loc[:, 0] >= bm) & (uv_loc[:, 0] < cam.width - bm)
        & (uv_loc[:, 1] >= bm) & (uv_loc[:, 1] < cam.height - bm))
    missed = local_ok & interior & ~assoc_mask[local_ids]
    miss_ids = torch.where(missed, local_ids, P)
    err_miss_old = m.p_err_ema[local_ids]
    flow_floor = masked_median(m.p_flow_err, m.p_alive & (m.p_visible >= 4))
    corroborated = m.p_flow_err[local_ids] > torch.clamp(
        2.0 * flow_floor, min=cfg.crf.miss_corroborate_flow)
    miss_tgt = torch.where(corroborated, cfg.crf.miss_err, cfg.crf.miss_err_weak)
    m = m._replace(p_err_ema=scatter_set(
        m.p_err_ema, miss_ids, decay * err_miss_old + (1 - decay) * miss_tgt))

    # ---- 5. keyframe decision (RGB-D close-point rules) --------------------
    section("track.kf_decision")
    is_close = (frame.depth > 0) & (frame.depth < _depth_threshold(cam, cfg))
    tracked_close = inlier & (obs >= 0) & is_close
    untracked_close = frame.valid & is_close & ~tracked_close
    n_tc = torch.sum(tracked_close.to(torch.int32))
    n_uc = torch.sum(untracked_close.to(torch.int32))
    tcfg = cfg.tracking
    ok = n_inliers >= tcfg.min_inliers_ok
    need_close = (n_tc < tcfg.kf_min_close_tracked) & (n_uc > tcfg.kf_max_close_insertable)
    is_mono = cfg.sensor == "monocular"
    weak_ratio = tcfg.kf_ref_ratio_mono if is_mono else tcfg.kf_ref_ratio
    # nRefMatches is a live query of the reference KF's well-observed points
    ref_obs = take_row(m.kf_obs, ts.ref_kf)
    ref_min_obs = torch.where(m.n_kfs <= 2, 2, 3)
    ref_live = (
        (ref_obs >= 0)
        & take_row(m.kf_valid, ts.ref_kf)
        & m.p_alive[_ids(ref_obs)]
        & (m.p_n_obs[_ids(ref_obs)] >= ref_min_obs))
    n_ref_matches = torch.sum(ref_live.to(torch.int32))
    weak = n_inliers < (weak_ratio * n_ref_matches.to(torch.float32)).to(torch.int32)
    insertable = ok & (n_inliers > tcfg.kf_min_inliers_mono) if is_mono else ok
    need_kf = insertable & (
        (ts.n_since_kf >= tcfg.max_frames_between_kf) | need_close | weak
    ) & (ts.n_since_kf > tcfg.min_frames_between_kf)

    status = torch.where(ok, 1, 2).to(torch.int32)
    vel = T2 @ se3_inverse(ts.Tcw)
    ts2 = ts._replace(
        Tcw=T2,
        vel=torch.where(ok, vel, torch.eye(4, dtype=torch.float32, device=dev)),
        last_uv=frame.uv, last_ur=frame.u_right, last_depth=frame.depth,
        last_level=frame.level, last_angle=frame.angle, last_desc=frame.desc,
        last_valid=frame.valid,
        last_obs=obs,   # all map associations, outliers included
        frame_idx=ts.frame_idx + 1,
        n_since_kf=ts.n_since_kf + 1,
        status=status,
    )
    info = TrackInfo(
        n_mm_matches=n_mm,
        n_inliers=n_inliers,
        n_local_matches=n_local,
        n_tracked_close=n_tc,
        n_untracked_close=n_uc,
        need_kf=need_kf,
        obs=torch.where(inlier, obs, -1),
        inlier=inlier,
        near_map=near_map | (obs >= 0),
        rescued=use_rescue,
        ref_fallback=use_fb,
    )
    return ts2, m, info


def insert_keyframe(cfg: SLAMConfig, cam: Pinhole, m: MapState, ts: TrackState,
                    frame: Frame, obs: torch.Tensor, timestamp: torch.Tensor,
                    near_map: torch.Tensor | None = None,
                    flow_dyn: torch.Tensor | None = None,
                    ) -> Tuple[MapState, TrackState]:
    """CreateNewKeyFrame: insert the KF and spawn map points from depth for
    unmatched keypoints (dynamic-envelope veto, per-cell quota, then the
    nearest-first budget). `near_map` vetoes duplicates of existing points;
    `flow_dyn` vetoes keypoints whose optical flow departs from the rigid
    egomotion, and condemns them (-2) so triangulation cannot take them
    either."""
    Twc = se3_inverse(ts.Tcw)
    cand = frame.valid & (frame.depth > 0) & (obs < 0)
    if near_map is not None:
        cand &= ~near_map
    if flow_dyn is not None:
        cand &= ~flow_dyn
    pw = _unproject_world(cam, Twc, frame.uv, frame.depth)
    cand &= ~near_dynamic_envelope(
        m, pw, cfg.crf.dynamic_threshold, cfg.crf.spatial_sigma)
    K = frame.capacity
    dev = frame.uv.device
    if cfg.mapping.spawn_cell_quota > 0:
        cs = cfg.mapping.spawn_cell_px
        nx = -(-cam.width // cs)
        cell = (
            torch.clamp(frame.uv[:, 1] // cs, 0, (-(-cam.height // cs)) - 1) * nx
            + torch.clamp(frame.uv[:, 0] // cs, 0, nx - 1)
        ).to(torch.int32)
        same = cell[:, None] == cell[None, :]
        idx = torch.arange(K, device=dev)
        better = (
            (frame.depth[None, :] < frame.depth[:, None])
            | ((frame.depth[None, :] == frame.depth[:, None])
               & (idx[None, :] < idx[:, None])))
        rank = torch.sum(same & better & cand[None, :], dim=1)
        cand &= rank < cfg.mapping.spawn_cell_quota
    score = torch.where(cand, -frame.depth, -1e9)
    _, top_ids = stable_topk(score, cfg.mapping.max_new_points_per_kf)
    chosen = scatter_set(torch.zeros(K, dtype=torch.bool, device=dev), top_ids, True)
    create = cand & chosen
    d_vec = pw - Twc[:3, 3][None, :]
    dist = torch.linalg.norm(d_vec, dim=-1)
    normal = -d_vec / torch.clamp(dist[:, None], min=1e-9)
    min_d, max_d = _point_scale_range(
        dist, frame.level, cfg.orb.n_levels, cfg.orb.scale_factor)
    m, new_ids = add_points(
        m, pw, frame.desc, normal, min_d, max_d, create, ts.ref_kf + 1,
        tomb_dyn_threshold=cfg.crf.dynamic_threshold, n_obs_init=0)
    m = m._replace(p_last_seen=scatter_set(
        m.p_last_seen, torch.where(new_ids >= 0, new_ids, m.capacity_points),
        ts.frame_idx))
    obs_all = torch.where(obs >= 0, obs, new_ids)
    if flow_dyn is not None:
        obs_all = torch.where(flow_dyn & (obs_all == -1), -2, obs_all)
    m, kf_idx = add_keyframe(m, frame, ts.Tcw, timestamp, obs_all)
    # nRefMatches counts the new reference KF's well-observed points only
    min_obs = torch.where(m.n_kfs <= 2, 2, 3)
    n_obs_pts = m.p_n_obs[_ids(obs_all)]
    ts = ts._replace(
        ref_kf=kf_idx,
        ref_matches=torch.sum((obs_all >= 0) & (n_obs_pts >= min_obs), dtype=torch.int32),
        n_since_kf=torch.zeros((), dtype=torch.int32, device=dev),
        last_obs=obs_all,
    )
    return m, ts
