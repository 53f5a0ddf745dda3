"""Local mapping (counterpart of lc_crf_slam_tpu/models/mapping.py).

The LocalMapping::Run body for one new keyframe, `mapping_step`:
triangulate new points against the best covisible neighbours, fuse
duplicates into the keyframe and its top neighbours, refresh the
representative descriptor, viewing normal and scale range of the local
points, local bundle adjustment over the covisibility window (5 + 10 LM
iterations with chi2 pruning between), point culling and keyframe
culling. Windows are fixed-capacity masked tables (capacities.py);
fusion re-points references with one gather instead of pointer surgery.

Local BA runs the port's one Schur assembly (ops/schur.py), which sums
every observation as the reference's TPU-tiled grid assembly, the one
the reference's local BA takes, does.

Nothing of a step waits on the device, so on a card the whole step
(~10k small kernels, the segment sum's look-back launches included: their
plans and zeroed scratch are made inside the step) is one CUDA graph,
captured once for each shape and set of settings it bakes in and replayed
at every keyframe: the same kernels in the same order, one launch from
the host instead of ~15k aten ops. The graph keeps the map in its own
buffers and hands them out, so the card holds one map, not three.
"""

from __future__ import annotations

import torch

from .._ops import (popcount32, put_row, scatter_add, scatter_max, scatter_min, scatter_set,
                    stable_topk, take_row)
from ..config import SLAMConfig
from ..geometry.camera import Pinhole
from ..geometry.se3 import se3_inverse
from ..ops.match import hamming_matrix, match_nn, projection_gate, resolve_duplicates
from ..ops.schur import BAProblem, solve_ba_with_outlier_rounds
from ..ops.triangulate import epipolar_gate, triangulate_pairs
from ..utils.cuda_graph import hand_in, replay_state
from .capacities import (BA_CAMS, BA_POINTS, REFRESH_KFS, REFRESH_POINTS,
                         TRIANG_CAP, TRIANG_NEIGHBORS)
from .mapstate import MapState, add_points, incidence_matrix, obs_weight

_INT32_MAX = 2 ** 31 - 1


def _ids(x: torch.Tensor) -> torch.Tensor:
    """Point ids (-1/-2 = none) as gather indices (negatives -> slot 0)."""
    return torch.clamp(x, min=0).long()


def _mark(n: int, idx: torch.Tensor, device) -> torch.Tensor:
    """(n,) bool, True at idx (indices out of [0, n) dropped)."""
    return scatter_set(torch.zeros(n, dtype=torch.bool, device=device), idx, True)


def _covis_row(m: MapState, kf_idx: torch.Tensor) -> torch.Tensor:
    """covisibility(m)[kf_idx] * kf_alive with kf_idx's own entry zeroed:
    the one row of A A^T the caller reads, with the same integer counts."""
    A = incidence_matrix(m)
    row = (A @ take_row(A, kf_idx)) * m.kf_alive
    return row.index_fill(0, kf_idx.reshape(1).long(), 0.0)


def _select_window(cfg: SLAMConfig, m: MapState, kf_idx: torch.Tensor):
    """Local KFs (covisibility-connected) + fixed observer KFs: (cam_ids
    (C,), cam_fixed (C,), point_ids (BA_POINTS,), point_ok)."""
    W = cfg.local_ba.max_local_kfs
    Ffix = min(cfg.local_ba.max_fixed_kfs, BA_CAMS - W)
    F, P = m.capacity_kfs, m.capacity_points
    dev = m.p_xyz.device
    w_top, nbr = stable_topk(_covis_row(m, kf_idx), W - 1)
    nbr_ok = w_top >= cfg.mapping.covisibility_min_weight
    local_ids = torch.cat([kf_idx.reshape(1).to(torch.int64), torch.where(nbr_ok, nbr, -1)])
    # the reference's dump slot is the live row F - 1, and the empty
    # neighbours (-1) sit at the tail: the last write wins, so at full
    # capacity keyframe F - 1 drops out of its own window, as there
    is_local = scatter_set(torch.zeros(F, dtype=torch.bool, device=dev),
                           torch.where(local_ids >= 0, local_ids, F - 1), local_ids >= 0)

    # points observed by the local window
    obs = torch.where(is_local[:, None] & m.kf_valid, m.kf_obs, -1).reshape(-1)
    pmask = _mark(P, obs, dev) & m.p_alive
    _, point_ids = stable_topk(pmask.to(torch.float32), BA_POINTS)
    point_ok = pmask[point_ids]

    # fixed observers: KFs seeing selected points but not local
    sel_mask = _mark(P, torch.where(point_ok, point_ids, P), dev)
    sel_ext = torch.cat([sel_mask, sel_mask.new_zeros(1)])
    sees = torch.sum(sel_ext[torch.where(m.kf_obs >= 0, m.kf_obs, P).long()]
                     & m.kf_valid, dim=1) * m.kf_alive
    sees = torch.where(is_local, 0, sees)
    f_top, fix_ids = stable_topk(sees.to(torch.float32), Ffix)
    fixed_ids = torch.where(f_top > 0, fix_ids, -1)

    cam_ids = torch.cat([local_ids, fixed_ids])
    # gauge: KF0 is never optimised
    cam_fixed = torch.cat([local_ids == 0,
                           torch.ones(Ffix, dtype=torch.bool, device=dev)])
    return cam_ids, cam_fixed | (cam_ids < 0), point_ids, point_ok


def _build_problem(cfg: SLAMConfig, m: MapState, cam_ids, cam_fixed, point_ids,
                   point_ok) -> BAProblem:
    C, K, P = cam_ids.shape[0], m.kf_obs.shape[1], m.capacity_points
    dev = m.p_xyz.device
    slot_of_point = scatter_set(
        torch.full((P + 1,), -1, dtype=torch.int64, device=dev),
        torch.where(point_ok, point_ids, P),
        torch.where(point_ok, torch.arange(BA_POINTS, device=dev), -1))
    kf_safe = torch.clamp(cam_ids, min=0)
    obs = m.kf_obs[kf_safe]                                   # (C, K)
    valid = (cam_ids >= 0)[:, None] & m.kf_valid[kf_safe] & (obs >= 0)
    pt_slot = slot_of_point[torch.where(valid, obs, P).long()]
    valid &= pt_slot >= 0
    e_cam = torch.arange(C, device=dev)[:, None].expand(C, K)
    inv_sigma2 = (1.0 / cfg.orb.scale_factor ** 2) ** m.kf_level[kf_safe].to(torch.float32)
    return BAProblem(
        cam_Tcw=m.kf_Tcw[kf_safe], cam_fixed=cam_fixed,
        p_xyz=m.p_xyz[point_ids], p_valid=point_ok,
        e_cam=e_cam.reshape(-1), e_pt=torch.clamp(pt_slot, min=0).reshape(-1),
        e_uv=m.kf_uv[kf_safe].reshape(-1, 2), e_ur=m.kf_ur[kf_safe].reshape(-1),
        e_w=inv_sigma2.reshape(-1), e_valid=valid.reshape(-1))


def local_bundle_adjustment(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                            kf_idx: torch.Tensor) -> MapState:
    """Optimizer::LocalBundleAdjustment: writes back poses and points and
    prunes the outlier observations."""
    cam_ids, cam_fixed, point_ids, point_ok = _select_window(cfg, m, kf_idx)
    prob = _build_problem(cfg, m, cam_ids, cam_fixed, point_ids, point_ok)
    lb = cfg.local_ba
    cam_out, p_out, keep, _ = solve_ba_with_outlier_rounds(
        cam, prob, iters_1=lb.outer_iters_1, iters_2=lb.outer_iters_2,
        huber_delta=lb.huber_delta, chi2_mono=lb.chi2_mono, chi2_stereo=lb.chi2_stereo)
    F, P = m.capacity_kfs, m.capacity_points
    upd_cam = ~cam_fixed & (cam_ids >= 0)
    m = m._replace(
        kf_Tcw=scatter_set(m.kf_Tcw, torch.where(upd_cam, cam_ids, F), cam_out),
        p_xyz=scatter_set(m.p_xyz, torch.where(point_ok, point_ids, P), p_out))
    # prune outlier observations, and their points' observation weights
    C, K = cam_ids.shape[0], m.kf_obs.shape[1]
    pruned = (prob.e_valid & ~keep).reshape(C, K)
    kf_safe = torch.clamp(cam_ids, min=0)
    old_rows = m.kf_obs[kf_safe]
    m = m._replace(kf_obs=scatter_set(m.kf_obs, torch.where(cam_ids >= 0, cam_ids, F),
                                      torch.where(pruned, -1, old_rows)))
    pruned_pts = torch.where(pruned, old_rows, -1).reshape(-1)
    return m._replace(p_n_obs=scatter_add(
        m.p_n_obs, torch.where(pruned_pts >= 0, pruned_pts, P),
        -obs_weight(m.kf_ur[kf_safe]).reshape(-1)))


def cull_points(cfg: SLAMConfig, m: MapState) -> MapState:
    """MapPointCulling: low found/visible ratio, too few observations
    while mature, or (CRF on) labelled dynamic. No tombstone here: a culled
    dynamic slot serves the spawn veto until add_points recycles it."""
    ratio = m.p_found.to(torch.float32) / torch.clamp(m.p_visible.to(torch.float32), min=1.0)
    bad_ratio = (ratio < cfg.mapping.cull_found_ratio) & (m.p_visible >= 4)
    mature = (m.n_kfs - m.p_first_kf) >= 2
    kill = bad_ratio | (mature & (m.p_n_obs < cfg.mapping.cull_min_obs))
    if cfg.crf.enabled:
        kill |= m.p_dyn > cfg.crf.dynamic_threshold
    return m._replace(p_alive=m.p_alive & ~kill)


def fuse_duplicates(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                    kf_idx: torch.Tensor, loop_mode: bool = False) -> MapState:
    """SearchInNeighbors/Fuse for one keyframe: project the visible points
    into it and find each one's best feature. A feature holding another
    point merges the two (the less-observed dies, every reference
    re-points, and a keyframe that would then see the survivor twice
    drops the extra entry); a free feature takes the point.

    `loop_mode` (SearchAndFuse after a loop correction): the survivor of a
    merge is the twin with the cleaner dynamic evidence (`p_dyn` apart by
    more than 0.1), the observation count deciding otherwise; the merge
    certifies both as one static structure whose statistics were gathered
    against drifted geometry, so the survivor's found/visible ratio is
    reset and it takes the lower of the twins' evidence EMAs."""
    P, F, K = m.capacity_points, m.capacity_kfs, m.kf_obs.shape[1]
    dev = m.p_xyz.device
    Tcw = take_row(m.kf_Tcw, kf_idx)
    pc = m.p_xyz @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    zs = torch.clamp(z, min=1e-6)
    uvp = torch.stack([cam.fx * pc[:, 0] / zs + cam.cx,
                       cam.fy * pc[:, 1] / zs + cam.cy], dim=-1)
    vis = (m.p_alive & (z > 0.05) & (uvp[:, 0] >= 0) & (uvp[:, 0] < cam.width)
           & (uvp[:, 1] >= 0) & (uvp[:, 1] < cam.height))
    _, cand_ids = stable_topk(vis.to(torch.float32), BA_POINTS)
    cand_ok = vis[cand_ids]

    f_uv, f_desc = take_row(m.kf_uv, kf_idx), take_row(m.kf_desc, kf_idx)
    f_valid, f_obs = take_row(m.kf_valid, kf_idx), take_row(m.kf_obs, kf_idx)
    f_depth = take_row(m.kf_depth, kf_idx)
    # project each candidate point and find its best feature
    gate = projection_gate(uvp[cand_ids], f_uv, 2.5)
    gate &= cand_ok[:, None] & f_valid[None, :]
    dc = torch.abs(f_depth[None, :] - z[cand_ids][:, None]) <= 0.2 * torch.clamp(
        f_depth[None, :], min=0.5)
    gate &= torch.where((f_depth > 0)[None, :], dc, True)
    dist = torch.where(gate, hamming_matrix(m.p_desc[cand_ids], f_desc), 10_000)
    best_f = torch.argmin(dist, dim=1)                        # first minimum
    best_d = torch.gather(dist, 1, best_f[:, None])[:, 0]
    good = (best_d <= cfg.matcher.th_low) & cand_ok
    existing = f_obs[best_f]

    # case 1: the feature holds a different, alive point -> merge, the
    # more-observed survives; one merge per dup point per pass
    mergeable = good & (existing >= 0) & (existing != cand_ids) & m.p_alive[_ids(existing)]
    a = torch.where(mergeable, existing.long(), 0)
    b = torch.where(mergeable, cand_ids, 0)
    keep_b = m.p_n_obs[b] >= m.p_n_obs[a]
    if loop_mode:
        pd_a, pd_b = m.p_dyn[a], m.p_dyn[b]
        keep_b = torch.where(torch.abs(pd_b - pd_a) > 0.1, pd_b < pd_a, keep_b)
    dup = torch.where(mergeable, torch.where(keep_b, a, b), -1)
    tgt = torch.where(mergeable, torch.where(keep_b, b, a), -1)
    L = dup.shape[0]
    rowi = torch.arange(L, device=dev)
    first_row = scatter_min(torch.full((P + 1,), L, dtype=torch.int64, device=dev),
                            torch.where(dup >= 0, dup, P),
                            torch.where(dup >= 0, rowi, L))
    keep_row = (dup < 0) | (first_row[_ids(dup)] == rowi)
    dup = torch.where(keep_row, dup, -1)
    tgt = torch.where(keep_row, tgt, -1)
    # point id -> post-merge id; slot P (no point) -> -1
    replace_map = torch.cat([
        scatter_set(torch.arange(P, device=dev), torch.where(dup >= 0, dup, P), tgt),
        torch.full((1,), -1, dtype=torch.int64, device=dev)])
    obs_ok = m.kf_obs >= 0
    survivor = torch.where(obs_ok, replace_map[torch.where(obs_ok, m.kf_obs, P).long()],
                           m.kf_obs.long())
    # MapPoint::Replace: a re-pointed entry in a keyframe that already
    # observes the survivor is erased, and of several entries of one
    # keyframe re-pointed to one survivor only the first stays
    inc = incidence_matrix(m)                                 # pre-repoint
    repointed = obs_ok & (survivor != m.kf_obs)
    already = torch.gather(inc, 1, _ids(survivor)) > 0
    fgrid = torch.arange(K, device=dev)[None, :].expand(F, K)
    base = torch.arange(F, device=dev)[:, None] * (P + 1)
    first_feat = scatter_min(
        torch.full((F * (P + 1),), K, dtype=torch.int64, device=dev),
        (base + torch.where(repointed, survivor, P)).reshape(-1),
        torch.where(repointed, fgrid, K).reshape(-1))
    intra_dup = repointed & (first_feat[base + _ids(survivor)] != fgrid)
    erase = repointed & (already | intra_dup)
    new_kf_obs = torch.where(erase, -1, survivor).to(torch.int32)
    w_all = obs_weight(m.kf_ur)
    erased_w = scatter_add(torch.zeros(P + 1, dtype=torch.int32, device=dev),
                           torch.where(erase, _ids(survivor), P).reshape(-1),
                           torch.where(erase, w_all, 0).reshape(-1))
    gained = scatter_add(torch.zeros(P + 1, dtype=torch.int32, device=dev),
                         torch.where(dup >= 0, tgt, P),
                         torch.where(dup >= 0, m.p_n_obs[_ids(dup)], 0))
    m = m._replace(
        kf_obs=new_kf_obs,
        p_alive=scatter_set(m.p_alive, torch.where(dup >= 0, dup, P), False),
        p_n_obs=m.p_n_obs + gained[:P] - erased_w[:P])
    if loop_mode:
        dup_s, tgt_m = _ids(dup), torch.where(dup >= 0, tgt, P)

        def _emin(arr):
            # (the reference chains a second .min with the survivor's own
            # value, which the first already bounds)
            return scatter_min(arr, tgt_m, arr[dup_s])

        m = m._replace(
            p_visible=scatter_set(m.p_visible, tgt_m, 1),
            p_found=scatter_set(m.p_found, tgt_m, 1),
            p_dyn=_emin(m.p_dyn),
            p_err_ema=_emin(m.p_err_ema),
            p_depth_err_ema=_emin(m.p_depth_err_ema),
            p_flow_err=_emin(m.p_flow_err),
            p_last_seen=scatter_max(m.p_last_seen, tgt_m, m.p_last_seen[dup_s]))

    # case 2: the feature is free (-1; condemned -2 stays blocked) -> attach
    # the point, unless this keyframe already observes it
    surv_cand = replace_map[cand_ids]
    row_now = take_row(m.kf_obs, kf_idx)
    member = torch.cat([_mark(P, torch.where(row_now >= 0, row_now, P), dev),
                        torch.zeros(1, dtype=torch.bool, device=dev)])
    addable = good & (existing == -1) & ~member[torch.clamp(surv_cand, 0, P)]
    # collisions (two points claim one feature): the lowest distance wins
    claim_d = scatter_min(torch.full((K,), 10_000, dtype=torch.int32, device=dev),
                          torch.where(addable, best_f, K - 1),
                          torch.where(addable, best_d, 10_000))
    win = addable & (best_d <= claim_d[best_f])
    add_pt = torch.where(win, replace_map[torch.where(win, cand_ids, P)], -1)
    # ... and one feature per point
    first2 = scatter_min(torch.full((P + 1,), L, dtype=torch.int64, device=dev),
                         torch.where(add_pt >= 0, add_pt, P),
                         torch.where(add_pt >= 0, rowi, L))
    win &= (add_pt < 0) | (first2[torch.clamp(add_pt, 0, P)] == rowi)
    add_pt = torch.where(win, add_pt, -1)
    claimed = scatter_set(torch.full((K,), -1, dtype=torch.int64, device=dev),
                          torch.where(win, best_f, K), add_pt)
    attached = (row_now == -1) & (claimed >= 0)
    return m._replace(
        kf_obs=put_row(m.kf_obs, kf_idx, torch.where(attached, claimed, row_now)),
        p_n_obs=scatter_add(m.p_n_obs, torch.where(attached, claimed, P),
                            obs_weight(take_row(m.kf_ur, kf_idx))))


def cull_keyframes(cfg: SLAMConfig, m: MapState, kf_idx: torch.Tensor) -> MapState:
    """KeyFrameCulling over the covisible neighbours of kf_idx: a KF dies
    when >= 90% of its observed points are seen by >= 3 keyframes (counts
    from the incidence matrix); its pose is anchored to kf_idx."""
    row = _covis_row(m, kf_idx)
    _, nbrs = stable_topk(row, cfg.local_ba.max_local_kfs)
    nbr_ok = (row[nbrs] >= cfg.mapping.covisibility_min_weight) & (nbrs != 0)
    obs = m.kf_obs[nbrs]
    valid = m.kf_valid[nbrs] & (obs >= 0)
    n_seen = torch.sum(incidence_matrix(m), dim=0)[_ids(obs)]
    redundant = valid & (n_seen >= 3.0)
    n_valid = torch.sum(valid.to(torch.int32), dim=1)
    frac = torch.sum(redundant.to(torch.int32), dim=1) / torch.clamp(n_valid, min=1)
    kill = nbr_ok & (frac >= cfg.mapping.kf_cull_redundancy) & (n_valid > 20)
    F, P = m.capacity_kfs, m.capacity_points
    tgt = torch.where(kill, nbrs, F)
    Tca = m.kf_Tcw[nbrs] @ se3_inverse(take_row(m.kf_Tcw, kf_idx))
    m = m._replace(
        kf_alive=scatter_set(m.kf_alive, tgt, False),
        kf_anchor=scatter_set(m.kf_anchor, tgt, kf_idx),
        kf_Tca=scatter_set(m.kf_Tca, tgt, Tca))
    dead_obs = torch.where(kill[:, None] & valid, obs, -1).reshape(-1)
    return m._replace(p_n_obs=scatter_add(
        m.p_n_obs, torch.where(dead_obs >= 0, dead_obs, P),
        -obs_weight(m.kf_ur[nbrs]).reshape(-1)))


def _triang_neighbors(cfg: SLAMConfig) -> int:
    n = cfg.mapping.triang_neighbors
    return n if n > 0 else TRIANG_NEIGHBORS


def create_new_points(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                      kf_idx: torch.Tensor) -> MapState:
    """CreateNewMapPoints: epipolar-gated matching of the keyframe's free
    features against each of its best covisible neighbours, midpoint
    triangulation with the reference's checks, at most TRIANG_CAP new
    points per pair (lowest descriptor distance first), observations
    recorded in both keyframes."""
    K, P = m.kf_obs.shape[1], m.capacity_points
    dev = m.p_xyz.device
    row = _covis_row(m, kf_idx)
    _, nbrs = stable_topk(row, _triang_neighbors(cfg))
    nbr_ok_all = row[nbrs] >= cfg.mapping.covisibility_min_weight
    uv1, desc1 = take_row(m.kf_uv, kf_idx), take_row(m.kf_desc, kf_idx)
    lvl1 = take_row(m.kf_level, kf_idx)
    valid1 = take_row(m.kf_valid, kf_idx)
    ur1 = take_row(m.kf_ur, kf_idx)
    # free = never observed (-1); condemned features (-2) stay blocked
    free1 = valid1 & (take_row(m.kf_obs, kf_idx) == -1)
    T1 = take_row(m.kf_Tcw, kf_idx)
    c1 = se3_inverse(T1)[:3, 3]
    sf = cfg.orb.scale_factor
    for n in range(nbrs.shape[0]):
        nb = nbrs[n]
        uv2 = take_row(m.kf_uv, nb)
        free2 = take_row(m.kf_valid, nb) & (take_row(m.kf_obs, nb) == -1)
        T2 = take_row(m.kf_Tcw, nb)
        baseline = torch.linalg.norm(c1 - se3_inverse(T2)[:3, 3])
        ok_nb = nbr_ok_all[n] & (baseline > 0.01)
        gate = epipolar_gate(cam, T1, T2, uv1, uv2) & free1[:, None] & free2[None, :]
        mm = match_nn(hamming_matrix(desc1, take_row(m.kf_desc, nb)), mask=gate,
                      max_dist=cfg.matcher.th_low, ratio=0.75, mutual=True)
        mv = resolve_duplicates(mm.idx, mm.dist, mm.valid, K)
        tri = triangulate_pairs(cam, T1, T2, uv1, uv2[mm.idx], mv & ok_nb, lvl1, sf)
        score = torch.where(tri.ok, -mm.dist.to(torch.float32), -1e9)
        _, top = stable_topk(score, TRIANG_CAP)
        create = tri.ok & _mark(K, top, dev)
        dvec = tri.xyz - c1[None, :]
        dist_c = torch.linalg.norm(dvec, dim=-1)
        normal = -dvec / torch.clamp(dist_c[:, None], min=1e-9)
        max_d = dist_c * sf ** lvl1.to(torch.float32)
        min_d = max_d / sf ** (cfg.orb.n_levels - 1)
        m, new_ids = add_points(m, tri.xyz, desc1, normal, min_d, max_d, create,
                                kf_idx, tomb_dyn_threshold=cfg.crf.dynamic_threshold,
                                n_obs_init=0)
        got = new_ids >= 0
        m = m._replace(kf_obs=put_row(
            m.kf_obs, kf_idx, torch.where(got, new_ids, take_row(m.kf_obs, kf_idx))))
        feat2 = torch.where(got, mm.idx, K)
        row2 = scatter_set(take_row(m.kf_obs, nb), feat2, torch.where(got, new_ids, -1))
        w_both = obs_weight(ur1) + obs_weight(take_row(m.kf_ur, nb)[torch.clamp(feat2, max=K - 1)])
        m = m._replace(kf_obs=put_row(m.kf_obs, nb, row2),
                       p_n_obs=scatter_add(m.p_n_obs, torch.where(got, new_ids, P), w_both))
        free1 = valid1 & (take_row(m.kf_obs, kf_idx) == -1)
    return m


def refresh_point_stats(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                        kf_idx: torch.Tensor) -> MapState:
    """ComputeDistinctiveDescriptors + UpdateNormalAndDepth over the local
    window: each point observed by the keyframe or its REFRESH_KFS - 1
    closest covisible keyframes takes the observation descriptor with the
    least summed Hamming distance to the others, the mean viewing
    direction, and the scale range of its first window observation."""
    W, Np, P = REFRESH_KFS, REFRESH_POINTS, m.capacity_points
    dev = m.p_xyz.device
    w_top, nbrs = stable_topk(_covis_row(m, kf_idx), W - 1)
    kfs = torch.cat([kf_idx.reshape(1).to(torch.int64), torch.where(w_top > 0, nbrs, -1)])
    kf_safe = torch.clamp(kfs, min=0)
    obs = m.kf_obs[kf_safe]                                   # (W, K)
    ovalid = (kfs >= 0)[:, None] & m.kf_valid[kf_safe] & (obs >= 0)

    # local point set = points observed in the window
    pmask = _mark(P, torch.where(ovalid, obs, P).reshape(-1), dev) & m.p_alive
    _, pids = stable_topk(pmask.to(torch.float32), Np)
    pok = pmask[pids]
    slot_of = scatter_set(torch.full((P + 1,), Np, dtype=torch.int64, device=dev),
                          torch.where(pok, pids, P),
                          torch.where(pok, torch.arange(Np, device=dev), Np))
    # one row per window keyframe: a point is observed once per keyframe
    slots = torch.where(ovalid, slot_of[torch.where(ovalid, obs, P).long()], Np)
    flat = (torch.arange(W, device=dev)[:, None] * (Np + 1) + slots).reshape(-1)

    def table(vals, fill_shape, dtype):
        # a keyframe that observes a point twice writes its slot twice:
        # the last write wins (`scatter_set`), on the card too
        out = torch.zeros((W * (Np + 1),) + fill_shape, dtype=dtype, device=dev)
        out = scatter_set(out, flat, vals.reshape((-1,) + fill_shape).to(dtype))
        return out.reshape((W, Np + 1) + fill_shape)[:, :Np]

    descs = table(m.kf_desc[kf_safe], (8,), torch.int32)
    levels = table(m.kf_level[kf_safe], (), torch.int32)
    has = table(slots < Np, (), torch.bool)
    centers_w = se3_inverse(m.kf_Tcw[kf_safe])[:, :3, 3]       # (W, 3)
    n_got = torch.sum(has.to(torch.int32), dim=0)

    # representative descriptor: least summed Hamming distance to the
    # point's other observations
    d = torch.sum(popcount32(descs[:, None] ^ descs[None, :]), dim=-1)   # (W, W, Np)
    pair_ok = has[:, None, :] & has[None, :, :]
    dsum = torch.sum(torch.where(pair_ok, d, 0), dim=1)
    dsum = torch.where(has, dsum, _INT32_MAX)
    rep = torch.argmin(dsum, dim=0)                            # first minimum
    ar = torch.arange(Np, device=dev)
    rep_desc = descs[rep, ar]

    # viewing normal: mean of unit point->camera directions
    pw = m.p_xyz[pids]
    dirs = centers_w[:, None, :] - pw[None, :, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    normal = torch.sum(torch.where(has[:, :, None], dirs, 0.0), dim=0)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)

    # scale-invariance range from the first observing window keyframe
    first_w = torch.argmax(has.to(torch.uint8), dim=0)
    dist0 = torch.linalg.norm(pw - centers_w[first_w], dim=-1)
    max_d = dist0 * cfg.orb.scale_factor ** levels[first_w, ar].to(torch.float32)
    min_d = max_d / cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)

    tgt = torch.where(pok & (n_got >= 2), pids, P)
    return m._replace(
        p_desc=scatter_set(m.p_desc, tgt, rep_desc),
        p_normal=scatter_set(m.p_normal, tgt, normal),
        p_min_dist=scatter_set(m.p_min_dist, tgt, min_d),
        p_max_dist=scatter_set(m.p_max_dist, tgt, max_d))


# the map fields `_mapping_step` never reads: meta placeholders in a
# capture (which no op on the card takes), passed through
_UNREAD = frozenset({"kf_time", "kf_angle", "kf_emb"})
_UNREAD_AT = frozenset(i for i, name in enumerate(MapState._fields) if name in _UNREAD)

# captured mapping steps by `_graph_key` (and the float settings,
# `utils/cuda_graph.replay_state`)
_GRAPHS: dict = {}


def _graph_key(cfg: SLAMConfig, cam: Pinhole, m: MapState, kf_idx: torch.Tensor):
    """What a captured step bakes in: the camera, the settings
    `_mapping_step` reads (scalars of its kernels and its loop counts),
    and each map field's and `kf_idx`'s shape, dtype and device."""
    return (cam, cfg.mapping, cfg.local_ba, cfg.matcher.th_low, cfg.orb.scale_factor,
            cfg.orb.n_levels, cfg.crf.enabled, cfg.crf.dynamic_threshold,
            tuple((tuple(t.shape), t.dtype, t.device) for t in (*m, kf_idx)))


def mapping_step(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                 kf_idx: torch.Tensor) -> MapState:
    """LocalMapping::Run for one keyframe: triangulate -> fuse (the
    keyframe, then its top covisible neighbours) -> point maintenance ->
    local BA -> cull points -> cull keyframes.

    On a card, outside a capture, the step is a CUDA graph that updates
    the map it reads in place (`utils/cuda_graph.replay_state`, spans
    `mapping.capture` / `mapping.replay`): each call copies in the fields
    it reads that changed since the last call, replays, and returns the
    graph's map beside the caller's own fields of `_UNREAD`; a map an
    earlier call returned keeps its values. Elsewhere it runs eagerly, op
    by op."""
    if kf_idx.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return _mapping_step(cfg, cam, m, kf_idx)
    return replay_state(_GRAPHS, _graph_key(cfg, cam, m, kf_idx), "mapping",
                        lambda *t: _mapping_step(cfg, cam, MapState(*t[:-1]), t[-1]),
                        (*m, kf_idx), unread=_UNREAD_AT)


def adopt(cfg: SLAMConfig, cam: Pinhole, m: MapState, kf_idx: torch.Tensor) -> MapState:
    """A map made outside `mapping_step` (a new session's), moved into the
    buffers of its captured step on a card (`utils/cuda_graph.hand_in`),
    so the card does not hold it beside the graph's stale one until the
    next keyframe; `m` itself where no step of its key was captured."""
    if kf_idx.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return m
    got = hand_in(_GRAPHS, _graph_key(cfg, cam, m, kf_idx), "mapping", (*m, kf_idx))
    return m if got is None else got


def _mapping_step(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                  kf_idx: torch.Tensor) -> MapState:
    """`mapping_step`, op by op."""
    m = create_new_points(cfg, cam, m, kf_idx)
    m = fuse_duplicates(cfg, cam, m, kf_idx)
    n_rev = cfg.mapping.fuse_reverse_neighbors
    if n_rev > 0:
        w_top, nbrs = stable_topk(_covis_row(m, kf_idx), n_rev)
        for i in range(n_rev):
            # an empty neighbour slot re-fuses the keyframe itself (a no-op)
            ok = w_top[i] >= cfg.mapping.covisibility_min_weight
            m = fuse_duplicates(cfg, cam, m, torch.where(ok, nbrs[i], kf_idx.long()))
    m = refresh_point_stats(cfg, cam, m, kf_idx)
    m = local_bundle_adjustment(cfg, cam, m, kf_idx)
    m = cull_points(cfg, m)
    return cull_keyframes(cfg, m, kf_idx)
