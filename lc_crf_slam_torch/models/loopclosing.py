"""Loop closing and relocalisation (counterpart of
lc_crf_slam_tpu/models/loopclosing.py).

KeyFrameDatabase::DetectLoopCandidates (`detect_loop`): cosine retrieval
over the keyframes' descriptor embeddings, gated by the lowest similarity
among the covisible neighbours and by temporal separation, scores
accumulated over each candidate's covisibility group, a 0.75 x best
admission bar, and the surviving top-k with their groups. The
consecutive-detection group consistency is the host's counter
(`SLAMSystem._try_close_loop`).

ComputeSim3 (`verify_loop`): descriptor matches between the two
keyframes, depth-backed 3D-3D Horn RANSAC, `optimize_sim3`, then two
SearchByProjection rounds over the loop branch's map points, each
followed by a motion-only refinement; acceptance rests on that last
stage. CorrectLoop (`correct_loop`): the corrective transform applied to
the current covisible group, a pose graph over chain + strong
covisibility + the loop edge, map points moved with their reference
keyframe, SearchAndFuse on the current keyframe; `correct_loop_sim3` is
its monocular form (`cfg.loop.fix_scale=False`) over Sim(3) nodes.
`global_ba` is the joint matrix-free Schur LM over the whole map
(`ops/schur.py::solve_ba_cg`), run by the system in budgeted slices;
`search_and_fuse` over the group follows once the budget is spent.
`global_ba_alternating` is the block-coordinate alternative: camera and
point Gauss-Newton half-steps in turn. None of these reads the device on
the host.

Tracking::Relocalization (`relocalize`): retrieval of the RELOC_CANDS
keyframes whose descriptor embeddings best match the frame (0.75 × best
admission bar), descriptor matching against each candidate's map points,
2D-3D PnP RANSAC, motion-only refinement, and a second matching pass
by projection. The reference vmaps the candidates; the port matches
them in a loop, solves all their PnP hypotheses in one batch, and refines
them in a loop. A rare path: the batched `eigh` of the PnP reads its
status on the host once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._ops import put_row, stable_topk, take_row
from ..config import SLAMConfig
from ..geometry.camera import Pinhole
from ..geometry.se3 import exp_se3, make_se3, se3_inverse
from ..geometry.sim3 import se3_from_sim3, sim3_compose, sim3_from_se3, sim3_inverse
from ..ops.match import hamming_matrix, match_nn, projection_gate, resolve_duplicates
from ..ops.pnp import PnPSampler, pnp_ransac
from ..ops.ransac import HornSampler, horn_ransac
from ..ops.schur import (BAProblem, _edge_residuals, _robust_weights, _sum_into,
                         solve_ba_cg)
from .ba import pose_optimize
from .frame import Frame
from .mapping import fuse_duplicates
from .mapstate import MapState, _descriptor_embedding, covisibility, observed_mask
from .posegraph import PoseGraph, Sim3Graph, optimize_pose_graph, optimize_pose_graph_sim3
from .sim3opt import optimize_sim3

RELOC_CANDS = 4   # retrieval candidates tried per attempt
LOOP_GROUP_KFS = 12      # candidate + covisible neighbours whose points are re-matched
LOOP_POINTS = 2048       # loop-branch map points projected for the re-match
COVIS_EDGES = 256        # strongest covisibility edges of the pose graph


class LoopCandidate(NamedTuple):
    cand: torch.Tensor     # () int32 best candidate keyframe (-1 none)
    score: torch.Tensor    # () float32 retrieval score of the best
    valid: torch.Tensor    # () bool any candidate survived
    cands: torch.Tensor    # (topk,) int32 surviving candidates (-1 pad)
    groups: torch.Tensor   # (topk, F) bool covisibility group per candidate


def detect_loop(cfg: SLAMConfig, m: MapState, kf_idx: torch.Tensor) -> LoopCandidate:
    """Retrieval + gating for keyframe `kf_idx` (a 0-d device index); no
    host read."""
    topk = cfg.loop.retrieval_topk
    min_w = cfg.mapping.covisibility_min_weight
    sim = m.kf_emb @ take_row(m.kf_emb, kf_idx)
    covis = covisibility(m)
    # connected = weight-thresholded covisibility edges, as the reference's
    # GetConnectedKeyFrames
    connected = take_row(covis, kf_idx) >= min_w
    # minScore: the lowest similarity among covisible neighbours, capped
    nbrs = connected & m.kf_alive
    min_score = torch.where(
        torch.any(nbrs), torch.min(torch.where(nbrs, sim, float("inf"))), 0.0)
    min_score = torch.clamp(min_score, max=cfg.loop.min_score_cap)
    ids = torch.arange(m.capacity_kfs, device=sim.device)
    eligible = (m.kf_alive & (ids < m.n_kfs) & ~connected
                & (torch.abs(ids - kf_idx) >= cfg.loop.min_kfs_since_last)
                & (ids != kf_idx))
    cand_mask = eligible & (sim >= torch.clamp(min_score, min=cfg.loop.retrieval_floor))
    # accumulated group score: a candidate's own score plus those of the
    # fellow candidates inside its covisibility group
    nbr = covis >= min_w
    acc = sim + nbr.to(sim.dtype) @ torch.where(cand_mask, sim, 0.0)
    acc = torch.where(cand_mask, acc, float("-inf"))
    keep = cand_mask & (acc >= 0.75 * torch.max(acc))
    # top-k survivors by raw similarity; ties (the -inf padding among them)
    # to the lower index, as lax.top_k
    kscore, kidx = stable_topk(torch.where(keep, sim, float("-inf")), topk)
    kvalid = torch.isfinite(kscore)
    cands = torch.where(kvalid, kidx, -1).to(torch.int32)
    groups = (nbr[torch.clamp(cands, min=0).long()]
              | (ids[None, :] == cands[:, None])) & kvalid[:, None]
    return LoopCandidate(cand=cands[0], score=kscore[0], valid=torch.any(kvalid),
                         cands=cands, groups=groups)


def _backproject(cam: Pinhole, uv: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[:, 0] - cam.cx) / cam.fx * d,
                        (uv[:, 1] - cam.cy) / cam.fy * d, d], dim=-1)


def _project(cam: Pinhole, Tcw: torch.Tensor, pw: torch.Tensor):
    """World points (N, 3) -> (pixels (N, 2), in front of the camera and
    inside the image (N,))."""
    pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = torch.clamp(pc[:, 2], min=1e-6)
    uv = torch.stack([cam.fx * pc[:, 0] / z + cam.cx,
                      cam.fy * pc[:, 1] / z + cam.cy], dim=-1)
    inside = (pc[:, 2] > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    return uv, inside


def _kf_world_points(cam: Pinhole, m: MapState, kf: torch.Tensor):
    """World positions of a keyframe's features (K, 3) and which are
    usable: back-projected where a depth was measured, else the feature's
    map point."""
    d = take_row(m.kf_depth, kf)
    Twc = se3_inverse(take_row(m.kf_Tcw, kf))
    pw_depth = _backproject(cam, take_row(m.kf_uv, kf), d) @ Twc[:3, :3].T + Twc[:3, 3]
    obs = take_row(m.kf_obs, kf)
    ids = torch.clamp(obs, min=0).long()
    has_pt = (obs >= 0) & m.p_alive[ids]
    ok_d = d > 0
    pw = torch.where(ok_d[:, None], pw_depth, m.p_xyz[ids])
    return pw, take_row(m.kf_valid, kf) & (ok_d | has_pt)


class LoopVerification(NamedTuple):
    T_corr: torch.Tensor     # (4, 4) world correction: p_true = T_corr @ p_drifted
    s_corr: torch.Tensor     # () world-correction scale (1 when fix_scale)
    n_inliers: torch.Tensor  # () int32 inliers of the last refinement
    accepted: torch.Tensor   # () bool


def verify_loop(cfg: SLAMConfig, cam: Pinhole, m: MapState, kf_idx: torch.Tensor,
                cand: torch.Tensor, sampler: HornSampler) -> LoopVerification:
    """ComputeSim3 for keyframe `kf_idx` against candidate `cand` (0-d
    device indices): the correction that maps the drifted current branch
    onto the loop branch, and whether to accept it. `sampler` draws the
    Horn RANSAC's minimal sets."""
    dev = m.p_xyz.device
    min_w = cfg.mapping.covisibility_min_weight
    cand_s = torch.clamp(cand, min=0)
    kf_uv, kf_valid = take_row(m.kf_uv, kf_idx), take_row(m.kf_valid, kf_idx)
    kf_desc, kf_level = take_row(m.kf_desc, kf_idx), take_row(m.kf_level, kf_idx)
    kf_ur = take_row(m.kf_ur, kf_idx)
    Tcw_kf, Tcw_cd = take_row(m.kf_Tcw, kf_idx), take_row(m.kf_Tcw, cand_s)

    dist = hamming_matrix(kf_desc, take_row(m.kf_desc, cand_s))
    gate = kf_valid[:, None] & take_row(m.kf_valid, cand_s)[None, :]
    mm = match_nn(dist, mask=gate, max_dist=cfg.matcher.th_low, ratio=0.75, mutual=True)
    mv = resolve_duplicates(mm.idx, mm.dist, mm.valid, dist.shape[1])
    p_kf, ok_kf = _kf_world_points(cam, m, kf_idx)
    p_cd, ok_cd = _kf_world_points(cam, m, cand_s)
    pairs_ok = mv & ok_kf & ok_cd[mm.idx]
    n_matches = torch.sum(pairs_ok.to(torch.int32))
    res = horn_ransac(p_kf, p_cd[mm.idx], pairs_ok, sampler,
                      n_hypotheses=cfg.loop.ransac_hypotheses, inlier_tol=0.10,
                      fix_scale=cfg.loop.fix_scale)

    # ---- OptimizeSim3 in the two camera frames ----------------------------
    # S12 maps candidate-camera to keyframe-camera coordinates; from the
    # world correction: S12 = Tcw_kf o S_corr^-1 o Twc_cd
    def cam_points(kf, Tcw):
        """Camera-frame feature points: the measured depth where there is
        one, else the feature's map point seen from the camera."""
        d = take_row(m.kf_depth, kf)
        ids = torch.clamp(take_row(m.kf_obs, kf), min=0).long()
        pc_m = m.p_xyz[ids] @ Tcw[:3, :3].T + Tcw[:3, 3]
        return torch.where((d > 0)[:, None],
                           _backproject(cam, take_row(m.kf_uv, kf), d), pc_m)

    S12_0 = sim3_compose(
        sim3_from_se3(Tcw_kf),
        sim3_compose(sim3_inverse((res.s, res.R, res.t)),
                     sim3_from_se3(se3_inverse(Tcw_cd))))
    inv_sigma2 = (1.0 / cfg.orb.scale_factor**2) ** kf_level.to(torch.float32)
    ref = optimize_sim3(cam, S12_0, cam_points(kf_idx, Tcw_kf),
                        cam_points(cand_s, Tcw_cd)[mm.idx], kf_uv,
                        take_row(m.kf_uv, cand_s)[mm.idx], pairs_ok & res.inliers,
                        inv_sigma2, fix_scale=cfg.loop.fix_scale)
    S_corr = sim3_inverse(sim3_compose(
        sim3_from_se3(se3_inverse(Tcw_kf)),
        sim3_compose((ref.s, ref.R, ref.t), sim3_from_se3(Tcw_cd))))

    # ---- SearchByProjection re-match + final refinement -------------------
    # the loop branch's map points (candidate + covisible neighbours),
    # projected through the corrected pose and re-matched in a narrow
    # window, twice; the second round at the first one's refined pose
    covis_row = take_row(covisibility(m), cand_s)
    gw0 = put_row(torch.where((covis_row >= min_w) & m.kf_alive, covis_row,
                              float("-inf")), cand_s, float("inf"))
    gw, gids = stable_topk(gw0, LOOP_GROUP_KFS)
    gids = torch.where(gw > float("-inf"), gids, -1)
    loop_pts = observed_mask(m, gids)
    NP = min(LOOP_POINTS, m.capacity_points)
    _, pid = stable_topk(loop_pts.to(torch.float32), NP)
    p_ok = loop_pts[pid]
    pw = m.p_xyz[pid]
    # the corrected current camera in the loop world, S_cw = Tcw_kf o
    # S_corr^-1, as an SE3 with the scale folded into the translation
    S_cw = sim3_compose(sim3_from_se3(Tcw_kf), sim3_inverse(S_corr))
    Tcw_corr0 = make_se3(S_cw[1], S_cw[2] / S_cw[0])
    dist_g = hamming_matrix(kf_desc, m.p_desc[pid])               # (K, NP)

    def projection_round(Tcw):
        uv_pred, inside = _project(cam, Tcw, pw)
        gate_g = kf_valid[:, None] & (p_ok & inside)[None, :] & projection_gate(
            kf_uv, uv_pred, cfg.loop.guided_radius_px)
        mm_g = match_nn(dist_g, mask=gate_g, max_dist=cfg.matcher.th_high, mutual=True)
        mv_g = resolve_duplicates(mm_g.idx, mm_g.dist, mm_g.valid, NP)
        return mv_g, pose_optimize(cam, Tcw, pw[mm_g.idx], kf_uv, kf_ur, kf_level,
                                   mv_g, cfg.pose_opt, cfg.orb.scale_factor)

    _, r2a = projection_round(Tcw_corr0)
    mv_b, r2 = projection_round(r2a.Tcw)
    # the final correction from the refined camera (scale unchanged):
    # S_corr = S_cw_refined^-1 o Tcw_kf, where the camera's scale is
    # S_cw[0] = 1 / S_corr[0]
    S_cw_ref = (S_cw[0], r2.Tcw[:3, :3], S_cw[0] * r2.Tcw[:3, 3])
    S_corr_f = sim3_compose(sim3_inverse(S_cw_ref), sim3_from_se3(Tcw_kf))
    T_corr = se3_from_sim3(S_corr_f)

    # the early stages only seed a correction (half the reference's bars);
    # the decision rests on the projection stage at the full bars
    n_total = torch.sum(mv_b.to(torch.int32))
    seed_bow = cfg.loop.seed_bow_matches or max(cfg.loop.min_bow_matches // 2, 8)
    seed_inl = cfg.loop.seed_sim3_inliers or max(cfg.loop.min_sim3_inliers // 2, 8)
    accepted = ((cand >= 0) & (n_matches >= seed_bow) & (res.n_inliers >= seed_inl)
                & (ref.n_inliers >= seed_inl)
                & (r2.n_inliers >= cfg.loop.min_sim3_inliers)
                & (n_total >= cfg.loop.min_total_matches)
                & torch.all(torch.isfinite(T_corr)))
    return LoopVerification(
        T_corr=torch.where(accepted, T_corr, torch.eye(4, dtype=T_corr.dtype, device=dev)),
        s_corr=torch.where(accepted, S_corr_f[0], 1.0),
        n_inliers=r2.n_inliers, accepted=accepted)


def search_and_fuse(cfg: SLAMConfig, cam: Pinhole, m: MapState, kf_idx: torch.Tensor,
                    budget: int = 4) -> MapState:
    """SearchAndFuse: fuse the loop branch's duplicate points into the
    current covisible group, on the current keyframe and its `budget` - 1
    strongest covisible neighbours, with `fuse_duplicates(loop_mode=True)`.
    `correct_loop` fuses the current keyframe at once; the group-wide fuse
    is for after global BA, whose refined alignment the 2.5 px gates need."""
    covis_row = take_row(covisibility(m), kf_idx)
    group = (covis_row >= cfg.mapping.covisibility_min_weight) & m.kf_alive
    w = put_row(torch.where(group, covis_row, float("-inf")), kf_idx, float("inf"))
    wk, fuse_kfs = stable_topk(w, budget)
    # a group smaller than the budget re-fuses the current keyframe (a no-op)
    fuse_kfs = torch.where(wk == float("-inf"), kf_idx.to(fuse_kfs.dtype), fuse_kfs)
    for i in range(budget):
        m = fuse_duplicates(cfg, cam, m, fuse_kfs[i], loop_mode=True)
    return m


def _loop_group(cfg: SLAMConfig, m: MapState, covis: torch.Tensor,
                kf_idx: torch.Tensor) -> torch.Tensor:
    """(F,) bool: the current keyframe and its live covisible group."""
    return put_row(take_row(covis, kf_idx) >= cfg.mapping.covisibility_min_weight,
                   kf_idx, True) & m.kf_alive


def _essential_edges(cfg: SLAMConfig, m: MapState, covis: torch.Tensor,
                     kf_idx: torch.Tensor, cand_s: torch.Tensor):
    """The essential graph's edges (e_i, e_j, e_w, e_valid): the chain,
    the COVIS_EDGES strongest covisibility pairs at least two keyframes
    apart, and last the loop edge kf_idx -> cand_s (weight 5)."""
    F, dev = m.capacity_kfs, m.p_xyz.device
    ids = torch.arange(F, device=dev)
    seq_i, seq_j = ids[1:], ids[:-1]
    seq_valid = m.kf_alive[seq_i] & m.kf_alive[seq_j] & (seq_i < m.n_kfs)
    apart = torch.triu(torch.ones((F, F), dtype=torch.bool, device=dev), 2)
    cv = torch.where(apart & m.kf_alive[:, None] & m.kf_alive[None, :], covis, 0.0)
    topv, topidx = stable_topk(cv.reshape(-1), COVIS_EDGES)
    cv_valid = topv >= cfg.loop.covis_edge_weight
    e_i = torch.cat([seq_i, topidx // F, kf_idx.reshape(1).long()])
    e_j = torch.cat([seq_j, topidx % F, cand_s.reshape(1).long()])
    e_w = torch.cat([torch.ones(e_i.shape[0] - 1, dtype=torch.float32, device=dev),
                     torch.full((1,), 5.0, dtype=torch.float32, device=dev)])
    e_valid = torch.cat([seq_valid, cv_valid, torch.ones_like(cv_valid[:1])])
    return e_i, e_j, e_w, e_valid


def correct_loop(cfg: SLAMConfig, cam: Pinhole, m: MapState, kf_idx: torch.Tensor,
                 cand: torch.Tensor, T_corr: torch.Tensor) -> MapState:
    """CorrectLoop: correct the current covisible group, optimise the
    essential graph, move the map points with their reference keyframe."""
    F = m.capacity_kfs
    ids = torch.arange(F, device=m.p_xyz.device)
    covis = covisibility(m)
    group = _loop_group(cfg, m, covis, kf_idx)
    cand_s = torch.clamp(cand, min=0)

    Tcw_old = m.kf_Tcw
    # the world correction moves the group's drifted world frame onto the
    # loop branch: Tcw' = Tcw @ T_corr^-1
    T_corr_inv = se3_inverse(T_corr)
    Tcw_corr = torch.where(group[:, None, None], Tcw_old @ T_corr_inv, Tcw_old)

    # chain and strong covisibility edges measured from the poses before
    # the correction (odometry), the loop edge from the corrected relative
    # pose; the loop candidate and keyframe 0 are the anchors
    e_i, e_j, e_w, e_valid = _essential_edges(cfg, m, covis, kf_idx, cand_s)
    rel_meas = Tcw_old[e_i[:-1]] @ se3_inverse(Tcw_old[e_j[:-1]])
    loop_rel = (take_row(Tcw_old, kf_idx) @ T_corr_inv) @ se3_inverse(
        take_row(Tcw_old, cand_s))
    g = PoseGraph(
        Tcw=Tcw_corr, node_valid=m.kf_alive & (ids < m.n_kfs),
        node_fixed=(ids == 0) | (ids == cand), e_i=e_i, e_j=e_j,
        e_rel=torch.cat([rel_meas, loop_rel[None]]), e_w=e_w, e_valid=e_valid)
    Tcw_new = optimize_pose_graph(g, n_iters=cfg.loop.pose_graph_iters)

    # each point moves with its reference keyframe: Twc_new Tcw_old
    D = (se3_inverse(Tcw_new) @ Tcw_old)[torch.clamp(m.p_first_kf, 0, F - 1).long()]
    p_new = torch.einsum("pij,pj->pi", D[:, :3, :3], m.p_xyz) + D[:, :3, 3]
    m = m._replace(kf_Tcw=Tcw_new,
                   p_xyz=torch.where(m.p_alive[:, None], p_new, m.p_xyz))
    # SearchAndFuse on the current keyframe only, the one the tracker
    # anchors on; the group waits for global BA (see `search_and_fuse`)
    return search_and_fuse(cfg, cam, m, kf_idx, budget=1)


def correct_loop_sim3(cfg: SLAMConfig, cam: Pinhole, m: MapState, kf_idx: torch.Tensor,
                      cand: torch.Tensor, T_corr: torch.Tensor,
                      s_corr: torch.Tensor) -> MapState:
    """CorrectLoop for the monocular sensor (`cfg.loop.fix_scale=False`):
    the essential graph over Sim(3) nodes, whose free scale absorbs the
    accumulated scale drift. The corrected current group gets scale
    1 / s_corr; after the optimisation the node poses fold the scale back
    into the translation (Tiw = [R, t / s]) and every map point moves
    through its reference keyframe's Sim(3) change, its distance range
    scaled with it."""
    F = m.capacity_kfs
    ids = torch.arange(F, device=m.p_xyz.device)
    # verify_loop exports T_corr with the scale folded into the
    # translation: rebuild the Sim(3) world correction
    S_corr_inv = sim3_inverse((s_corr, T_corr[:3, :3], T_corr[:3, 3] * s_corr))
    covis = covisibility(m)
    group = _loop_group(cfg, m, covis, kf_idx)
    cand_s = torch.clamp(cand, min=0)

    Tcw_old = m.kf_Tcw
    S_old = sim3_from_se3(Tcw_old)
    S_grp = sim3_compose(S_old, S_corr_inv)             # S_cw' of every keyframe
    s_n = torch.where(group, S_grp[0], S_old[0])
    R_n = torch.where(group[:, None, None], S_grp[1], S_old[1])
    t_n = torch.where(group[:, None], S_grp[2], S_old[2])

    # chain and covisibility edges from the poses before the correction
    # (scale-1 odometry), the loop edge from the corrected current pose
    e_i, e_j, e_w, e_valid = _essential_edges(cfg, m, covis, kf_idx, cand_s)
    rel = Tcw_old[e_i[:-1]] @ se3_inverse(Tcw_old[e_j[:-1]])
    S_loop = sim3_compose(sim3_compose(sim3_from_se3(take_row(Tcw_old, kf_idx)), S_corr_inv),
                          sim3_inverse(sim3_from_se3(take_row(Tcw_old, cand_s))))
    node_valid = m.kf_alive & (ids < m.n_kfs)
    g = Sim3Graph(
        s=s_n, R=R_n, t=t_n, node_valid=node_valid,
        node_fixed=(ids == 0) | (ids == cand), e_i=e_i, e_j=e_j,
        e_s=torch.cat([torch.ones_like(e_w[:-1]), S_loop[0].reshape(1)]),
        e_R=torch.cat([rel[:, :3, :3], S_loop[1][None]]),
        e_t=torch.cat([rel[:, :3, 3], S_loop[2][None]]), e_w=e_w, e_valid=e_valid)
    S_new = optimize_pose_graph_sim3(g, n_iters=cfg.loop.pose_graph_iters,
                                     fix_scale=False)
    Tcw_new = torch.where(node_valid[:, None, None], se3_from_sim3(S_new), Tcw_old)

    # p' = S_new^-1(S_old(p)) through the point's reference keyframe
    # (CorrectLoop's eigP3Dw -> Srw -> corrected Swc)
    ref = torch.clamp(m.p_first_kf, 0, F - 1).long()
    s_a, R_a, t_a = S_old[0][ref], S_old[1][ref], S_old[2][ref]
    pc = s_a[:, None] * torch.einsum("pij,pj->pi", R_a, m.p_xyz) + t_a
    S_inv = sim3_inverse(S_new)
    s_b, R_b, t_b = S_inv[0][ref], S_inv[1][ref], S_inv[2][ref]
    p_new = s_b[:, None] * torch.einsum("pij,pj->pi", R_b, pc) + t_b
    # the scale-invariance distance range follows the local scale change
    s_ratio = torch.where(m.p_alive, s_a / torch.clamp(S_new[0][ref], min=1e-9), 1.0)
    m = m._replace(kf_Tcw=Tcw_new,
                   p_xyz=torch.where(m.p_alive[:, None], p_new, m.p_xyz),
                   p_min_dist=m.p_min_dist * s_ratio, p_max_dist=m.p_max_dist * s_ratio)
    return search_and_fuse(cfg, cam, m, kf_idx, budget=1)


def _map_ba_problem(cfg: SLAMConfig, m: MapState) -> BAProblem:
    """The whole map's BAProblem from the observation tables, keyframe 0
    fixed."""
    F, K = m.kf_obs.shape
    ids = torch.arange(F, device=m.kf_obs.device)
    return BAProblem(
        cam_Tcw=m.kf_Tcw, cam_fixed=ids == 0, p_xyz=m.p_xyz, p_valid=m.p_alive,
        e_cam=ids[:, None].expand(F, K).reshape(-1),
        e_pt=torch.clamp(m.kf_obs, min=0).reshape(-1).long(),
        e_uv=m.kf_uv.reshape(-1, 2), e_ur=m.kf_ur.reshape(-1),
        e_w=((1.0 / cfg.orb.scale_factor**2) ** m.kf_level.to(torch.float32)).reshape(-1),
        e_valid=(m.kf_alive[:, None] & m.kf_valid & (m.kf_obs >= 0)).reshape(-1))


def global_ba(cfg: SLAMConfig, cam: Pinhole, m: MapState, n_iters: int = 8) -> MapState:
    """RunGlobalBundleAdjustment: `n_iters` LM iterations of the joint
    matrix-free Schur solve over every keyframe and point of the map."""
    cam_Tcw, p_xyz, _ = solve_ba_cg(cam, _map_ba_problem(cfg, m), n_iters=n_iters,
                                    huber_delta=cfg.local_ba.huber_delta)
    return m._replace(kf_Tcw=cam_Tcw, p_xyz=p_xyz)


def global_ba_alternating(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                          n_rounds: int = 6) -> MapState:
    """Block-coordinate global BA: each of `n_rounds` rounds takes one
    damped Gauss-Newton half-step of every live camera but keyframe 0
    (block-diagonal 6x6 systems), then one of every observed point (3x3
    systems), each against the Huber-weighted reprojections of the whole
    map. The fixed point of joint BA where it converges, cheaper a
    round."""
    prob = _map_ba_problem(cfg, m)
    huber = cfg.local_ba.huber_delta
    F, P = m.kf_Tcw.shape[0], m.p_xyz.shape[0]
    movable = (~prob.cam_fixed) & m.kf_alive

    def weights(cam_Tcw, p_xyz):
        r, J_cam, J_pt, z_ok = _edge_residuals(cam, cam_Tcw, p_xyz, prob)
        active = prob.e_valid & z_ok & prob.p_valid[prob.e_pt]
        return r, J_cam, J_pt, _robust_weights(r, prob.e_w, active, huber)[1]

    def damped_step(n, idx, wJ, J, r, k):
        """-(H + 1e-3 diag H + 1e-6 I)^-1 g of each of n k x k blocks; H."""
        H = _sum_into(n, idx, torch.einsum("eij,eik->ejk", wJ, J))
        g = _sum_into(n, idx, torch.einsum("eij,ei->ej", wJ, r))
        eye = torch.eye(k, dtype=H.dtype, device=H.device)
        H = H + 1e-3 * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-6 * eye
        return -torch.linalg.solve_ex(H, g[..., None])[0][..., 0], H

    cam_Tcw, p_xyz = m.kf_Tcw, m.p_xyz
    for _ in range(n_rounds):
        r, J_cam, _, w = weights(cam_Tcw, p_xyz)
        delta_c, _ = damped_step(F, prob.e_cam, w[:, None, None] * J_cam, J_cam, r, 6)
        cam_Tcw = exp_se3(delta_c * movable[:, None].to(delta_c.dtype)) @ cam_Tcw
        r, _, J_pt, w = weights(cam_Tcw, p_xyz)
        delta_p, Hpp = damped_step(P, prob.e_pt, w[:, None, None] * J_pt, J_pt, r, 3)
        has_obs = torch.einsum("pii->p", Hpp) > 1e-5
        p_xyz = p_xyz + torch.where((prob.p_valid & has_obs)[:, None], delta_p, 0.0)
    return m._replace(kf_Tcw=cam_Tcw, p_xyz=p_xyz)


class RelocResult(NamedTuple):
    Tcw: torch.Tensor
    n_inliers: torch.Tensor
    accepted: torch.Tensor


def relocalize(cfg: SLAMConfig, cam: Pinhole, m: MapState, frame: Frame,
               sampler: PnPSampler) -> RelocResult:
    """Multi-candidate retrieval -> descriptor matching -> batched PnP
    RANSAC -> motion-only refinement -> guided re-match. `sampler` draws
    the PnP samples of all candidates at once, (RELOC_CANDS, n_hyp, 6)."""
    dev = frame.uv.device
    emb = _descriptor_embedding(frame.desc, frame.valid)
    sim = m.kf_emb @ emb
    eligible = m.kf_alive & (torch.arange(m.capacity_kfs, device=dev) < m.n_kfs)
    score = torch.where(eligible, sim, float("-inf"))
    kscore, cands = stable_topk(score, RELOC_CANDS)
    cand_ok = torch.isfinite(kscore) & (kscore >= 0.75 * kscore[0])

    pw_pts, has_pts = [], []
    for c in range(RELOC_CANDS):
        cand = cands[c]
        dist = hamming_matrix(frame.desc, take_row(m.kf_desc, cand))
        gate = frame.valid[:, None] & take_row(m.kf_valid, cand)[None, :] & cand_ok[c]
        mm = match_nn(dist, mask=gate, max_dist=cfg.matcher.th_low,
                      ratio=cfg.matcher.nn_ratio_reloc, mutual=True)
        mv = resolve_duplicates(mm.idx, mm.dist, mm.valid, dist.shape[1])
        # 2D-3D pairs: frame pixels vs the candidate's map points
        obs = torch.where(mv, take_row(m.kf_obs, cand)[mm.idx], -1)
        pw_pts.append(m.p_xyz[torch.clamp(obs, min=0).long()])
        has_pts.append((obs >= 0) & mv)
    pw_pts, has_pts = torch.stack(pw_pts), torch.stack(has_pts)
    res = pnp_ransac(cam, pw_pts, frame.uv, frame.level, has_pts, sampler,
                     n_hypotheses=cfg.loop.ransac_hypotheses,
                     chi2_th=cfg.loop.ransac_inlier_chi2,
                     scale_factor=cfg.orb.scale_factor)
    Tcw0 = make_se3(res.R, res.t)

    Tcws, n_inl = [], []
    for c in range(RELOC_CANDS):
        cand = cands[c]
        r = pose_optimize(cam, Tcw0[c], pw_pts[c], frame.uv, frame.u_right,
                          frame.level, has_pts[c] & res.inliers[c], cfg.pose_opt,
                          cfg.orb.scale_factor)
        # guided second-chance SearchByProjection at the refined pose
        obs_c = take_row(m.kf_obs, cand)
        has_c = (obs_c >= 0) & take_row(m.kf_valid, cand)
        pw_c = m.p_xyz[torch.clamp(obs_c, min=0).long()]
        uv_pred, inside = _project(cam, r.Tcw, pw_c)
        proj_ok = has_c & inside
        dist_g = hamming_matrix(frame.desc, m.p_desc[torch.clamp(obs_c, min=0).long()])
        gate_g = frame.valid[:, None] & proj_ok[None, :] & projection_gate(
            frame.uv, uv_pred, cfg.loop.guided_radius_px)
        mm_g = match_nn(dist_g, mask=gate_g, max_dist=cfg.matcher.th_high,
                        mutual=True)
        mv_g = resolve_duplicates(mm_g.idx, mm_g.dist, mm_g.valid, dist_g.shape[1])
        r2 = pose_optimize(cam, r.Tcw, pw_c[mm_g.idx], frame.uv, frame.u_right,
                           frame.level, mv_g, cfg.pose_opt, cfg.orb.scale_factor)
        use2 = r2.n_inliers > r.n_inliers
        Tcws.append(torch.where(use2, r2.Tcw, r.Tcw))
        n_inl.append(torch.maximum(r2.n_inliers, r.n_inliers))
    Tcws, n_inl = torch.stack(Tcws), torch.stack(n_inl)
    accs = cand_ok & res.ok & (n_inl >= cfg.tracking.min_inliers_reloc)
    best = torch.argmax(torch.where(accs, n_inl, -1))
    accepted = take_row(accs, best)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return RelocResult(Tcw=torch.where(accepted, take_row(Tcws, best), eye),
                       n_inliers=take_row(n_inl, best), accepted=accepted)
