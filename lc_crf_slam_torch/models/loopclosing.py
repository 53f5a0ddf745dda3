"""Loop detection and relocalisation (counterpart of `detect_loop` and
`relocalize` of lc_crf_slam_tpu/models/loopclosing.py; loop verification
and correction are not ported yet).

KeyFrameDatabase::DetectLoopCandidates: cosine retrieval over the
keyframes' descriptor embeddings, gated by the lowest similarity among
the covisible neighbours and by temporal separation, scores accumulated
over each candidate's covisibility group, a 0.75 x best admission bar,
and the surviving top-k with their groups. The consecutive-detection
group consistency is the host's counter (`SLAMSystem._try_close_loop`).

Tracking::Relocalization: retrieval of the RELOC_CANDS keyframes whose
descriptor embeddings best match the frame (0.75 × best admission bar),
descriptor matching against each candidate's map points, 2D-3D PnP
RANSAC, motion-only refinement, and a guided second matching pass by
projection. The reference vmaps the candidates; the port matches them in
a loop, solves all their PnP hypotheses in one batch, and refines them in
a loop. A rare path: the batched `eigh` of the PnP reads its status on
the host once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._ops import stable_topk, take_row
from ..config import SLAMConfig
from ..geometry.camera import Pinhole
from ..geometry.se3 import make_se3
from ..ops.match import hamming_matrix, match_nn, projection_gate, resolve_duplicates
from ..ops.pnp import PnPSampler, pnp_ransac
from .ba import pose_optimize
from .frame import Frame
from .mapstate import MapState, _descriptor_embedding, covisibility

RELOC_CANDS = 4   # retrieval candidates tried per attempt


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
        pc = pw_c @ r.Tcw[:3, :3].T + r.Tcw[:3, 3]
        zc = torch.clamp(pc[:, 2], min=1e-6)
        uv_pred = torch.stack([cam.fx * pc[:, 0] / zc + cam.cx,
                               cam.fy * pc[:, 1] / zc + cam.cy], dim=-1)
        proj_ok = has_c & (pc[:, 2] > 0.05) \
            & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < cam.width) \
            & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < cam.height)
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
