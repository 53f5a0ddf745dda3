"""Motion-only pose optimisation and its capture-resistance audit
(counterpart of lc_crf_slam_tpu/models/ba.py).

`pose_optimize`: Huber-weighted Levenberg-Marquardt on one SE3 vertex with
the reference's schedule (4 rounds x 10 iterations, chi2 reclassification
between rounds). The `fori_loop` becomes a Python loop; every branch is a
`torch.where`, so nothing waits on the device. On a card the whole solve
(~9k small kernels) is one CUDA graph, captured once for each shape and
set of scalars it bakes in and replayed on every call: the same kernels
in the same order, one launch from the host instead of ~5k aten ops.

`pose_consensus`: batched 3-point Horn hypotheses, polished and scored
under a tight reprojection window. Its random draws are inputs (the
hypothesis index triples and the audit uniforms): the pipeline draws them
with a `torch.Generator`, the parity tests pass the reference's
`jax.random` draws.

Inside a `SLAMSystem` entry each call of either is a span of its name
(`utils/profiling.spanned`), whoever the caller: tracking, loop
verification or relocalisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._ops import stable_topk, take_row
from ..config import PoseOptConfig
from ..geometry.align import umeyama_alignment
from ..geometry.camera import Pinhole
from ..geometry.se3 import exp_se3, hat_so3, make_se3
from ..utils.cuda_graph import replay
from ..utils.profiling import spanned


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # (4, 4) optimised pose
    inliers: torch.Tensor    # (N,) bool
    chi2: torch.Tensor       # () weighted chi2 over inliers
    n_inliers: torch.Tensor  # () int32


def _project(cam: Pinhole, Tcw, pw):
    """World points (..., N, 3) into the camera of Tcw (..., 4, 4)."""
    return pw @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]


def _residuals(cam: Pinhole, Tcw, pw, obs_uv, obs_ur, is_stereo):
    """Per-point residual (..., N, 3) [u, v, uR] (uR zero for mono), the
    camera-frame points and the positive-depth mask."""
    pc = _project(cam, Tcw, pw)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_ok = z > 1e-3
    inv_z = 1.0 / torch.where(z_ok, z, 1.0)
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    r = torch.stack(
        [u - obs_uv[..., 0], v - obs_uv[..., 1],
         torch.where(is_stereo, ur - obs_ur, 0.0)], dim=-1)
    return r, pc, inv_z, z_ok


def _residuals_jacobians(cam: Pinhole, Tcw, pw, obs_uv, obs_ur, is_stereo):
    """Residual (..., N, 3), Jacobian (..., N, 3, 6) wrt the left twist,
    and the positive-depth mask."""
    r, pc, inv_z, z_ok = _residuals(cam, Tcw, pw, obs_uv, obs_ur, is_stereo)
    x, y = pc[..., 0], pc[..., 1]
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(inv_z)
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    dr = du + torch.stack([zero, zero, cam.bf * inv_z2], -1)
    dr = torch.where(is_stereo[..., None], dr, 0.0)
    d_pc = torch.stack([du, dv, dr], dim=-2)                      # (..., N, 3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape + (3,))
    d_twist = torch.cat([eye, -hat_so3(pc)], dim=-1)              # (..., N, 3, 6)
    return r, d_pc @ d_twist, z_ok


def _solve6(H, g):
    """-(H^-1 g) for (..., 6, 6), (..., 6) without a host-side error check."""
    return -torch.linalg.solve_ex(H, g[..., None])[0][..., 0]


# captured solves by `_graph_key` (and the float settings, `utils/cuda_graph.replay`)
_GRAPHS: dict = {}


def _graph_key(cam: Pinhole, args: tuple, cfg: PoseOptConfig, scale_factor: float):
    """What a captured solve bakes in: the camera, the settings and the
    scale factor (scalars of its kernels), and each input's shape, dtype
    and device."""
    return (cam, cfg, float(scale_factor),
            tuple((tuple(a.shape), a.dtype, a.device) for a in args))


@spanned
def pose_optimize(
    cam: Pinhole,
    Tcw0: torch.Tensor,
    pw: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_ur: torch.Tensor,
    level: torch.Tensor,
    valid: torch.Tensor,
    cfg: PoseOptConfig = PoseOptConfig(),
    scale_factor: float = 1.2,
) -> PoseOptResult:
    """Motion-only BA; obs_ur < 0 marks mono observations. Between rounds
    every valid point is re-tested against the chi2 bar.

    On a card, outside a capture, the solve is a CUDA graph
    (`utils/cuda_graph.replay`, spans `pose_optimize.capture` /
    `pose_optimize.replay`): each call copies its inputs into the graph's,
    replays it and returns copies of its outputs. Elsewhere the solve runs
    eagerly, op by op."""
    args = (Tcw0, pw, obs_uv, obs_ur, level, valid)
    if pw.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return _lm_solve(cam, *args, cfg, scale_factor)
    return replay(_GRAPHS, _graph_key(cam, args, cfg, scale_factor), "pose_optimize",
                  lambda *a: _lm_solve(cam, *a, cfg, scale_factor), args)


def _lm_solve(cam, Tcw0, pw, obs_uv, obs_ur, level, valid, cfg, scale_factor):
    """`pose_optimize`'s solve, op by op."""
    is_stereo = obs_ur >= 0
    inv_sigma2 = (1.0 / scale_factor**2) ** level.to(torch.float32)
    chi2_th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    delta = torch.where(is_stereo, cfg.huber_delta_stereo, cfg.huber_delta_mono)
    eye6 = torch.eye(6, dtype=pw.dtype, device=pw.device)

    def point_chi2(Tcw, active):
        r, _, _, z_ok = _residuals(cam, Tcw, pw, obs_uv, obs_ur, is_stereo)
        return torch.sum(r * r, dim=-1) * inv_sigma2, z_ok & active

    def total(c, okm):
        s = torch.sqrt(torch.clamp(c, min=1e-12))
        rho = torch.where(s <= delta, c, 2.0 * delta * s - delta * delta)
        return torch.sum(torch.where(okm, rho, 0.0))

    Tcw = Tcw0
    active = valid
    for _ in range(cfg.rounds):
        lam = torch.full((), cfg.init_lambda, dtype=torch.float32, device=pw.device)
        for _ in range(cfg.iters_per_round):
            r, J, z_ok = _residuals_jacobians(cam, Tcw, pw, obs_uv, obs_ur, is_stereo)
            ok = active & z_ok
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            s = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_huber = torch.where(s <= delta, 1.0, delta / s)
            w = torch.where(ok, inv_sigma2 * w_huber, 0.0)
            H = torch.einsum("nij,n,nik->jk", J, w, J)
            g = torch.einsum("nij,n,ni->j", J, w, r)
            H_lm = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            T_new = exp_se3(_solve6(H_lm, g)) @ Tcw
            chi2_new, ok_new = point_chi2(T_new, active)
            # the chi2 and mask at Tcw are the ones computed above
            accept = total(chi2_new, ok_new) < total(chi2, ok)
            Tcw = torch.where(accept, T_new, Tcw)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        chi2_pts, ok = point_chi2(Tcw, valid)
        active = ok & (chi2_pts < chi2_th)

    chi2_pts, ok = point_chi2(Tcw, valid)
    inliers = ok & (chi2_pts < chi2_th)
    return PoseOptResult(
        Tcw=Tcw,
        inliers=inliers,
        chi2=torch.sum(torch.where(inliers, chi2_pts, 0.0)),
        n_inliers=torch.sum(inliers.to(torch.int32)),
    )


_COVERAGE_CELL_PX = 40  # image-grid cell for the dispersion score


def _tight_score(cam, Tcw, pw, obs_uv, inv_sigma2, valid, tight_chi2, trust):
    """Spatial-coverage consensus score of pose hypotheses Tcw (..., 4, 4):
    the number of 40-px cells holding a tight-window inlier, plus a small
    trust-weighted inlier mass to break ties."""
    pc = _project(cam, Tcw, pw)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    chi2 = (torch.square(u - obs_uv[..., 0])
            + torch.square(v - obs_uv[..., 1])) * inv_sigma2
    ok = (chi2 < tight_chi2) & valid & (pc[..., 2] > 0.05)
    w = ok * trust
    nx = -(-cam.width // _COVERAGE_CELL_PX)
    ny = -(-cam.height // _COVERAGE_CELL_PX)
    cu = torch.clamp(obs_uv[..., 0] // _COVERAGE_CELL_PX, 0, nx - 1)
    cv = torch.clamp(obs_uv[..., 1] // _COVERAGE_CELL_PX, 0, ny - 1)
    cell = (cv * nx + cu).long().expand(ok.shape)
    hit = torch.zeros(ok.shape[:-1] + (nx * ny,), dtype=torch.float32,
                      device=pw.device).scatter_reduce(
        -1, cell, ok.to(torch.float32), "amax")
    return torch.sum(hit, dim=-1) + 0.01 * torch.sum(w, dim=-1)


def consensus_weights(valid3d: torch.Tensor, trust: torch.Tensor) -> torch.Tensor:
    """Hypothesis-sampling distribution over the N associations."""
    p = valid3d.to(torch.float32) * trust
    return p / torch.clamp(torch.sum(p), min=1e-6)


def draw_consensus(p: torch.Tensor, n_hypotheses: int,
                   generator: torch.Generator):
    """The audit's random draws: (n_hyp, 3) association indices ~ p with
    replacement, and (N,) uniforms that pick the audit subsample. An
    all-zero p (no association with depth) draws uniformly; the audit
    is then skipped by its `consensus_min_3d` bar anyway."""
    safe = torch.where(torch.sum(p) > 0, p, torch.ones_like(p))
    idx = torch.multinomial(safe, n_hypotheses * 3, replacement=True,
                            generator=generator).reshape(n_hypotheses, 3)
    u = torch.rand(p.shape, generator=generator, device=p.device)
    return idx, u


@spanned
def pose_consensus(
    cam: Pinhole,
    T_lm: torch.Tensor,        # (4, 4) the LM solve to audit
    pw: torch.Tensor,          # (N, 3) matched world points
    pc_cam: torch.Tensor,      # (N, 3) frame keypoints unprojected by depth
    obs_uv: torch.Tensor,      # (N, 2)
    level: torch.Tensor,       # (N,)
    valid_score: torch.Tensor,  # (N,) bool: counted in consensus
    hyp_idx: torch.Tensor,     # (n_hyp, 3) drawn from consensus_weights
    audit_u: torch.Tensor,     # (N,) uniforms choosing the audit subsample
    tight_chi2: float = 4.0,
    scale_factor: float = 1.2,
    audit_points: int = 256,
    trust: torch.Tensor | None = None,
):
    """Capture-resistance audit of a motion-only solve (see the
    reference's docstring). Returns (T_best, score_best, score_lm,
    best_mask)."""
    N = pw.shape[0]
    inv_sigma2 = (1.0 / scale_factor**2) ** level.to(torch.float32)
    if trust is None:
        trust = torch.ones((N,), dtype=torch.float32, device=pw.device)
    _, R_h, t_h = umeyama_alignment(pw[hyp_idx], pc_cam[hyp_idx])
    n_audit = min(audit_points, N)
    _, sub = stable_topk(torch.where(valid_score, audit_u, -1.0), n_audit)
    pw_s, uv_s = pw[sub], obs_uv[sub]
    inv_s, vs_s, tr_s = inv_sigma2[sub], valid_score[sub], trust[sub]
    T_h = make_se3(R_h, t_h)
    mono_ur = torch.full((n_audit,), -1.0, dtype=pw.dtype, device=pw.device)
    not_stereo = torch.zeros((n_audit,), dtype=torch.bool, device=pw.device)
    eye6 = torch.eye(6, dtype=pw.dtype, device=pw.device)
    # MSAC-style polish of every hypothesis at once, gate 9 -> 4 -> tight
    for gate_chi2 in (9.0, 4.0, tight_chi2):
        r, J, z_ok = _residuals_jacobians(cam, T_h, pw_s, uv_s, mono_ur, not_stereo)
        chi2 = torch.sum(r * r, dim=-1) * inv_s
        w = torch.where(vs_s & z_ok & (chi2 < gate_chi2), inv_s * tr_s, 0.0)
        H = torch.einsum("hnij,hn,hnik->hjk", J, w, J)
        g = torch.einsum("hnij,hn,hni->hj", J, w, r)
        T_h = exp_se3(_solve6(H + 1e-6 * eye6, g)) @ T_h
    scores = _tight_score(cam, T_h, pw_s, uv_s, inv_s, vs_s, tight_chi2, tr_s)
    best = torch.argmax(scores)
    score_lm = _tight_score(cam, T_lm, pw_s, uv_s, inv_s, vs_s, tight_chi2, tr_s)
    T_best = take_row(T_h, best)
    pc = _project(cam, T_best, pw)
    z = torch.clamp(pc[:, 2], min=1e-6)
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    chi2 = (torch.square(u - obs_uv[:, 0])
            + torch.square(v - obs_uv[:, 1])) * inv_sigma2
    best_mask = (chi2 < 2.0 * tight_chi2) & valid_score & (pc[:, 2] > 0.05)
    return T_best, take_row(scores, best), score_lm, best_mask
