"""Sparse Schur-complement Levenberg-Marquardt bundle adjustment
(counterpart of lc_crf_slam_tpu/ops/schur.py's `solve_ba`, which local BA
runs, and `solve_ba_cg`, the matrix-free variant for the whole map).

Fixed-capacity edge lists, per-edge residuals and Jacobians batched over
all observations, the blocks of each edge summed into its camera, point
and (point, camera) coupling blocks (the coupling held dense, (P, C, 6,
3)), the Schur reduction S = Hcc - W Hpp^-1 W^T as one matrix product, a
dense solve of the reduced (6C, 6C) camera system, point
back-substitution, and an LM accept/reject loop. Fixed cameras enter with
zeroed Jacobians.

The reference has two assemblies: a gather through a (P, C) edge table
(its generic path) and, for local BA, component planes with a one-hot
matmul laid out for TPU tiles (`grid=(C, K)`). The port has one. It sums
every edge, as the grid path does; the table path keeps one edge per
(point, camera) pair, so the two reference paths, and the port with the
table path, differ where a keyframe observes a point twice. The reduced
system is solved by `torch.linalg.solve_ex`, which leaves its status on
the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geometry.camera import Pinhole
from ..geometry.se3 import exp_se3, hat_so3
from .segment_sum import SegmentPlan, segment_plan, segment_sum


class BAProblem(NamedTuple):
    """C cameras, P points, E observations (edges); invalid slots masked."""

    cam_Tcw: torch.Tensor    # (C, 4, 4)
    cam_fixed: torch.Tensor  # (C,) bool: gauge/anchor cameras
    p_xyz: torch.Tensor      # (P, 3)
    p_valid: torch.Tensor    # (P,) bool
    e_cam: torch.Tensor      # (E,) int camera slot
    e_pt: torch.Tensor       # (E,) int point slot
    e_uv: torch.Tensor       # (E, 2) observed pixels
    e_ur: torch.Tensor       # (E,) observed virtual-right u (-1 = mono)
    e_w: torch.Tensor        # (E,) information weight (inv sigma^2 by level)
    e_valid: torch.Tensor    # (E,) bool


class BAStats(NamedTuple):
    cost: torch.Tensor       # robust total cost after optimisation
    n_edges: torch.Tensor    # active edges
    edge_chi2: torch.Tensor  # (E,) final per-edge chi2 (for outlier pruning)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3×3 inverse; the inputs are damped
    SPD point Hessians, so det stays away from 0."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, Cc], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def _project_edges(cam: Pinhole, cam_Tcw, p_xyz, prob: BAProblem):
    """Residuals (E, 3), camera-frame points, inverse depth and the
    positive-depth mask of every edge."""
    T = cam_Tcw[prob.e_cam]
    pc = torch.einsum("eij,ej->ei", T[:, :3, :3], p_xyz[prob.e_pt]) + T[:, :3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_ok = z > 1e-3
    inv_z = 1.0 / torch.where(z_ok, z, 1.0)
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    r = torch.stack([u - prob.e_uv[:, 0], v - prob.e_uv[:, 1],
                     torch.where(prob.e_ur >= 0, ur - prob.e_ur, 0.0)], dim=-1)
    return r, T[:, :3, :3], pc, inv_z, z_ok


def _edge_residuals(cam: Pinhole, cam_Tcw, p_xyz, prob: BAProblem):
    """Residual (E, 3), camera Jacobian (E, 3, 6), point Jacobian (E, 3, 3)
    and the positive-depth mask (E,)."""
    r, R, pc, inv_z, z_ok = _project_edges(cam, cam_Tcw, p_xyz, prob)
    x, y = pc[:, 0], pc[:, 1]
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(inv_z)
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    dr = du + torch.stack([zero, zero, cam.bf * inv_z2], -1)
    dr = torch.where((prob.e_ur >= 0)[:, None], dr, 0.0)
    d_pc = torch.stack([du, dv, dr], dim=-2)                     # (E, 3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    J_cam = d_pc @ torch.cat([eye, -hat_so3(pc)], dim=-1)        # (E, 3, 6)
    return r, J_cam, d_pc @ R, z_ok


def _robust_weights(r, e_w, active, huber_delta):
    """(per-edge chi2, Huber IRLS weight, robust total cost)."""
    chi2 = torch.sum(r * r, dim=-1) * e_w
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w_huber = torch.where(s <= huber_delta, 1.0, huber_delta / s)
    w = torch.where(active, e_w * w_huber, 0.0)
    rho = torch.where(s <= huber_delta, chi2,
                      2.0 * huber_delta * s - huber_delta * huber_delta)
    return chi2, w, torch.sum(torch.where(active, rho, 0.0))


class EdgePlans(NamedTuple):
    """The segment-sum plans of a problem's fixed edge targets: its
    cameras, its points and its (point, camera) pairs."""

    cam: SegmentPlan
    pt: SegmentPlan
    pair: Optional[SegmentPlan]


def edge_plans(prob: BAProblem, C: int, P: int, pairs: bool = True) -> EdgePlans:
    """The plans of `prob`'s edges over C cameras and P points (and with
    `pairs` their P * C (point, camera) pairs, which only the dense
    coupling of `_partial_blocks` sums into), built once per solve: the
    targets do not change between iterations."""
    e_cam, e_pt = prob.e_cam.long(), prob.e_pt.long()
    return EdgePlans(segment_plan(e_cam, C), segment_plan(e_pt, P),
                     segment_plan(e_pt * C + e_cam, P * C) if pairs else None)


def _partial_blocks(cam: Pinhole, cam_Tcw, p_xyz, prob: BAProblem, huber_delta,
                    plans: EdgePlans):
    """The normal equations' blocks summed over the edges of `prob` (all
    of them, or one rank's shard in `parallel/dist_ba.py`): camera Hcc
    (C, 6, 6) and g_c (C, 6), point Hpp (P, 3, 3) and g_p (P, 3), and the
    coupling W as dense (P, C, 6, 3) blocks.

    Every edge is summed into its blocks, in edge order (`segment_sum`).
    The reference's generic path gathers through a (P, C) table that holds
    one edge per (point, camera) pair and so drops the others of a pair
    that a keyframe observes twice; its grid path, which local BA runs,
    sums them, as here."""
    C, P = cam_Tcw.shape[0], p_xyz.shape[0]
    r, J_cam, J_pt, z_ok = _edge_residuals(cam, cam_Tcw, p_xyz, prob)
    active = prob.e_valid & z_ok & prob.p_valid[prob.e_pt]
    _, w, _ = _robust_weights(r, prob.e_w, active, huber_delta)
    # gauge: fixed cameras contribute no camera Jacobian
    J_cam = J_cam * (~prob.cam_fixed[prob.e_cam]).to(J_cam.dtype)[:, None, None]
    wJc = w[:, None, None] * J_cam
    wJp = w[:, None, None] * J_pt
    Hcc = segment_sum(torch.einsum("eij,eik->ejk", wJc, J_cam), plans.cam)
    g_c = segment_sum(torch.einsum("eij,ei->ej", wJc, r), plans.cam)
    Hpp = segment_sum(torch.einsum("eij,eik->ejk", wJp, J_pt), plans.pt)
    g_p = segment_sum(torch.einsum("eij,ei->ej", wJp, r), plans.pt)
    Wpc = segment_sum(torch.einsum("eij,eik->ejk", wJc, J_pt), plans.pair).reshape(P, C, 6, 3)
    return Hcc, g_c, Hpp, g_p, Wpc


def _point_schur(Hpp, g_p, Wpc, lam):
    """The points' share of the reduced camera system: the damped point
    inverses Hpp^-1, T = W Hpp^-1 (P, C, 6, 3), W Hpp^-1 W^T as one
    (6C, 3P) x (3P, 6C) product, never a (P, 6C, 6C) tensor, and
    W Hpp^-1 g_p (C, 6)."""
    P, C = Wpc.shape[:2]
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_inv = inv3x3(Hpp + lam * torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1))
                     + 1e-6 * eye3)
    Tpc = torch.einsum("pcia,pab->pcib", Wpc, Hpp_inv)          # (P, C, 6, 3)
    Tm = Tpc.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    Wm = Wpc.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    return Hpp_inv, Tpc, Tm @ Wm.T, torch.einsum("pcia,pa->ci", Tpc, g_p)


def _camera_step(Hcc, g_c, S_red, rhs_red, cam_fixed, lam):
    """Solve the reduced system (Hcc_d - W Hpp^-1 W^T) dc = -(g_c -
    W Hpp^-1 g_p) densely; fixed cameras do not move."""
    C = Hcc.shape[0]
    Hcc_d = Hcc + lam * torch.diag_embed(torch.diagonal(Hcc, dim1=-2, dim2=-1))
    S = -S_red + torch.block_diag(*Hcc_d.unbind(0))
    # keep fixed/empty camera blocks invertible
    fixed_diag = cam_fixed.to(S.dtype)[:, None].expand(C, 6).reshape(-1) \
        + (torch.abs(torch.diagonal(S)) < 1e-8).to(S.dtype)
    S = S + torch.diag(fixed_diag + 1e-6)
    rhs = (g_c - rhs_red).reshape(C * 6)
    delta_c = -torch.linalg.solve_ex(S, rhs[:, None])[0][:, 0].reshape(C, 6)
    return delta_c * (~cam_fixed).to(delta_c.dtype)[:, None]


def _back_substitute(Hpp, g_p, Wpc, Hpp_inv, p_valid, delta_c):
    """dp = -Hpp^-1 (g_p + sum_c W^T dc) for the valid, observed points."""
    Wt_dc = torch.einsum("pcia,ci->pa", Wpc, delta_c)
    delta_p = -torch.einsum("pab,pb->pa", Hpp_inv, g_p + Wt_dc)
    has_obs = torch.einsum("pii->p", Hpp) > 0
    return torch.where((p_valid & has_obs)[:, None], delta_p, 0.0)


def _solve_from_blocks(cam_Tcw, p_xyz, prob: BAProblem, blocks, lam):
    """Schur solve and back-substitution from the summed blocks; returns
    the candidate (cam_Tcw', p_xyz')."""
    Hcc, g_c, Hpp, g_p, Wpc = blocks
    Hpp_inv, _, S_red, rhs_red = _point_schur(Hpp, g_p, Wpc, lam)
    delta_c = _camera_step(Hcc, g_c, S_red, rhs_red, prob.cam_fixed, lam)
    delta_p = _back_substitute(Hpp, g_p, Wpc, Hpp_inv, prob.p_valid, delta_c)
    return exp_se3(delta_c) @ cam_Tcw, p_xyz + delta_p


def solve_ba(cam: Pinhole, prob: BAProblem, n_iters: int = 10,
             huber_delta: float = 2.7955, init_lambda: float = 1e-4,
             huber_delta_mono: float | None = 2.4477,
             ) -> Tuple[torch.Tensor, torch.Tensor, BAStats]:
    """LM loop with accept/reject; returns (cam_Tcw', p_xyz', stats). The
    Huber delta is per edge: `huber_delta` on stereo edges,
    `huber_delta_mono` on mono ones (None: one delta for all)."""
    if huber_delta_mono is not None:
        huber_delta = torch.where(prob.e_ur >= 0, huber_delta, huber_delta_mono)

    def total_cost(cam_Tcw, p_xyz):
        r, _, _, _, z_ok = _project_edges(cam, cam_Tcw, p_xyz, prob)
        active = prob.e_valid & z_ok & prob.p_valid[prob.e_pt]
        chi2, _, cost = _robust_weights(r, prob.e_w, active, huber_delta)
        return chi2, cost

    cam_Tcw, p_xyz = prob.cam_Tcw, prob.p_xyz
    plans = edge_plans(prob, cam_Tcw.shape[0], p_xyz.shape[0])
    lam = torch.full((), init_lambda, dtype=torch.float32, device=p_xyz.device)
    _, f_old = total_cost(cam_Tcw, p_xyz)
    for _ in range(n_iters):
        blocks = _partial_blocks(cam, cam_Tcw, p_xyz, prob, huber_delta, plans)
        cam_new, p_new = _solve_from_blocks(cam_Tcw, p_xyz, prob, blocks, lam)
        _, f_new = total_cost(cam_new, p_new)
        # a non-finite candidate is never adopted
        accept = (f_new < f_old) & torch.all(torch.isfinite(cam_new)) \
            & torch.all(torch.isfinite(p_new))
        cam_Tcw = torch.where(accept, cam_new, cam_Tcw)
        p_xyz = torch.where(accept, p_new, p_xyz)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e6)
        f_old = torch.where(accept, f_new, f_old)
    chi2, cost = total_cost(cam_Tcw, p_xyz)
    return cam_Tcw, p_xyz, BAStats(
        cost=cost, n_edges=torch.sum(prob.e_valid.to(torch.int32)), edge_chi2=chi2)


def _cg_lm_step(cam: Pinhole, cam_Tcw, p_xyz, prob: BAProblem, lam, huber_delta,
                cg_iters: int, plans: EdgePlans):
    """One assembly + matrix-free Schur solve + back-substitution of
    `solve_ba_cg`; returns the candidate (cam_Tcw', p_xyz')."""
    C, P = cam_Tcw.shape[0], p_xyz.shape[0]
    e_cam, e_pt = prob.e_cam.long(), prob.e_pt.long()
    r, J_cam, J_pt, z_ok = _edge_residuals(cam, cam_Tcw, p_xyz, prob)
    active = prob.e_valid & z_ok & prob.p_valid[e_pt]
    _, w, _ = _robust_weights(r, prob.e_w, active, huber_delta)
    J_cam = J_cam * (~prob.cam_fixed[e_cam]).to(J_cam.dtype)[:, None, None]
    wJc = w[:, None, None] * J_cam
    wJp = w[:, None, None] * J_pt
    # block-diagonal Hessians and gradients
    Hcc = segment_sum(torch.einsum("eij,eik->ejk", wJc, J_cam), plans.cam)
    g_c = segment_sum(torch.einsum("eij,ei->ej", wJc, r), plans.cam)
    Hpp = segment_sum(torch.einsum("eij,eik->ejk", wJp, J_pt), plans.pt)
    g_p = segment_sum(torch.einsum("eij,ei->ej", wJp, r), plans.pt)
    # per-edge coupling block B_e = J_cam^T W J_pt, (E, 6, 3)
    B = torch.einsum("eij,eik->ejk", wJc, J_pt)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_inv = inv3x3(Hpp + lam * torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1))
                     + 1e-6 * eye3)
    Hcc_d = Hcc + lam * torch.diag_embed(torch.diagonal(Hcc, dim1=-2, dim2=-1))
    # fixed and observation-free cameras stay where they are
    pin = (prob.cam_fixed | (torch.einsum("cii->c", Hcc) < 1e-8))[:, None]

    def to_points(x):
        """sum_e B_e^T x(c(e)) into each edge's point; x (C, 6) -> (P, 3)."""
        return segment_sum(torch.einsum("eji,ej->ei", B, x[e_cam]), plans.pt)

    def to_cameras(v):
        """sum_e B_e v(p(e)) into each edge's camera; v (P, 3) -> (C, 6)."""
        return segment_sum(torch.einsum("eab,eb->ea", B, v[e_pt]), plans.cam)

    def matvec(x):
        """(Hcc_d - W Hpp^-1 W^T) x, streamed over the edges."""
        whw = to_cameras(torch.einsum("pab,pb->pa", Hpp_inv, to_points(x)))
        y = torch.einsum("cab,cb->ca", Hcc_d, x) - whw
        return torch.where(pin, x, y + 1e-6 * x)

    # exact block diagonal of S for the preconditioner, edge by edge:
    # D_c = Hcc_d(c) - sum_e B_e Hpp_inv(p(e)) B_e^T, contracted in two
    # steps of (E, 6, 3) and (E, 6, 6)
    BH = B @ Hpp_inv[e_pt]
    S_diag = Hcc_d - segment_sum(BH @ B.transpose(-1, -2), plans.cam)
    Pinv = torch.linalg.inv_ex(
        torch.where(pin[:, :, None], eye6, S_diag + 1e-6 * eye6))[0]

    rhs = g_c - to_cameras(torch.einsum("pab,pb->pa", Hpp_inv, g_p))
    r_cg = -torch.where(pin, 0.0, rhs)
    x = torch.zeros_like(r_cg)
    z = torch.einsum("cij,cj->ci", Pinv, r_cg)
    p = z
    for _ in range(cg_iters):
        Ap = matvec(p)
        rz = torch.sum(r_cg * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r_cg = r_cg - alpha * Ap
        z = torch.einsum("cij,cj->ci", Pinv, r_cg)
        p = z + torch.sum(r_cg * z) / torch.clamp(rz, min=1e-20) * p
    delta_c = x * (~prob.cam_fixed).to(x.dtype)[:, None]
    # back-substitute points: dp = -Hpp^-1 (g_p + sum_e B_e^T dc(e))
    delta_p = -torch.einsum("pab,pb->pa", Hpp_inv, g_p + to_points(delta_c))
    has_obs = torch.einsum("pii->p", Hpp) > 0
    delta_p = torch.where((prob.p_valid & has_obs)[:, None], delta_p, 0.0)
    return exp_se3(delta_c) @ cam_Tcw, p_xyz + delta_p


def solve_ba_cg(cam: Pinhole, prob: BAProblem, n_iters: int = 10, cg_iters: int = 48,
                huber_delta: float = 2.7955, init_lambda: float = 1e-4,
                huber_delta_mono: float | None = 2.4477,
                ) -> Tuple[torch.Tensor, torch.Tensor, BAStats]:
    """Joint Schur-complement LM at full-map scale, matrix-free (global
    BA): where `solve_ba`'s dense (P, C, 6, 3) coupling would not fit, the
    reduced camera system S = Hcc - W Hpp^-1 W^T is never formed. Each of
    the `cg_iters` (fixed, no early exit) preconditioned-CG matvecs
    streams over the edge list: gather the camera's vector, through the
    edge's 6×3 coupling block into its point, the damped 3×3 point
    inverse, and back. The block-Jacobi preconditioner holds the exact
    diagonal 6×6 blocks of S. LM accept/reject and the per-edge Huber delta
    as `solve_ba`; `edge_chi2` comes back as zeros, as in the reference.
    The sums over edges run in edge order (`segment_sum`), so a run on
    the card repeats bit for bit."""
    if huber_delta_mono is not None:
        huber_delta = torch.where(prob.e_ur >= 0, huber_delta, huber_delta_mono)

    def total_cost(cam_Tcw, p_xyz):
        r, _, _, _, z_ok = _project_edges(cam, cam_Tcw, p_xyz, prob)
        active = prob.e_valid & z_ok & prob.p_valid[prob.e_pt.long()]
        return _robust_weights(r, prob.e_w, active, huber_delta)[2]

    cam_Tcw, p_xyz = prob.cam_Tcw, prob.p_xyz
    plans = edge_plans(prob, cam_Tcw.shape[0], p_xyz.shape[0], pairs=False)
    lam = torch.full((), init_lambda, dtype=torch.float32, device=p_xyz.device)
    f_old = total_cost(cam_Tcw, p_xyz)
    for _ in range(n_iters):
        cam_new, p_new = _cg_lm_step(cam, cam_Tcw, p_xyz, prob, lam, huber_delta,
                                     cg_iters, plans)
        f_new = total_cost(cam_new, p_new)
        # a non-finite candidate is never adopted: the robust cost sums
        # active edges only, so an inf in a weakly constrained coordinate
        # could hide from f_new while poisoning the state
        accept = (f_new < f_old) & torch.all(torch.isfinite(cam_new)) \
            & torch.all(torch.isfinite(p_new))
        cam_Tcw = torch.where(accept, cam_new, cam_Tcw)
        p_xyz = torch.where(accept, p_new, p_xyz)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e6)
        f_old = torch.where(accept, f_new, f_old)
    return cam_Tcw, p_xyz, BAStats(
        cost=f_old, n_edges=torch.sum(prob.e_valid.to(torch.int32)),
        edge_chi2=torch.zeros_like(prob.e_w))


def solve_ba_with_outlier_rounds(cam: Pinhole, prob: BAProblem, iters_1: int = 5,
                                 iters_2: int = 10, huber_delta: float = 2.7955,
                                 chi2_mono: float = 5.991, chi2_stereo: float = 7.815):
    """LocalBundleAdjustment's schedule: iters_1 LM iterations, prune chi2
    outliers, iters_2 more. Returns (cam_Tcw, p_xyz, kept edges, stats)."""
    cam_Tcw, p_xyz, stats = solve_ba(cam, prob, iters_1, huber_delta)
    chi2_th = torch.where(prob.e_ur >= 0, chi2_stereo, chi2_mono)
    keep = prob.e_valid & (stats.edge_chi2 < chi2_th)
    prob2 = prob._replace(cam_Tcw=cam_Tcw, p_xyz=p_xyz, e_valid=keep)
    cam_Tcw, p_xyz, stats2 = solve_ba(cam, prob2, iters_2, huber_delta)
    return cam_Tcw, p_xyz, keep & (stats2.edge_chi2 < chi2_th), stats2
