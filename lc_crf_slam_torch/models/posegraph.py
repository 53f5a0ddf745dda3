"""Pose-graph optimisation over relative-pose constraints (counterpart of
the SE(3) half of lc_crf_slam_tpu/models/posegraph.py;
Optimizer::OptimizeEssentialGraph with the scale fixed, as RGB-D runs it).

Levenberg-Marquardt over the keyframe poses with residuals
    r_e = log(T_i T_j^-1 T_ij_meas^-1),
analytic per-edge Jacobians (J_i = Jl^-1(r), J_j = -Jl^-1(-r) Ad(T_ij)),
and the damped normal equations solved by block-Jacobi preconditioned
conjugate gradients whose matvec is one gather and one `index_add_` over
the edges: O(E) memory, never a dense Hessian. A fixed 20 LM x 64 CG
iterations with no early exit, as the reference. The sums over edges add
both ends of every edge in one `index_add_` (all i ends, then all j ends:
the reference's order on the CPU; float atomics on a card, so a
correction there is not bitwise repeatable).

The Sim(3) graph (`Sim3Graph`, `optimize_pose_graph_sim3`) belongs to the
monocular loop and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import exp_se3, hat_so3, log_se3, se3_inverse


def _ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint of a twist, (..., 6) -> (..., 6, 6); (v, w) order."""
    hv, hw = hat_so3(xi[..., :3]), hat_so3(xi[..., 3:])
    return torch.cat([torch.cat([hw, hv], dim=-1),
                      torch.cat([torch.zeros_like(hw), hw], dim=-1)], dim=-2)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of a transform, (..., 4, 4) -> (..., 6, 6); (v, w) order."""
    R = T[..., :3, :3]
    tR = hat_so3(T[..., :3, 3]) @ R
    return torch.cat([torch.cat([R, tR], dim=-1),
                      torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def _jl_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of the SE(3) log, second-order series (the
    residuals are small once the graph is near consistency)."""
    ad = _ad_se3(xi)
    eye = torch.eye(6, dtype=xi.dtype, device=xi.device)
    return eye - 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


class PoseGraph(NamedTuple):
    Tcw: torch.Tensor         # (F, 4, 4) initial keyframe poses
    node_valid: torch.Tensor  # (F,) bool
    node_fixed: torch.Tensor  # (F,) bool (loop keyframe / keyframe 0 anchored)
    e_i: torch.Tensor         # (E,) int
    e_j: torch.Tensor         # (E,) int
    e_rel: torch.Tensor       # (E, 4, 4) measured T_i T_j^-1
    e_w: torch.Tensor         # (E,) weight
    e_valid: torch.Tensor     # (E,) bool


def edge_residuals(Tcw: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """(E, 6) residual twists."""
    return log_se3(Tcw[g.e_i.long()] @ se3_inverse(Tcw[g.e_j.long()])
                   @ se3_inverse(g.e_rel))


def optimize_pose_graph(g: PoseGraph, n_iters: int = 20, lam0: float = 1e-4,
                        cg_iters: int = 64) -> torch.Tensor:
    """The optimised (F, 4, 4) poses. Left-multiplicative updates
    T_i <- exp(xi_i) T_i; fixed and invalid nodes stay where they are."""
    F, E = g.Tcw.shape[0], g.e_i.shape[0]
    dev, dtype = g.Tcw.device, g.Tcw.dtype
    free = (g.node_valid & ~g.node_fixed)[:, None]
    w = torch.where(g.e_valid, g.e_w, 0.0)
    w2 = torch.cat([w, w])
    ends = torch.cat([g.e_i, g.e_j]).long()         # all i ends, then all j ends
    rel_inv = se3_inverse(g.e_rel)
    AdM = _adjoint(g.e_rel)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def residuals(T):
        Te = T[ends]
        return log_se3(Te[:E] @ se3_inverse(Te[E:]) @ rel_inv)

    def cost(r):
        return torch.sum(w[:, None] * r * r)

    Tcw = g.Tcw
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    r0 = residuals(Tcw)
    for _ in range(n_iters):
        # both ends' Jacobians stacked (2E, 6, 6): J_i, then J_j
        J = torch.cat([_jl_inv(r0), -_jl_inv(-r0) @ AdM])
        wJ = w2[:, None, None] * J
        r2 = torch.cat([r0, r0])
        # gradient and block diagonal of H, summed over the edges' ends
        grad = torch.zeros((F, 6), dtype=dtype, device=dev).index_add_(
            0, ends, torch.einsum("eij,ei->ej", wJ, r2)) * free
        D = torch.zeros((F, 6, 6), dtype=dtype, device=dev).index_add_(
            0, ends, torch.einsum("eik,eil->ekl", wJ, J))
        dvec = torch.diagonal(D, dim1=-2, dim2=-1)
        D_damped = D + lam * torch.diag_embed(dvec) + 1e-6 * eye6
        # pinned nodes become identity blocks
        P = torch.linalg.inv_ex(torch.where(free[:, :, None], D_damped, eye6))[0]
        diag = lam * dvec + 1e-6

        def matvec(x):                                    # H_damped @ x
            u = torch.einsum("eij,ej->ei", J, x[ends])
            u = (u[:E] + u[E:]) * w[:, None]
            y = torch.zeros((F, 6), dtype=dtype, device=dev).index_add_(
                0, ends, torch.einsum("eij,ei->ej", J, torch.cat([u, u])))
            return torch.where(free, y + diag * x, x)

        # preconditioned CG for H delta = -grad
        x = torch.zeros((F, 6), dtype=dtype, device=dev)
        r_cg = -grad
        z = torch.einsum("fij,fj->fi", P, r_cg)
        p = z
        for _ in range(cg_iters):
            Ap = matvec(p)
            rz = torch.sum(r_cg * z)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            r_cg = r_cg - alpha * Ap
            z = torch.einsum("fij,fj->fi", P, r_cg)
            beta = torch.sum(r_cg * z) / torch.clamp(rz, min=1e-20)
            p = z + beta * p
        T_new = exp_se3(x * free) @ Tcw
        r_new = residuals(T_new)
        accept = cost(r_new) < cost(r0)
        Tcw = torch.where(accept, T_new, Tcw)
        r0 = torch.where(accept, r_new, r0)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e4)
    return Tcw
