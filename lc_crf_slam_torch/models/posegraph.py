"""Pose-graph optimisation over relative-pose constraints (counterpart of
the SE(3) half of lc_crf_slam_tpu/models/posegraph.py;
Optimizer::OptimizeEssentialGraph with the scale fixed, as RGB-D runs it).

Levenberg-Marquardt over the keyframe poses with residuals
    r_e = log(T_i T_j^-1 T_ij_meas^-1),
analytic per-edge Jacobians (J_i = Jl^-1(r), J_j = -Jl^-1(-r) Ad(T_ij)),
and the damped normal equations solved by block-Jacobi preconditioned
conjugate gradients whose matvec is one gather and one segment sum over
the edges: O(E) memory, never a dense Hessian. A fixed 20 LM x 64 CG
iterations with no early exit, as the reference. The sums over edges add
both ends of every edge in one `segment_sum` (all i ends, then all j
ends, each node's in that order: the reference's order on the CPU, and
the same on a card, so a correction there repeats bit for bit); its plan
is built once per optimisation.

The Sim(3) graph (`Sim3Graph`, `optimize_pose_graph_sim3`: the monocular
loop's essential graph, whose free scale absorbs scale drift) has the
same structure over 7-dim tangents [upsilon, omega, sigma]. Its per-edge
Jacobians are forward-mode derivatives of the residual at zero
perturbation, as the reference takes with `jax.jacfwd`: one `jvp` over
the edges replicated 14 times (each replica carries one tangent
direction of one end), instead of a vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import exp_se3, hat_so3, log_se3, se3_inverse
from ..geometry.sim3 import exp_sim3, log_sim3, sim3_compose, sim3_inverse
from ..ops.segment_sum import SegmentPlan, segment_plan, segment_sum


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


def _lm_step(J: torch.Tensor, r0: torch.Tensor, w: torch.Tensor, plan: SegmentPlan,
             free: torch.Tensor, lam: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """The damped Gauss-Newton step (n_nodes, d) of one LM iteration:
    both ends' Jacobians J (2E, d, d) (all i ends, then all j ends, the
    segment-sum plan's targets over its n_nodes), residuals r0 (E, d),
    edge weights w (E,), `free` (n_nodes, 1) nodes. The gradient and the block
    diagonal of H are summed over the edges' ends in one `segment_sum`
    each; block-Jacobi preconditioned CG solves H delta = -grad with a
    matrix-free matvec."""
    E, d = r0.shape
    ends, n_nodes = plan.idx, plan.n
    dev, dtype = r0.device, r0.dtype
    eye = torch.eye(d, dtype=dtype, device=dev)
    wJ = torch.cat([w, w])[:, None, None] * J
    grad = segment_sum(torch.einsum("eij,ei->ej", wJ, torch.cat([r0, r0])), plan) * free
    D = segment_sum(torch.einsum("eik,eil->ekl", wJ, J), plan)
    dvec = torch.diagonal(D, dim1=-2, dim2=-1)
    D_damped = D + lam * torch.diag_embed(dvec) + 1e-6 * eye
    # pinned nodes become identity blocks
    P = torch.linalg.inv_ex(torch.where(free[:, :, None], D_damped, eye))[0]
    diag = lam * dvec + 1e-6

    def matvec(x):                                    # H_damped @ x
        u = torch.einsum("eij,ej->ei", J, x[ends])
        u = (u[:E] + u[E:]) * w[:, None]
        y = segment_sum(torch.einsum("eij,ei->ej", J, torch.cat([u, u])), plan)
        return torch.where(free, y + diag * x, x)

    x = torch.zeros((n_nodes, d), dtype=dtype, device=dev)
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
    return x


def optimize_pose_graph(g: PoseGraph, n_iters: int = 20, lam0: float = 1e-4,
                        cg_iters: int = 64) -> torch.Tensor:
    """The optimised (F, 4, 4) poses. Left-multiplicative updates
    T_i <- exp(xi_i) T_i; fixed and invalid nodes stay where they are."""
    F, E = g.Tcw.shape[0], g.e_i.shape[0]
    dev, dtype = g.Tcw.device, g.Tcw.dtype
    free = (g.node_valid & ~g.node_fixed)[:, None]
    w = torch.where(g.e_valid, g.e_w, 0.0)
    ends = torch.cat([g.e_i, g.e_j]).long()         # all i ends, then all j ends
    plan = segment_plan(ends, F)
    rel_inv = se3_inverse(g.e_rel)
    AdM = _adjoint(g.e_rel)

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
        x = _lm_step(J, r0, w, plan, free, lam, cg_iters)
        T_new = exp_se3(x * free) @ Tcw
        r_new = residuals(T_new)
        accept = cost(r_new) < cost(r0)
        Tcw = torch.where(accept, T_new, Tcw)
        r0 = torch.where(accept, r_new, r0)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e4)
    return Tcw


class Sim3Graph(NamedTuple):
    """Sim(3) pose graph (OptimizeEssentialGraph over Sim3 vertices).
    Node poses are world->camera Sim3 (s, R, t)."""

    s: torch.Tensor           # (F,) node scales
    R: torch.Tensor           # (F, 3, 3)
    t: torch.Tensor           # (F, 3)
    node_valid: torch.Tensor  # (F,) bool
    node_fixed: torch.Tensor  # (F,) bool
    e_i: torch.Tensor         # (E,) int
    e_j: torch.Tensor         # (E,) int
    e_s: torch.Tensor         # (E,) measured S_i S_j^-1 scale
    e_R: torch.Tensor         # (E, 3, 3)
    e_t: torch.Tensor         # (E, 3)
    e_w: torch.Tensor         # (E,) weight
    e_valid: torch.Tensor     # (E,) bool


def _sim3_residual(Si, Sj, Srel) -> torch.Tensor:
    """log(S_i S_j^-1 S_rel^-1), batched."""
    return log_sim3(sim3_compose(Si, sim3_compose(sim3_inverse(Sj), sim3_inverse(Srel))))


def sim3_edge_residuals(S, g: Sim3Graph) -> torch.Tensor:
    """(E, 7) residual twists r_e = log(S_i S_j^-1 S_rel^-1)."""
    s, R, t = S
    i, j = g.e_i.long(), g.e_j.long()
    return _sim3_residual((s[i], R[i], t[i]), (s[j], R[j], t[j]), (g.e_s, g.e_R, g.e_t))


def _sim3_edge_jacobians(Si, Sj, Srel) -> torch.Tensor:
    """(2E, 7, 7): d r_e / d xi_i, then d r_e / d xi_j, for left
    perturbations S <- exp(xi) S at xi = 0, by forward mode. The edges are
    replicated 14 times; replica k carries the unit tangent k of xi_i (k <
    7) or of xi_j (k >= 7)."""
    E = Si[0].shape[0]
    dtype, dev = Si[0].dtype, Si[0].device
    rep = lambda S: tuple(x.expand((14,) + tuple(x.shape)) for x in S)
    Si, Sj, Srel = rep(Si), rep(Sj), rep(Srel)
    eye = torch.eye(7, dtype=dtype, device=dev)
    zero = torch.zeros((7, 7), dtype=dtype, device=dev)
    t_i = torch.cat([eye, zero])[:, None, :].expand(14, E, 7)
    t_j = torch.cat([zero, eye])[:, None, :].expand(14, E, 7)
    xi0 = torch.zeros((14, E, 7), dtype=dtype, device=dev)

    def res(xi_i, xi_j):
        return _sim3_residual(sim3_compose(exp_sim3(xi_i), Si),
                              sim3_compose(exp_sim3(xi_j), Sj), Srel)

    _, tangent = torch.func.jvp(res, (xi0, xi0), (t_i, t_j))     # (14, E, 7)
    # J[e, r, p] = d r_r / d xi_p
    return torch.cat([tangent[:7].permute(1, 2, 0), tangent[7:].permute(1, 2, 0)])


def optimize_pose_graph_sim3(g: Sim3Graph, n_iters: int = 20, lam0: float = 1e-4,
                             cg_iters: int = 64, fix_scale: bool = False):
    """The optimised (s, R, t) node tuples. The same block-Jacobi PCG
    Levenberg-Marquardt as `optimize_pose_graph` over 7-dim blocks;
    `fix_scale=True` pins every node's sigma coordinate (the reference's
    bFixScale)."""
    F, E = g.s.shape[0], g.e_i.shape[0]
    dev, dtype = g.t.device, g.t.dtype
    free = (g.node_valid & ~g.node_fixed)[:, None]
    w = torch.where(g.e_valid, g.e_w, 0.0)
    ends = torch.cat([g.e_i, g.e_j]).long()         # all i ends, then all j ends
    plan = segment_plan(ends, F)
    # tangent coordinates: sigma dropped when the scale is fixed
    coord = (torch.arange(7, device=dev) < (6 if fix_scale else 7)).to(dtype)
    Srel = (g.e_s, g.e_R, g.e_t)

    def ends_of(S):
        s, R, t = S
        return (s[ends[:E]], R[ends[:E]], t[ends[:E]]), (s[ends[E:]], R[ends[E:]], t[ends[E:]])

    def cost(r):
        return torch.sum(w[:, None] * r * r)

    s, R, t = g.s, g.R, g.t
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    r0 = _sim3_residual(*ends_of((s, R, t)), Srel)
    for _ in range(n_iters):
        J = _sim3_edge_jacobians(*ends_of((s, R, t)), Srel) * coord   # (2E, 7, 7)
        x = _lm_step(J, r0, w, plan, free, lam, cg_iters)
        ds, dR, dt = exp_sim3(x * free * coord)
        S_new = (ds * s, dR @ R, ds[:, None] * torch.einsum("fij,fj->fi", dR, t) + dt)
        r_new = _sim3_residual(*ends_of(S_new), Srel)
        accept = cost(r_new) < cost(r0)
        s = torch.where(accept, S_new[0], s)
        R = torch.where(accept, S_new[1], R)
        t = torch.where(accept, S_new[2], t)
        r0 = torch.where(accept, r_new, r0)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e4)
    return s, R, t
