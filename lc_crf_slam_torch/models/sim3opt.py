"""Sim3 relative-transform refinement (counterpart of
lc_crf_slam_tpu/models/sim3opt.py; Optimizer::OptimizeSim3).

After the Horn RANSAC yields S12 between the current and the loop
keyframe, refine it over bidirectional reprojection (KF2's points through
S12 into KF1's image, KF1's through S12^-1 into KF2's): a fixed number of
Gauss-Newton iterations on the 7 tangent coordinates [upsilon, omega,
sigma] of a left update exp(xi) ∘ S12, both directions stacked, Huber
weights, chi² reclassification after every step. `fix_scale` pins sigma
(RGB-D).

The reference differentiates the residuals with `jax.jacfwd` at xi = 0;
here the same (2N, 2, 7) Jacobian is written out, one batched product per
direction: d(exp(xi) q)/dxi = [I, -hat(q), q] at xi = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Pinhole
from ..geometry.se3 import hat_so3
from ..geometry.sim3 import exp_sim3, sim3_apply, sim3_compose, sim3_inverse


class Sim3Refine(NamedTuple):
    s: torch.Tensor          # () refined scale
    R: torch.Tensor          # (3, 3)
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool: both directions within chi2
    n_inliers: torch.Tensor  # () int32


def _proj(cam: Pinhole, pc: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(pc[..., 2], min=1e-6)
    return torch.stack([cam.fx * pc[..., 0] / z + cam.cx,
                        cam.fy * pc[..., 1] / z + cam.cy], dim=-1)


def _proj_jacobian(cam: Pinhole, pc: torch.Tensor) -> torch.Tensor:
    """d _proj / d pc, (N, 2, 3); the clamped depth has no derivative."""
    z_raw = pc[..., 2]
    z = torch.clamp(z_raw, min=1e-6)
    dz = (z_raw > 1e-6).to(pc.dtype) / (z * z)
    zero = torch.zeros_like(z)
    return torch.stack([
        torch.stack([cam.fx / z, zero, -cam.fx * pc[..., 0] * dz], dim=-1),
        torch.stack([zero, cam.fy / z, -cam.fy * pc[..., 1] * dz], dim=-1)], dim=-2)


def _tangent_basis(q: torch.Tensor) -> torch.Tensor:
    """d(exp(xi) q)/dxi at xi = 0: (N, 3, 7) = [I | -hat(q) | q]."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    return torch.cat([eye, -hat_so3(q), q[..., None]], dim=-1)


def optimize_sim3(
    cam: Pinhole,
    S12,                         # initial (s, R, t): maps KF2-cam -> KF1-cam
    pc1: torch.Tensor,           # (N, 3) matched points in KF1's camera frame
    pc2: torch.Tensor,           # (N, 3) matched points in KF2's camera frame
    uv1: torch.Tensor,           # (N, 2) observed pixels in KF1
    uv2: torch.Tensor,           # (N, 2) observed pixels in KF2
    valid: torch.Tensor,         # (N,) bool
    inv_sigma2: torch.Tensor,    # (N,) information weight by pyramid level
    fix_scale: bool = True,
    n_iters: int = 8,
    huber_delta: float = 3.1623,   # sqrt(10): OptimizeSim3's deltaHuber
    chi2_th: float = 9.21,         # 2-dof 99% gate
) -> Sim3Refine:
    """Gauss-Newton refinement of S12 with bidirectional reprojection."""
    s, R, t = S12
    dev, dtype = t.device, t.dtype
    coord = torch.ones((7,), dtype=dtype, device=dev)
    if fix_scale:
        coord = torch.cat([coord[:6], coord.new_zeros(1)])
    # keeps the pinned coordinate invertible
    reg = torch.diag(1e-6 + (1.0 - coord))
    w_lvl = torch.cat([inv_sigma2, inv_sigma2])
    valid2 = torch.cat([valid, valid])
    N = pc1.shape[0]

    def points(S):
        """KF2's points in KF1's frame and KF1's points in KF2's."""
        return sim3_apply(S, pc2), sim3_apply(sim3_inverse(S), pc1)

    def chi2_of(q1, q2):
        r = torch.cat([_proj(cam, q1) - uv1, _proj(cam, q2) - uv2])     # (2N, 2)
        return r, torch.sum(r * r, dim=-1) * w_lvl

    keep = torch.ones((2 * N,), dtype=torch.bool, device=dev)
    q1, q2 = points((s, R, t))
    for _ in range(n_iters):
        r, chi2 = chi2_of(q1, q2)
        # r1 = proj(exp(xi) q1) - uv1;  r2 = proj(S0^-1 exp(-xi) pc1) - uv2
        J1 = _proj_jacobian(cam, q1) @ _tangent_basis(q1)
        J2 = _proj_jacobian(cam, q2) @ ((R.T / s) @ -_tangent_basis(pc1))
        J = torch.cat([J1, J2]) * coord
        sqc = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w_huber = torch.where(sqc <= huber_delta, 1.0, huber_delta / sqc)
        w = torch.where(valid2 & keep, w_lvl * w_huber, 0.0)
        H = torch.einsum("nij,n,nik->jk", J, w, J) + reg
        g = torch.einsum("nij,n,ni->j", J, w, r)
        dx = -torch.linalg.solve_ex(H, g[:, None])[0][:, 0] * coord
        s, R, t = sim3_compose(exp_sim3(dx), (s, R, t))
        # chi2 reclassification at the updated transform
        q1, q2 = points((s, R, t))
        keep = chi2_of(q1, q2)[1] < chi2_th
    inl = keep[:N] & keep[N:] & valid
    return Sim3Refine(s=s, R=R, t=t, inliers=inl,
                      n_inliers=torch.sum(inl.to(torch.int32)))
