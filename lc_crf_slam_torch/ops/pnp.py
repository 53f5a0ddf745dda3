"""Batched 2D-3D absolute-pose RANSAC (counterpart of
lc_crf_slam_tpu/ops/pnp.py).

Each hypothesis solves a 6-point DLT for the projection matrix (the
smallest eigenvector of a 12×12 normal matrix), takes the nearest rigid
pose with the sign chosen by cheirality, and every hypothesis is scored
against every correspondence at once. Inputs may carry leading batch
dimensions (one per relocalisation candidate), so one `eigh` serves a
whole relocalisation attempt.

The sample indices come from `sampler(n_valid, n_hypotheses)`, which
returns (..., n_hypotheses, SAMPLE) integers in [0, max(n_valid, 1)): the
pipeline draws them from a `torch.Generator`, the parity tests pass the
reference's `jax.random` draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .._ops import stable_topk
from ..geometry.camera import Pinhole
from ..geometry.se3 import _sym3_eigvecs, nearest_rotation

SAMPLE = 6   # DLT needs >= 5.5 points; 6 gives an exactly-determined A

# (n_valid (...,) int tensor, n_hypotheses) -> (..., n_hyp, SAMPLE) int64
PnPSampler = Callable[[torch.Tensor, int], torch.Tensor]


class PnPResult(NamedTuple):
    R: torch.Tensor          # (..., 3, 3) world->cam rotation
    t: torch.Tensor          # (..., 3) world->cam translation
    inliers: torch.Tensor    # (..., N) bool at the winning hypothesis
    n_inliers: torch.Tensor  # (...,) int32
    ok: torch.Tensor         # (...,) bool: enough points and inliers


def uniform_sampler(generator: torch.Generator) -> PnPSampler:
    """Uniform sample indices from `generator`, on the device, without a
    host read of n_valid."""
    def sampler(n_valid: torch.Tensor, n_hyp: int) -> torch.Tensor:
        u = torch.rand(n_valid.shape + (n_hyp, SAMPLE), generator=generator,
                       device=n_valid.device)
        hi = torch.clamp(n_valid, min=1)[..., None, None]
        return torch.minimum(torch.floor(u * hi), hi - 1).to(torch.int64)
    return sampler


def _rigidify(Ps: torch.Tensor):
    """(..., 3, 4) projection -> nearest (R, t): R the rotation nearest
    M = Ps[:, :3] (U diag(1, 1, det(U V^T)) V^T of its SVD), t scaled by
    the mean singular value. The 3×3 SVD is the Jacobi eigensolver's
    (`torch.linalg.svd` reads its status on the host)."""
    M = Ps[..., :3]
    R = nearest_rotation(M)
    # singular values: the column norms of M V
    sv = torch.linalg.norm(M @ _sym3_eigvecs(M.transpose(-1, -2) @ M), dim=-2)
    t = Ps[..., 3] / torch.clamp(torch.mean(sv, dim=-1), min=1e-12)[..., None]
    return R, t


def _dlt_projection(Xw: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """6-point DLT: world points (..., S, 3) + normalised image
    coordinates (..., S, 2) -> the (..., 3, 4) projection, the null vector
    of the 12×12 normal matrix (its sign is the eigensolver's)."""
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    x, y = xy[..., 0], xy[..., 1]
    one, zero = torch.ones_like(X), torch.zeros_like(X)
    rows_u = torch.stack([X, Y, Z, one, zero, zero, zero, zero,
                          -x * X, -x * Y, -x * Z, -x], dim=-1)
    rows_v = torch.stack([zero, zero, zero, zero, X, Y, Z, one,
                          -y * X, -y * Y, -y * Z, -y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                 # (..., 2S, 12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)    # ascending
    return vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))


def _pose_from_projection(P: torch.Tensor, Xw: torch.Tensor):
    """(R, t) of P or -P, whichever puts at least as many of the sample
    points in front of the camera."""
    Rp, tp = _rigidify(P)
    Rm, tm = _rigidify(-P)
    zp = torch.einsum("...sj,...j->...s", Xw, Rp[..., 2, :]) + tp[..., 2:3]
    zm = torch.einsum("...sj,...j->...s", Xw, Rm[..., 2, :]) + tm[..., 2:3]
    use_p = torch.sum(zp > 0, dim=-1) >= torch.sum(zm > 0, dim=-1)
    R = torch.where(use_p[..., None, None], Rp, Rm)
    t = torch.where(use_p[..., None], tp, tm)
    return R, t


def _dlt_pose(Xw: torch.Tensor, xy: torch.Tensor):
    """6-point DLT pose with the cheirality-chosen sign."""
    return _pose_from_projection(_dlt_projection(Xw, xy), Xw)


def pnp_ransac(cam: Pinhole, p_world: torch.Tensor, uv: torch.Tensor,
               level: torch.Tensor, valid: torch.Tensor, sampler: PnPSampler,
               n_hypotheses: int = 256, chi2_th: float = 5.991,
               scale_factor: float = 1.2, min_inliers: int = 12) -> PnPResult:
    """Parallel-hypothesis 2D-3D pose RANSAC over (..., N) correspondences;
    inlier: squared pixel error < chi2_th * sigma^2(level)."""
    N = p_world.shape[-2]
    n_valid = torch.sum(valid.to(torch.int32), dim=-1)
    # dense list of valid slots, ties to the lower index
    _, vid = stable_topk(valid.to(torch.float32), N)
    samp = sampler(n_valid, n_hypotheses)                   # (..., H, S)
    sel = torch.gather(vid, -1, samp.flatten(-2)).reshape(samp.shape)

    def pick(a):
        idx = sel.flatten(-2)[..., None].expand(sel.shape[:-2] + (-1, a.shape[-1]))
        return torch.gather(a.expand(sel.shape[:-2] + a.shape[-2:]), -2, idx
                            ).reshape(sel.shape + (a.shape[-1],))

    Xw = pick(p_world)                                      # (..., H, S, 3)
    uv_s = pick(uv)
    xy = torch.stack([(uv_s[..., 0] - cam.cx) / cam.fx,
                      (uv_s[..., 1] - cam.cy) / cam.fy], dim=-1)
    R, t = _dlt_pose(Xw, xy)                                # (..., H, 3, 3)

    pc = torch.einsum("...hij,...nj->...hni", R, p_world) + t[..., None, :]
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    err2 = (u - uv[..., None, :, 0]) ** 2 + (v - uv[..., None, :, 1]) ** 2
    sigma2 = (scale_factor ** 2) ** level.to(torch.float32)
    inl = valid[..., None, :] & (z > 0.05) & (err2 < chi2_th * sigma2[..., None, :])
    counts = torch.sum(inl.to(torch.int32), dim=-1)         # (..., H)
    finite = torch.all(torch.isfinite(R.flatten(-2)), dim=-1) \
        & torch.all(torch.isfinite(t), dim=-1)
    counts = torch.where(finite, counts, -1)
    best = torch.argmax(counts, dim=-1, keepdim=True)       # first maximum
    n_best = torch.gather(counts, -1, best)[..., 0]
    R_b = torch.gather(R, -3, best[..., None, None].expand(best.shape + (3, 3)))
    t_b = torch.gather(t, -2, best[..., None].expand(best.shape + (3,)))
    inl_b = torch.gather(inl, -2, best[..., None].expand(best.shape + (N,)))
    return PnPResult(
        R=R_b[..., 0, :, :], t=t_b[..., 0, :], inliers=inl_b[..., 0, :],
        n_inliers=torch.clamp(n_best, min=0),
        ok=(n_best >= min_inliers) & (n_valid >= SAMPLE),
    )
