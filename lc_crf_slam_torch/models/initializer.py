"""Monocular two-view initialisation (counterpart of
lc_crf_slam_tpu/models/initializer.py; Initializer.cc).

A batched essential-matrix RANSAC with known intrinsics: 256 eight-point
hypotheses solved and scored at once (Sampson error), the best E
decomposed into its four (R, t) candidates, cheirality by triangulation
picks the pose, and the map is scaled to unit median depth.

Where the reference takes SVDs, the port takes:
- for the eight-point null vector, the eigenvector of the smallest
  eigenvalue of the 9×9 normal matrix, all 256 in one batched float64
  `eigh` (the SVD's right singular vector up to sign; float64 keeps the
  squared condition number harmless; one host read of the solver's
  status per attempt);
- for the projection onto the essential manifold and the decomposition,
  the 3×3 Jacobi eigensolver of `geometry/se3.py` on E^T E.
Signs of singular vectors differ between solvers; the projected E and
the set of four candidate poses do not, so the chosen pose agrees with
the reference's whenever one candidate wins outright (which `accepted`
requires).

The hypotheses' sample indices come from `sampler(p, n_hypotheses)`
((n_hypotheses, 8) indices drawn with replacement with probabilities p,
uniform over the valid matches): the pipeline draws them from a
`torch.Generator`, the parity tests pass the reference's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Pinhole
from ..geometry.se3 import _det3, _sym3_eigvecs, _unit, make_se3
from ..ops.ransac import HornSampler
from ..ops.triangulate import triangulate_pairs

SAMPLE = 8


class MonoInit(NamedTuple):
    Tcw2: torch.Tensor       # (4, 4) pose of the second view (the first is I)
    xyz: torch.Tensor        # (N, 3) triangulated points (unit median depth)
    ok: torch.Tensor         # (N,) bool valid points
    n_good: torch.Tensor     # () int32
    accepted: torch.Tensor   # () bool


def _w_matrix(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The 90-degree rotation about z of the E decomposition, made on the
    device (a host-made constant copied over would read the device)."""
    e = torch.eye(3, dtype=dtype, device=device)
    return torch.stack([0.0 - e[1], e[0], e[2]])


def _normalize(cam: Pinhole, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _top2_frame(E: torch.Tensor):
    """(U, S, V) of (..., 3, 3) E from the Jacobi eigenvectors of E^T E:
    V by descending eigenvalue, U's first two columns E V's normalised
    (the second orthogonalised), the third their cross product (det U =
    +1), S the norms of E V's first two columns."""
    V = _sym3_eigvecs(E.transpose(-1, -2) @ E)
    EV = E @ V
    u1 = _unit(EV[..., 0], V[..., 0])
    e2 = EV[..., 1]
    u2 = _unit(e2 - torch.sum(u1 * e2, -1, keepdim=True) * u1, V[..., 1])
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], dim=-1)
    S = torch.linalg.norm(EV[..., :2], dim=-2)
    return U, S, V


def _eight_point(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """E from eight normalised correspondences ((..., 8, 2) each): the
    null vector of the 8×9 system, projected onto the essential manifold
    (two equal singular values, the third zero)."""
    A = (_homog(x2)[..., :, None] * _homog(x1)[..., None, :]).flatten(-2)  # (..., 8, 9)
    A = A.to(torch.float64)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)      # ascending
    E = vecs[..., :, 0].to(x1.dtype).reshape(A.shape[:-2] + (3, 3))
    U, S, V = _top2_frame(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    return s[..., None, None] * (U[..., :, :2] @ V[..., :, :2].transpose(-1, -2))


def _sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Sampson distances (..., N) of correspondences (N, 2) under E (..., 3, 3)."""
    a, b = _homog(x1), _homog(x2)
    Ea = a @ E.transpose(-1, -2)
    Etb = b @ E
    num = torch.sum(b * Ea, dim=-1) ** 2
    den = Ea[..., 0] ** 2 + Ea[..., 1] ** 2 + Etb[..., 0] ** 2 + Etb[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _midpoint_median(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` of x where ok: the mean of the two middle values of
    an even count (torch.nanmedian returns the lower); inf when none."""
    v, _ = torch.sort(torch.where(ok, x, float("inf")))
    n = torch.sum(ok.to(torch.int64))
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=x.shape[0] - 1)
    return (v.index_select(0, lo.reshape(1)) + v.index_select(0, hi.reshape(1)))[0] * 0.5


def initialize_mono(cam: Pinhole, uv1: torch.Tensor, uv2: torch.Tensor,
                    valid: torch.Tensor, sampler: HornSampler,
                    n_hypotheses: int = 256, inlier_tol: float = 3.0e-6,
                    min_inliers: int = 60,
                    min_parallax_cos: float = 0.99995) -> MonoInit:
    """Two-view bootstrap from matched pixel pairs (N each, masked)."""
    x1, x2 = _normalize(cam, uv1), _normalize(cam, uv2)
    p = valid.to(torch.float32)
    p = p / torch.clamp(torch.sum(p), min=1.0)
    idx = sampler(p, n_hypotheses)                                  # (H, 8)
    Es = _eight_point(x1[idx], x2[idx])                             # (H, 3, 3)
    inl = (_sampson_error(Es, x1, x2) < inlier_tol) & valid         # (H, N)
    best = torch.argmax(torch.sum(inl.to(torch.int32), dim=-1))     # first maximum
    E = Es.index_select(0, best.reshape(1))[0]
    inliers = inl.index_select(0, best.reshape(1))[0]

    # the four candidates (R1 | R2) x (t | -t)
    U, _, V = _top2_frame(E)
    U = U * torch.where(_det3(U @ V.T) < 0, -1.0, 1.0)     # det(R) = +1 overall
    W = _w_matrix(E.device, E.dtype)
    R1 = U @ W @ V.T
    R2 = U @ W.T @ V.T
    R1 = R1 * torch.where(_det3(R1) < 0, -1.0, 1.0)
    R2 = R2 * torch.where(_det3(R2) < 0, -1.0, 1.0)
    t = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-9)
    T1w = torch.eye(4, dtype=E.dtype, device=E.device)
    poses = torch.stack([make_se3(R1, t), make_se3(R1, -t),
                         make_se3(R2, t), make_se3(R2, -t)])
    tris = [triangulate_pairs(cam, T1w, T, uv1, uv2, inliers,
                              min_parallax_cos=min_parallax_cos) for T in poses]
    counts = torch.stack([torch.sum(tri.ok.to(torch.int32)) for tri in tris])
    bi = torch.argmax(counts).reshape(1)                   # first maximum
    Tcw2 = poses.index_select(0, bi)[0]
    xyz = torch.stack([tri.xyz for tri in tris]).index_select(0, bi)[0]
    ok = torch.stack([tri.ok for tri in tris]).index_select(0, bi)[0]
    n_good = counts.index_select(0, bi)[0]
    # the reference's convention: unit median scene depth
    med = _midpoint_median(xyz[:, 2], ok)
    med = torch.where(torch.isfinite(med) & (med > 1e-6), med, 1.0)
    xyz = xyz / med
    Tcw2 = make_se3(Tcw2[:3, :3], Tcw2[:3, 3] / med)
    # the best of the four must dominate (the reference's similarity check)
    second = torch.sort(counts).values[-2]
    accepted = (n_good >= min_inliers) & (
        second.to(torch.float32) < 0.7 * n_good.to(torch.float32))
    return MonoInit(Tcw2=Tcw2, xyz=xyz, ok=ok & accepted, n_good=n_good,
                    accepted=accepted)
