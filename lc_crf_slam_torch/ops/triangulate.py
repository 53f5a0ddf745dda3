"""Batched two-view triangulation with the reference's acceptance checks
(counterpart of lc_crf_slam_tpu/ops/triangulate.py).

Ray-midpoint triangulation of matched pixel pairs between two keyframes,
gated by parallax, positive depth and reprojection chi2 in both views;
and the epipolar gate of SearchForTriangulation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..geometry.camera import Pinhole
from ..geometry.se3 import se3_inverse


class TriangulationResult(NamedTuple):
    xyz: torch.Tensor       # (N, 3) world points
    ok: torch.Tensor        # (N,) bool passed all checks
    parallax: torch.Tensor  # (N,) cos of the ray angle


def _rays(cam: Pinhole, uv: torch.Tensor) -> torch.Tensor:
    x = (uv[:, 0] - cam.cx) / cam.fx
    y = (uv[:, 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def triangulate_pairs(cam: Pinhole, Tcw1: torch.Tensor, Tcw2: torch.Tensor,
                      uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                      level1: torch.Tensor | None = None,
                      scale_factor: float = 1.2, chi2_th: float = 5.991,
                      min_parallax_cos: float = 0.9998) -> TriangulationResult:
    """Midpoint of the two world-frame rays (closed-form 2×2 solve) with
    the reference's checks."""
    Twc1 = se3_inverse(Tcw1)
    Twc2 = se3_inverse(Tcw2)
    d1 = _rays(cam, uv1) @ Twc1[:3, :3].T
    d2 = _rays(cam, uv2) @ Twc2[:3, :3].T
    cos_par = torch.sum(d1 * d2, dim=-1) / (
        torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1) + 1e-9)
    c1, c2 = Twc1[:3, 3], Twc2[:3, 3]
    b = c2 - c1
    a11 = torch.sum(d1 * d1, dim=-1)
    a12 = torch.sum(d1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    b1 = d1 @ b
    b2 = d2 @ b
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    s = (a22 * b1 - a12 * b2) / det
    t = (a12 * b1 - a11 * b2) / det
    xyz = 0.5 * (c1 + s[:, None] * d1 + c2 + t[:, None] * d2)

    def checks(T, uv):
        pc = xyz @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        zs = torch.clamp(z, min=1e-6)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        sigma2 = 1.0 if level1 is None else \
            scale_factor ** (2 * level1.to(torch.float32))
        return (z > 0.02) & (err2 <= chi2_th * sigma2)

    ok = (valid & (cos_par < min_parallax_cos) & (cos_par > 0)
          & checks(Tcw1, uv1) & checks(Tcw2, uv2)
          & torch.all(torch.isfinite(xyz), dim=-1))
    return TriangulationResult(xyz=xyz, ok=ok, parallax=cos_par)


@functools.lru_cache(maxsize=8)
def _inv_intrinsics(fx: float, fy: float, cx: float, cy: float,
                    device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """K^-1, made once per camera and device (element writes of host
    scalars into a device tensor would each wait for the device)."""
    return torch.tensor([[1.0 / fx, 0.0, -cx / fx],
                         [0.0, 1.0 / fy, -cy / fy],
                         [0.0, 0.0, 1.0]], dtype=dtype).to(device)


def epipolar_gate(cam: Pinhole, Tcw1: torch.Tensor, Tcw2: torch.Tensor,
                  uv1: torch.Tensor, uv2: torch.Tensor,
                  tol: float = 3.84) -> torch.Tensor:
    """(N1, N2) mask: uv2 within chi2 tol of uv1's epipolar line in view 2."""
    T21 = Tcw2 @ se3_inverse(Tcw1)
    R, t = T21[:3, :3], T21[:3, 3]
    z = torch.zeros_like(t[0])
    tx = torch.stack([torch.stack([z, -t[2], t[1]]),
                      torch.stack([t[2], z, -t[0]]),
                      torch.stack([-t[1], t[0], z])])
    E = tx @ R
    Kinv = _inv_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, R.device, R.dtype)
    Fm = Kinv.T @ E @ Kinv
    x1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=-1)
    lines = x1 @ Fm.T                    # (N1, 3) epipolar lines in view 2
    num = (lines @ x2.T) ** 2            # (N1, N2)
    den = lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2
    return num / torch.clamp(den, min=1e-12) < tol
