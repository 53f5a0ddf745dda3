"""Umeyama point-set alignment (counterpart of lc_crf_slam_tpu/geometry/align.py).

Used by the capture-resistance audit and the Horn RANSAC of loop
verification (batches of 3-point hypotheses, then one weighted refit) and
for ATE. Rigid by default; `with_scale=True` solves the similarity.
Broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

from .se3 import polar_rotation

_EPS = 1e-9


def umeyama_alignment(src, dst, w=None, with_scale: bool = False):
    """Least-squares similarity dst ≈ s R src + t.

    src, dst: (..., N, 3); w: optional (..., N) weights. Returns (s, R, t)
    with s (...,) (1 unless `with_scale`), R (..., 3, 3), t (..., 3). The
    3×3 SVD of the reference is the Jacobi eigensolver's polar factor
    (`torch.linalg.svd` reads its status on the host).
    """
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    mu_s = torch.sum(wn[..., None] * src, dim=-2)
    mu_d = torch.sum(wn[..., None] * dst, dim=-2)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    # Sigma = sum_i w_i cd_i cs_i^T maps the src frame to the dst frame
    R, tr = polar_rotation(torch.einsum("...n,...ni,...nj->...ij", wn, cd, cs))
    if with_scale:
        var_s = torch.sum(wn * torch.sum(cs * cs, dim=-1), dim=-1)
        s = tr / torch.clamp(var_s, min=_EPS)
    else:
        s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    return s, R, mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]


def horn_sim3(src, dst, w=None, fix_scale: bool = True):
    """Closed-form Sim(3) (s, R, t) mapping src -> dst: the Umeyama
    solution, rigid with `fix_scale` (RGB-D loop closing)."""
    return umeyama_alignment(src, dst, w=w, with_scale=not fix_scale)


def alignment_residuals(src, dst, s, R, t):
    """Per-point residual norms after applying (s, R, t) to src."""
    mapped = s[..., None, None] * torch.einsum("...ij,...nj->...ni", R, src) \
        + t[..., None, :]
    return torch.linalg.norm(mapped - dst, dim=-1)
