"""Umeyama point-set alignment (counterpart of lc_crf_slam_tpu/geometry/align.py).

Used by the capture-resistance audit (a batch of 3-point hypotheses) and
for ATE. Rigid (scale fixed to 1), as every caller of the slice uses it.
Broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

from .se3 import nearest_rotation

_EPS = 1e-9


def umeyama_alignment(src, dst, w=None):
    """Least-squares rigid transform dst ≈ R src + t.

    src, dst: (..., N, 3); w: optional (..., N) weights. Returns (s, R, t)
    with s = 1 (...,), R (..., 3, 3), t (..., 3), as the reference's
    `umeyama_alignment(..., with_scale=False)`.
    """
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    mu_s = torch.sum(wn[..., None] * src, dim=-2)
    mu_d = torch.sum(wn[..., None] * dst, dim=-2)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    # Sigma = sum_i w_i cd_i cs_i^T maps the src frame to the dst frame
    R = nearest_rotation(torch.einsum("...n,...ni,...nj->...ij", wn, cd, cs))
    s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    return s, R, mu_d - (R @ mu_s[..., None])[..., 0]
