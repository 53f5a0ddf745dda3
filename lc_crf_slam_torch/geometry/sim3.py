"""Sim(3) operations for loop closing (counterpart of
lc_crf_slam_tpu/geometry/sim3.py).

A Sim3 element is a tuple of tensors (s, R, t) with s (...,) the scale,
R (..., 3, 3), t (..., 3); it maps p -> s R p + t and batches by
broadcasting. RGB-D fixes s = 1. The tangent is (7,): [upsilon (3),
omega (3), sigma (1)] with s = exp(sigma).
"""

from __future__ import annotations

import torch

from .se3 import exp_so3, hat_so3, log_so3, make_se3


def sim3_identity(dtype=torch.float32, device=None):
    return (torch.ones((), dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros((3,), dtype=dtype, device=device))


def sim3_apply(S, p: torch.Tensor) -> torch.Tensor:
    s, R, t = S
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_compose(A, B):
    """(A ∘ B)(p) = A(B(p))."""
    sa, Ra, ta = A
    sb, Rb, tb = B
    return (sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta)


def sim3_inverse(S):
    s, R, t = S
    s_inv = 1.0 / s
    Rt = R.transpose(-1, -2)
    return (s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The W matrix of the Sim(3) exponential, t = W upsilon: the closed
    form with Taylor branches for small sigma and/or small theta, at the
    reference's float32-sized cutoffs."""
    theta = torch.linalg.norm(w, dim=-1)
    Wx = hat_so3(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wx.shape)
    s = torch.exp(sigma)

    small_sig = torch.abs(sigma) < 2e-2
    small_th = theta < 5e-2
    sig_safe = torch.where(small_sig, 1.0, sigma)
    th_safe = torch.where(small_th, 1.0, theta)

    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_safe)
    th2 = th_safe * th_safe
    sig2 = sig_safe * sig_safe
    denom = sig2 + th2
    a = s * torch.sin(th_safe)
    b = s * torch.cos(th_safe)
    # generic case (sigma != 0, theta != 0)
    C_gen = (a * sig_safe + (1.0 - b) * th_safe) / (th_safe * denom)
    D_gen = (A - ((b - 1.0) * sig_safe + a * th_safe) / denom) / th2
    # sigma ~ 0, theta != 0
    C_sig0 = (1.0 - torch.cos(th_safe)) / th2
    D_sig0 = (th_safe - torch.sin(th_safe)) / (th2 * th_safe)
    # theta ~ 0, any sigma
    C_th0 = torch.where(small_sig, 0.5 + sigma / 6.0 + sigma * sigma / 24.0,
                        ((sig_safe - 1.0) * s + 1.0) / sig2)
    D_th0 = torch.where(small_sig,
                        1.0 / 6.0 + sigma / 24.0 + sigma * sigma / 120.0,
                        (s * (0.5 * sig2 - sig_safe + 1.0) - 1.0) / (sig2 * sig_safe))
    C = torch.where(small_th, C_th0, torch.where(small_sig, C_sig0, C_gen))
    D = torch.where(small_th, D_th0, torch.where(small_sig, D_sig0, D_gen))
    return (A[..., None, None] * eye + C[..., None, None] * Wx
            + D[..., None, None] * (Wx @ Wx))


def exp_sim3(xi: torch.Tensor):
    """(..., 7) [upsilon, omega, sigma] -> Sim3 tuple."""
    ups, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(w, sigma) @ ups[..., None])[..., 0]
    return (torch.exp(sigma), exp_so3(w), t)


def log_sim3(S) -> torch.Tensor:
    """Sim3 tuple -> (..., 7) twist: inverts `exp_sim3` by solving
    W upsilon = t (without the host-side status check)."""
    s, R, t = S
    sigma = torch.log(s)
    w = log_so3(R)
    ups = torch.linalg.solve_ex(_sim3_W(w, sigma), t[..., None])[0][..., 0]
    return torch.cat([ups, w, sigma[..., None]], dim=-1)


def sim3_from_se3(T: torch.Tensor):
    """(..., 4, 4) SE3 -> Sim3 with s = 1."""
    return (torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device),
            T[..., :3, :3], T[..., :3, 3])


def se3_from_sim3(S) -> torch.Tensor:
    """Sim3 -> (..., 4, 4) SE3 with the scale folded into the translation
    (CorrectLoop's convention: Tiw = [R, t / s])."""
    s, R, t = S
    return make_se3(R, t / s[..., None])
