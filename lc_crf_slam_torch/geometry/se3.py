"""SE(3) / SO(3) Lie-group operations on torch tensors.

Counterpart of lc_crf_slam_tpu/geometry/se3.py, same conventions: poses
are (4, 4) matrices T = [[R, t], [0, 1]] mapping world->camera; twists are
[upsilon (translation), omega (rotation)]. All functions broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import functools
import math

import torch

_EPS = 1e-8

# Small-angle Taylor cutoff sized for float32 (see the reference: the
# naive (1-cos t)/t^2, (t-sin t)/t^3 forms cancel catastrophically below
# ~5e-2 in f32).
_SMALL_TH = 5e-2


def _safe_norm(w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True) + 1e-30)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (3, 3))


def hat_so3(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee_so3(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew matrix -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)


def _cosc(x: torch.Tensor) -> torch.Tensor:
    small = torch.abs(x) < _SMALL_TH
    xs = torch.where(small, 1.0, x)
    x2 = x * x
    return torch.where(
        small, 0.5 - x2 / 24.0 + x2 * x2 / 720.0,
        (1.0 - torch.cos(xs)) / (xs * xs),
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    th = _safe_norm(w)[..., None]
    W = hat_so3(w)
    return _eye3(w) + _sinc(th) * W + _cosc(th) * (W @ W)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> quaternion (..., 4) as (qx, qy, qz, qw), w >= 0
    (branch-free Shepperd selection, as the reference)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _cand(s_sq, x, y, z, w):
        s = 2.0 * torch.sqrt(torch.clamp(s_sq, min=_EPS))
        return torch.stack([x / s, y / s, z / s, w / s], dim=-1)

    s0 = 1.0 + tr
    c0 = _cand(s0, m21 - m12, m02 - m20, m10 - m01, s0)
    s1 = 1.0 + m00 - m11 - m22
    c1 = _cand(s1, s1, m01 + m10, m02 + m20, m21 - m12)
    s2 = 1.0 - m00 + m11 - m22
    c2 = _cand(s2, m01 + m10, s2, m12 + m21, m02 - m20)
    s3 = 1.0 - m00 - m11 + m22
    c3 = _cand(s3, m02 + m20, m12 + m21, s3, m10 - m01)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(
        cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) as (qx, qy, qz, qw) [TUM order] -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, via the quaternion."""
    q = rotmat_to_quat(R)
    qv = q[..., :3]
    sin_half = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(sin_half, q[..., 3])
    small = sin_half < 1e-6
    scale = torch.where(small, 2.0, theta / torch.where(small, 1.0, sin_half))
    return scale[..., None] * qv


def _tcub(x: torch.Tensor) -> torch.Tensor:
    """(x - sin(x))/x^3 with Taylor fallback near 0."""
    small = torch.abs(x) < _SMALL_TH
    xs = torch.where(small, 1.0, x)
    x2 = x * x
    return torch.where(
        small, 1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0,
        (xs - torch.sin(xs)) / (xs * xs * xs),
    )


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = R.new_zeros(batch + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [upsilon, omega] -> (..., 4, 4) transform. The
    rotation and the left Jacobian V share theta, W and W^2."""
    ups, w = xi[..., :3], xi[..., 3:]
    th = _safe_norm(w)[..., None]
    W = hat_so3(w)
    W2 = W @ W
    eye, A = _eye3(w), _cosc(th)
    R = eye + _sinc(th) * W + A * W2
    V = eye + A * W + _tcub(th) * W2
    return make_se3(R, (V @ ups[..., None])[..., 0])


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of the SO(3) left Jacobian (the V of `exp_se3`), with the
    reference's series below `_SMALL_TH`."""
    th = _safe_norm(w)[..., None]
    W = hat_so3(w)
    small = th < _SMALL_TH
    ths = torch.where(small, 1.0, th)
    half = 0.5 * ths
    th2 = th * th
    cot_term = torch.where(
        small, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (ths * ths),
    )
    return _eye3(w) - 0.5 * W + cot_term * (W @ W)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> (..., 6) twist [upsilon, omega]."""
    w = log_so3(T[..., :3, :3])
    ups = (_left_jacobian_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([ups, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    Rt = R.transpose(-1, -2)
    return make_se3(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (no LU, no host sync)."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


_JACOBI_SWEEPS = 8
_TINY = 1e-20
_JACOBI_PAIRS = ((0, 1), (0, 2), (1, 2))


@functools.lru_cache(maxsize=8)
def _jacobi_planes(device: torch.device, dtype: torch.dtype):
    """Per plane (p, q): the masks of J = eye + (c - 1) diag + s skew,
    made once per device (writing them on the device element by element
    would copy each scalar from the host)."""
    diag = torch.zeros((3, 3, 3), dtype=dtype)
    skew = torch.zeros_like(diag)
    for i, (p, q) in enumerate(_JACOBI_PAIRS):
        diag[i, p, p] = diag[i, q, q] = 1.0
        skew[i, p, q], skew[i, q, p] = 1.0, -1.0
    return diag.to(device), skew.to(device)


def _sym3_eigvecs(A: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (columns, by descending eigenvalue) of symmetric
    (..., 3, 3) A, by cyclic Jacobi rotations with a fixed sweep count.
    `torch.linalg.svd`/`eigh` check their LAPACK status on the host,
    which stalls the stream once per call; this runs on the device only."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    diag, skew = _jacobi_planes(A.device, A.dtype)
    V = eye.expand(A.shape)
    for _ in range(_JACOBI_SWEEPS):
        for i, (p, q) in enumerate(_JACOBI_PAIRS):
            # tan(2 theta) = 2 a_pq / (a_qq - a_pp) zeroes a_pq; |theta| <= pi/4
            th = 0.5 * torch.atan2(2.0 * A[..., p, q], A[..., q, q] - A[..., p, p])
            th = th - (math.pi / 2) * torch.sign(th) * (th.abs() > math.pi / 4)
            c, s = torch.cos(th)[..., None, None], torch.sin(th)[..., None, None]
            J = eye + (c - 1.0) * diag[i] + s * skew[i]
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    order = torch.argsort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1, descending=True)
    return torch.gather(V, -1, order[..., None, :].expand(V.shape))


def _unit(x: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return torch.where(n > _TINY, x / torch.clamp(n, min=_TINY), fallback)


def polar_rotation(M: torch.Tensor):
    """(R, tr): the rotation closest to (..., 3, 3) M (Kabsch / polar
    factor), U diag(1, 1, det(U V^T)) V^T of M's SVD, and the signed sum
    of singular values tr = trace(diag(D) diag(1, 1, det(U V^T))) that
    Umeyama's scale needs. V from the eigenvectors of M^T M; U's first two
    columns are M V's, orthonormalised, and its third their cross product,
    so rank-2 M (three points) works too."""
    V = _sym3_eigvecs(M.transpose(-1, -2) @ M)
    MV = M @ V
    u1 = _unit(MV[..., 0], V[..., 0])
    m2 = MV[..., 1]
    u2 = _unit(m2 - torch.sum(u1 * m2, -1, keepdim=True) * u1, V[..., 1])
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], dim=-1)   # det U = +1
    S = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    S[..., 2] = torch.where(_det3(V) < 0, -1.0, 1.0)
    # U^T M V = diag(D) with the third entry signed by the true u3 . U[:, 2]
    tr = torch.sum(torch.sum(U * MV, dim=-2) * S, dim=-1)
    return U @ (S[..., :, None] * V.transpose(-1, -2)), tr


def nearest_rotation(M: torch.Tensor) -> torch.Tensor:
    """The rotation closest to (..., 3, 3) M (see `polar_rotation`)."""
    return polar_rotation(M)[0]


def orthonormalize_se3(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block onto SO(3) (polar projection); tracking
    applies it once per frame against f32 orthogonality drift."""
    return make_se3(nearest_rotation(T[..., :3, :3]), T[..., :3, 3])
