"""Absolute trajectory error by the TUM protocol: frames paired by
timestamp, the estimate aligned to the ground truth by Umeyama's
least-squares rigid transform, the RMSE of the position residuals.

A frozen copy of lc_crf_slam_torch/utils/evaluate.py at commit d6d14bc
(`_associate_timestamps`, `evaluate_ate` without scale), in numpy and
float64, with numpy's SVD for the rotation where the program takes the
polar factor of its own eigensolver.
"""

from __future__ import annotations

import numpy as np


def associate(ts_a, ts_b, max_difference: float = 0.02):
    """Nearest-neighbour greedy pairing of two sorted timestamp arrays:
    [(index in a, index in b)]."""
    pairs = []
    used_b = np.zeros(len(ts_b), dtype=bool)
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, best_d = -1, max_difference
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(ts_b) and not used_b[k]:
                d = abs(ts_b[k] - t)
                if d < best_d:
                    best, best_d = k, d
        if best >= 0:
            used_b[best] = True
            pairs.append((i, best))
    return pairs


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(R, t) minimising sum |R src_i + t - dst_i|^2 over rotations."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    sigma = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(sigma)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(ts_est, twc_est, ts_gt, twc_gt) -> float:
    """ATE RMSE [m] of estimated camera-to-world poses against the truth."""
    pairs = associate(np.asarray(ts_est), np.asarray(ts_gt))
    if len(pairs) < 3:
        raise ValueError(f"only {len(pairs)} associated pose pairs")
    p_est = np.asarray(twc_est, np.float64)[[p[0] for p in pairs], :3, 3]
    p_gt = np.asarray(twc_gt, np.float64)[[p[1] for p in pairs], :3, 3]
    R, t = umeyama(p_est, p_gt)
    err = np.linalg.norm(p_est @ R.T + t - p_gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))
