"""Trajectory evaluation: ATE and RPE (counterpart of
lc_crf_slam_tpu/utils/evaluate.py).

TUM's `evaluate_ate.py` / `evaluate_rpe.py` protocol: timestamp
association, Umeyama alignment (`geometry/align.py`, in float64), ATE
RMSE and fixed-delta relative pose error.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.align import umeyama_alignment


@dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    max: float
    n_pairs: int

    def __repr__(self):
        return (
            f"ATE(rmse={self.rmse:.4f}m mean={self.mean:.4f} "
            f"median={self.median:.4f} max={self.max:.4f} n={self.n_pairs})"
        )


def _associate_timestamps(ts_a, ts_b, max_difference=0.02):
    """Nearest-neighbour greedy matching of two sorted timestamp arrays:
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


def evaluate_ate(ts_est, poses_est_twc, ts_gt, poses_gt_twc,
                 max_difference: float = 0.02, with_scale: bool = False) -> ATEResult:
    """Absolute trajectory error after Umeyama alignment (TUM protocol);
    `with_scale` for monocular estimates."""
    pairs = _associate_timestamps(np.asarray(ts_est), np.asarray(ts_gt), max_difference)
    if len(pairs) < 2:
        raise ValueError(f"only {len(pairs)} associated pose pairs")
    ei = np.array([p[0] for p in pairs])
    gi = np.array([p[1] for p in pairs])
    p_est = np.asarray(poses_est_twc, np.float64)[ei, :3, 3]
    p_gt = np.asarray(poses_gt_twc, np.float64)[gi, :3, 3]
    s, R, t = (x.numpy() for x in umeyama_alignment(
        torch.from_numpy(p_est), torch.from_numpy(p_gt), with_scale=with_scale))
    err = np.linalg.norm(s * (p_est @ R.T) + t - p_gt, axis=-1)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(np.mean(err)),
        median=float(np.median(err)),
        max=float(np.max(err)),
        n_pairs=len(pairs),
    )


def evaluate_rpe(ts_est, poses_est_twc, ts_gt, poses_gt_twc,
                 delta: float = 1.0, max_difference: float = 0.02):
    """Relative pose error over a fixed time delta: (translation RMSE [m],
    rotation RMSE [rad])."""
    ts_est = np.asarray(ts_est)
    pairs = _associate_timestamps(ts_est, np.asarray(ts_gt), max_difference)
    ei = np.array([p[0] for p in pairs], dtype=np.int64)
    gi = np.array([p[1] for p in pairs], dtype=np.int64)
    Te = np.asarray(poses_est_twc)[ei]
    Tg = np.asarray(poses_gt_twc)[gi]
    ts = ts_est[ei]
    terrs, rerrs = [], []
    for i in range(len(ts)):
        j = int(np.searchsorted(ts, ts[i] + delta))
        if j >= len(ts):
            break
        e = np.linalg.inv(np.linalg.inv(Tg[i]) @ Tg[j]) @ (np.linalg.inv(Te[i]) @ Te[j])
        terrs.append(np.linalg.norm(e[:3, 3]))
        rerrs.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
    if not terrs:
        return 0.0, 0.0
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))
