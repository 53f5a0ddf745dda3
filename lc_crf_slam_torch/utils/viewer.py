"""Offline map / trajectory plots (counterpart of lc_crf_slam_tpu/utils/viewer.py).

A headless matplotlib renderer in place of a GL viewer: trajectory
(estimated against ground truth), the map's points coloured by their
static / dynamic label, keyframe positions. Tensors are read through
`.cpu()`; matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_map(
    m, out_path: str,
    trajectory: Optional[np.ndarray] = None,      # (N, 4, 4) Twc
    groundtruth: Optional[np.ndarray] = None,     # (N, 4, 4) Twc
    title: str = "lc_crf_slam_torch map",
) -> None:
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    alive = _np(m.p_alive)
    xyz = _np(m.p_xyz)[alive]
    dyn = _np(m.p_dyn)[alive] > 0.5
    kf_alive = _np(m.kf_alive)
    kf_Twc = np.linalg.inv(_np(m.kf_Tcw)[kf_alive].astype(np.float64))

    for ax, (i, j), names in (
        (axes[0], (0, 2), ("x [m]", "z [m]")),
        (axes[1], (0, 1), ("x [m]", "y [m]")),
    ):
        if len(xyz):
            ax.scatter(xyz[~dyn, i], xyz[~dyn, j], s=1.5, c="#5470c6",
                       alpha=0.5, label="static points")
            if dyn.any():
                ax.scatter(xyz[dyn, i], xyz[dyn, j], s=3.0, c="#ee6666",
                           alpha=0.8, label="dynamic points")
        if len(kf_Twc):
            ax.scatter(kf_Twc[:, i, 3], kf_Twc[:, j, 3], s=14, c="#3ba272",
                       marker="s", label="keyframes")
        if trajectory is not None:
            ax.plot(trajectory[:, i, 3], trajectory[:, j, 3], "-",
                    c="#111111", lw=1.0, label="estimated")
        if groundtruth is not None:
            ax.plot(groundtruth[:, i, 3], groundtruth[:, j, 3], "--",
                    c="#999999", lw=1.0, label="ground truth")
        ax.set_xlabel(names[0])
        ax.set_ylabel(names[1])
        ax.set_aspect("equal", adjustable="datalim")
        ax.grid(alpha=0.25)
    axes[0].legend(loc="best", fontsize=8)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)


def plot_frame(
    gray, frame, obs=None, p_dyn=None, out_path: str = "frame.png",
    title: str = "current frame",
) -> None:
    """The image with its keypoints: green = tracked static, red =
    dynamic-labelled, gray = unmatched."""
    plt = _pyplot()
    gray = _np(gray)
    uv = _np(frame.uv)
    valid = _np(frame.valid)
    fig, ax = plt.subplots(figsize=(10, 7.5))
    ax.imshow(gray, cmap="gray", vmin=0, vmax=255)
    if obs is not None:
        obs = _np(obs)
        tracked = valid & (obs >= 0)
        dyn = np.zeros_like(tracked)
        if p_dyn is not None:
            dyn = tracked & (_np(p_dyn)[np.maximum(obs, 0)] > 0.5)
        ax.scatter(uv[valid & ~tracked, 0], uv[valid & ~tracked, 1],
                   s=6, c="#aaaaaa", marker=".", label="unmatched")
        ax.scatter(uv[tracked & ~dyn, 0], uv[tracked & ~dyn, 1],
                   s=12, facecolors="none", edgecolors="#2ca02c",
                   label="tracked static")
        if dyn.any():
            ax.scatter(uv[dyn, 0], uv[dyn, 1], s=14, facecolors="none",
                       edgecolors="#d62728", label="dynamic")
        ax.legend(loc="lower right", fontsize=8)
    else:
        ax.scatter(uv[valid, 0], uv[valid, 1], s=8, facecolors="none",
                   edgecolors="#2ca02c")
    ax.set_title(title)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
