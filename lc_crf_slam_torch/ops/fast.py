"""FAST-9/16 corner scores as dense maps: the plain PyTorch version.

Counterpart of lc_crf_slam_tpu/ops/fast.py. This is the plain version of
the CUDA kernel in `fast_kernel.py`: the wrapper there runs it for CPU
tensors, and the kernel is held bit for bit against it on the card. The
16 circle margins are accumulated one at a time in circle order, the
order the kernel uses (a `sum` over the stacked axis may reorder).
"""

from __future__ import annotations

import torch

# 16 Bresenham circle offsets (dy, dx), radius 3, clockwise from 12 o'clock.
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9  # FAST-9


def _has_arc(mask: torch.Tensor) -> torch.Tensor:
    """(16, H, W) bool -> (H, W): any circular run of ARC_LENGTH Trues."""
    ext = torch.cat([mask, mask[: ARC_LENGTH - 1]], dim=0)
    run = ext[:16]
    for j in range(1, ARC_LENGTH):
        run = run & ext[j: j + 16]
    return run.any(dim=0)


def _score(img: torch.Tensor, circ: torch.Tensor, t: float) -> torch.Tensor:
    hi = img + t
    lo = img - t
    brighter = circ > hi
    darker = circ < lo
    margin_b = torch.zeros_like(img)
    margin_d = torch.zeros_like(img)
    for k in range(16):
        margin_b = margin_b + torch.where(brighter[k], (circ[k] - img) - t, 0.0)
        margin_d = margin_d + torch.where(darker[k], (img - circ[k]) - t, 0.0)
    sc = torch.maximum(
        torch.where(_has_arc(brighter), margin_b, 0.0),
        torch.where(_has_arc(darker), margin_d, 0.0),
    )
    H, W = img.shape
    inside = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    inside[3:H - 3, 3:W - 3] = True
    return torch.where(inside, sc, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression; outside the image counts as -inf."""
    pad = torch.nn.functional.pad(
        score[None, None], (1, 1, 1, 1), value=float("-inf"))
    m = torch.nn.functional.max_pool2d(pad, 3, stride=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def _circle(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W): the image at each circle offset, edges wrapped (the
    3-px border is masked out of the score)."""
    return torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for dy, dx in CIRCLE_OFFSETS])


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) grayscale -> (H, W) float32 corner score (0 = not corner),
    before NMS: the larger of the brighter and darker arcs' summed margins
    |C_k - I| - t over qualifying circle pixels."""
    return _score(img, _circle(img), threshold)


def fast_score_dual(img: torch.Tensor, th_high: float, th_low: float):
    """(H, W) float32 grayscale -> (score_high, score_low), each NMS'd
    (reference iniThFAST=20, minThFAST=7)."""
    circ = _circle(img)
    return nms3(_score(img, circ, th_high)), nms3(_score(img, circ, th_low))
