"""Grid-cell keypoint selection (counterpart of lc_crf_slam_tpu/ops/select.py).

Best corner per 16-px cell (high-threshold map, falling back to the
low-threshold map for empty cells), then a global top-k over cells with
the reference's tie order (`stable_topk`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._ops import stable_topk


def _cell_reduce(score: torch.Tensor, cell: int):
    """(H, W) -> per-cell (max, y, x of the first argmax), row-major cells."""
    H, W = score.shape
    Hp = (H + cell - 1) // cell * cell
    Wp = (W + cell - 1) // cell * cell
    s = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H), value=0.0)
    ny, nx = Hp // cell, Wp // cell
    s = s.reshape(ny, cell, nx, cell).permute(0, 2, 1, 3).reshape(ny * nx, cell * cell)
    best = torch.amax(s, dim=-1)
    # first argmax on ties, as the reference (torch.max does not promise it)
    arg = torch.argmax((s == best[:, None]).to(torch.uint8), dim=-1)
    cells = torch.arange(ny * nx, device=score.device)
    y = (cells // nx) * cell + arg // cell
    x = (cells % nx) * cell + arg % cell
    return best, y.to(torch.int32), x.to(torch.int32)


def select_keypoints(
    score_hi: torch.Tensor,
    score_lo: torch.Tensor,
    k: int,
    cell: int = 16,
    margin: int = 19,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to k spatially balanced keypoints from dual score maps.

    Returns (uv int32 [k, 2] as (x, y), score float32 [k], valid bool [k]);
    invalid slots have score 0 and uv (0, 0).
    """
    H, W = score_hi.shape
    inb = torch.zeros((H, W), dtype=torch.bool, device=score_hi.device)
    inb[margin:H - margin, margin:W - margin] = True
    hi = torch.where(inb, score_hi, 0.0)
    lo = torch.where(inb, score_lo, 0.0)

    b_hi, y_hi, x_hi = _cell_reduce(hi, cell)
    b_lo, y_lo, x_lo = _cell_reduce(lo, cell)
    use_lo = b_hi <= 0.0
    best = torch.where(use_lo, b_lo, b_hi)
    y = torch.where(use_lo, y_lo, y_hi)
    x = torch.where(use_lo, x_lo, x_hi)

    kk = min(k, best.shape[0])
    top, idx = stable_topk(best, kk)
    uv = torch.stack([x[idx], y[idx]], dim=-1)
    valid = top > 0.0
    if kk < k:
        uv = torch.cat([uv, uv.new_zeros((k - kk, 2))])
        top = torch.cat([top, top.new_zeros((k - kk,))])
        valid = torch.cat([valid, valid.new_zeros((k - kk,))])
    uv = torch.where(valid[:, None], uv, 0)
    return uv, torch.where(valid, top, 0.0), valid
