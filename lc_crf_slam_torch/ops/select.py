"""Grid-cell keypoint selection (counterpart of lc_crf_slam_tpu/ops/select.py).

Best corner per 16-px cell (high-threshold map, falling back to the
low-threshold map for empty cells), then a global top-k over cells with
the reference's tie order (`stable_topk`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._ops import stable_topk


def _cell_reduce(score: torch.Tensor, cell: int, margin: int):
    """(H, W) -> per-cell (max, y, x of the first argmax), row-major cells
    over ceil(H/cell) x ceil(W/cell); scores outside [margin, H-margin) x
    [margin, W-margin) and the padding of a ragged last cell count as 0."""
    H, W = score.shape
    Hp = (H + cell - 1) // cell * cell
    Wp = (W + cell - 1) // cell * cell
    if H > 2 * margin and W > 2 * margin:
        s = torch.nn.functional.pad(
            score[margin:H - margin, margin:W - margin],
            (margin, margin + Wp - W, margin, margin + Hp - H), value=0.0)
    else:
        s = score.new_zeros((Hp, Wp))
    ny, nx = Hp // cell, Wp // cell
    s = s.reshape(ny, cell, nx, cell).permute(0, 2, 1, 3).reshape(ny * nx, cell * cell)
    best = torch.amax(s, dim=-1)
    # first argmax on ties, as the reference (torch.max does not promise it)
    arg = torch.argmax((s == best[:, None]).to(torch.uint8), dim=-1)
    cells = torch.arange(ny * nx, device=score.device)
    y = (cells // nx) * cell + arg // cell
    x = (cells % nx) * cell + arg % cell
    return best, y.to(torch.int32), x.to(torch.int32)


def cell_best(score_hi: torch.Tensor, score_lo: torch.Tensor, cell: int = 16,
              margin: int = 19):
    """Best corner of every cell from the dual NMS'd score maps (H, W):
    the masked per-cell maximum of the high-threshold map with its first
    position, the low-threshold map's where the high one is empty. Returns
    (best float32, y int32, x int32), each (n_cells,). The plain version
    of the second half of the fused CUDA kernel (`fast_kernel.py`)."""
    b_hi, y_hi, x_hi = _cell_reduce(score_hi, cell, margin)
    b_lo, y_lo, x_lo = _cell_reduce(score_lo, cell, margin)
    use_lo = b_hi <= 0.0
    return (torch.where(use_lo, b_lo, b_hi), torch.where(use_lo, y_lo, y_hi),
            torch.where(use_lo, x_lo, x_hi))


def select_from_cells(best: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global top-k over the cells' best corners (..., n_cells), ties to
    the lower cell. Returns (uv int32 [..., k, 2] as (x, y), score float32
    [..., k], valid bool [..., k]); invalid slots have score 0 and uv
    (0, 0)."""
    kk = min(k, best.shape[-1])
    top, idx = stable_topk(best, kk)
    uv = torch.stack([torch.gather(x, -1, idx), torch.gather(y, -1, idx)], dim=-1)
    valid = top > 0.0
    if kk < k:
        pad = torch.nn.functional.pad
        uv = pad(uv, (0, 0, 0, k - kk))
        top = pad(top, (0, k - kk))
        valid = pad(valid, (0, k - kk))
    uv = torch.where(valid[..., None], uv, 0)
    return uv, torch.where(valid, top, 0.0), valid


def select_keypoints(
    score_hi: torch.Tensor,
    score_lo: torch.Tensor,
    k: int,
    cell: int = 16,
    margin: int = 19,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to k spatially balanced keypoints from dual score maps (H, W):
    `cell_best`, then `select_from_cells`."""
    return select_from_cells(*cell_best(score_hi, score_lo, cell, margin), k)
