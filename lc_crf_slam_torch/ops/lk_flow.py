"""Pyramidal Lucas-Kanade optical flow, batched over keypoints
(counterpart of lc_crf_slam_tpu/ops/lk_flow.py).

Per level, coarse to fine: a bilinear template with central-difference
gradients from the previous image, an integer-anchored search window of
the next image, the correlation of the window with each gradient over a
±SEARCH_RAD offset grid, then fixed Gauss-Newton iterations that read the
correlation maps through separable bilinear hat weights.

The reference lays this out for TPU tiles (keypoints last, a 15×15 loop
of shifted multiply-adds, one-hot column-selection matmuls). The port
keeps the arithmetic and not the layout: each window is one index
gather, the correlation is one grouped convolution, the final error one
pair of contractions over unfolded views.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from .pyramid import resize_bilinear


class FlowResult(NamedTuple):
    uv_next: torch.Tensor   # (K, 2) tracked positions in the next image
    err: torch.Tensor       # (K,) mean abs photometric residual
    ok: torch.Tensor        # (K,) bool converged & in-bounds


SEARCH_RAD = 6   # max per-level correction of the coarse-to-fine guess


def _windows(img_p: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
             n: int) -> torch.Tensor:
    """(K, n, n) crops of the padded image img_p with top-left (y0, x0)."""
    ar = torch.arange(n, device=img_p.device)
    rows = (y0[:, None] + ar[None, :]) * img_p.shape[1]
    flat = rows[:, :, None] + (x0[:, None] + ar[None, :])[:, None, :]
    return img_p.reshape(-1)[flat]


def _track_level(img_prev: torch.Tensor, img_next: torch.Tensor,
                 uv_prev: torch.Tensor, uv_guess: torch.Tensor,
                 half_win: int, iters: int):
    """One pyramid level of LK for all keypoints: (uv_next (K, 2),
    err (K,))."""
    r = half_win
    P = 2 * r + 1                   # patch side
    S = SEARCH_RAD
    D = 2 * S + 2                   # offset grid (bilinear needs the +1)
    Wn = D + P - 1                  # search-window side
    pad = S + r + 3
    H, W = img_prev.shape
    K = uv_prev.shape[0]
    prev_p = F.pad(img_prev[None, None], (pad,) * 4, mode="replicate")[0, 0]
    next_p = F.pad(img_next[None, None], (pad,) * 4, mode="replicate")[0, 0]

    # template: bilinear (P+2)^2 patch (P^2 plus a 1-px gradient ring)
    xq = torch.clamp(uv_prev[:, 0], 0.0, W - 1.001)
    yq = torch.clamp(uv_prev[:, 1], 0.0, H - 1.001)
    x0 = torch.floor(xq).to(torch.int64)
    y0 = torch.floor(yq).to(torch.int64)
    fx = (xq - x0)[:, None, None]
    fy = (yq - y0)[:, None, None]
    nT = P + 2
    G = _windows(prev_p, y0 - (r + 1) + pad, x0 - (r + 1) + pad, nT + 1)
    rows = (1.0 - fy) * G[:, :-1, :] + fy * G[:, 1:, :]
    T1 = (1.0 - fx) * rows[:, :, :-1] + fx * rows[:, :, 1:]   # (K, nT, nT)
    tmpl = T1[:, 1:-1, 1:-1]
    gx = (T1[:, 1:-1, 2:] - T1[:, 1:-1, :-2]) * 0.5
    gy = (T1[:, 2:, 1:-1] - T1[:, :-2, 1:-1]) * 0.5

    # search window: (Wn, Wn) crop of the next image, anchor
    # floor(guess) - S - r
    gx0 = torch.clamp(uv_guess[:, 0], 0.0, W - 1.001)
    gy0 = torch.clamp(uv_guess[:, 1], 0.0, H - 1.001)
    ax = torch.floor(gx0).to(torch.int64) - S - r
    ay = torch.floor(gy0).to(torch.int64) - S - r
    win = _windows(next_p, ay + pad, ax + pad, Wn)             # (K, Wn, Wn)
    anchor = torch.stack([ax, ay], dim=-1).to(uv_guess.dtype)

    # correlation maps C[k, c, d, e] = <win[k, d+., e+.], g_c[k]>, both
    # gradients at once: a depthwise convolution, 2 outputs per keypoint
    weight = torch.stack([gx, gy], dim=1).reshape(2 * K, 1, P, P)
    C = F.conv2d(win[None], weight, groups=K)[0].reshape(K, 2, D, D)
    cx0 = torch.sum(tmpl * gx, dim=(1, 2))
    cy0 = torch.sum(tmpl * gy, dim=(1, 2))
    gxx = torch.sum(gx * gx, dim=(1, 2)) + 1e-3
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2)) + 1e-3
    det = torch.clamp(gxx * gyy - gxy * gxy, min=1e-9)

    grid = torch.arange(D, dtype=uv_prev.dtype, device=uv_prev.device)

    def hats(q):
        """(K, D) separable bilinear hat weights at offsets q (K,)."""
        return torch.clamp(1.0 - torch.abs(grid[None, :] - q[:, None]), min=0.0)

    p = uv_guess
    for _ in range(iters):
        # patch top-left in window-grid coordinates
        q = torch.clamp(p - anchor - r, 0.0, 2.0 * S + 0.999)
        b = torch.einsum("kcde,kd,ke->kc", C, hats(q[:, 1]), hats(q[:, 0]))
        bx = b[:, 0] - cx0
        by = b[:, 1] - cy0
        dx = (gyy * bx - gxy * by) / det
        dy = (gxx * by - gxy * bx) / det
        p = p - torch.stack([dx, dy], dim=-1)

    # final photometric error: the bilinear window sample is separable
    qf = torch.clamp(p - anchor - r, 0.0, 2.0 * S + 0.999)
    win_y = torch.einsum("kdci,kd->kic", win.unfold(1, P, 1), hats(qf[:, 1]))
    cur = torch.einsum("kiej,ke->kij", win_y.unfold(2, P, 1), hats(qf[:, 0]))
    err = torch.mean(torch.abs(cur - tmpl), dim=(1, 2))
    return p, err


def _pyramid2(img: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Factor-2 pyramid with the reference's antialiased resize."""
    levels = [img]
    for _ in range(1, n_levels):
        H, W = levels[-1].shape
        levels.append(resize_bilinear(levels[-1], (H // 2, W // 2)).contiguous())
    return levels


def lk_track(img_prev: torch.Tensor, img_next: torch.Tensor,
             uv_prev: torch.Tensor, valid: torch.Tensor, n_levels: int = 3,
             half_win: int = 7, iters: int = 8,
             max_err: float = 20.0) -> FlowResult:
    """Track keypoints uv_prev (K, 2), level-0 pixels, from img_prev to
    img_next, coarse to fine."""
    pyr_prev = _pyramid2(img_prev, n_levels)
    pyr_next = _pyramid2(img_next, n_levels)
    top = n_levels - 1
    guess = uv_prev / (2.0 ** top)
    for lvl in range(top, -1, -1):
        guess, err = _track_level(pyr_prev[lvl], pyr_next[lvl],
                                  uv_prev / (2.0 ** lvl), guess, half_win, iters)
        if lvl > 0:
            guess = guess * 2.0
    H, W = img_next.shape
    inb = ((guess[:, 0] >= half_win) & (guess[:, 0] < W - half_win)
           & (guess[:, 1] >= half_win) & (guess[:, 1] < H - half_win))
    return FlowResult(uv_next=guess, err=err, ok=valid & inb & (err < max_err))


def lk_track_batch(imgs_prev: Sequence[torch.Tensor], imgs_next: Sequence[torch.Tensor],
                   uvs_prev: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                   **kwargs) -> FlowResult:
    """`lk_track` over a batch of image pairs (a chunk's hoisted forward
    flow): the fields gain a leading batch dimension. The pairs run one
    after another, so each result equals its per-pair call."""
    res = [lk_track(a, b, uv, v, **kwargs)
           for a, b, uv, v in zip(imgs_prev, imgs_next, uvs_prev, valids)]
    return FlowResult(*(torch.stack(f) for f in zip(*res)))
