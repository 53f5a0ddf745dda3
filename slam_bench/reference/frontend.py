"""The plain front end the benchmark judges the program's keypoints and
descriptors by: image pyramid, dual-threshold FAST with 3x3 NMS, the best
corner per 16-px cell, the top-k over cells per level, intensity-centroid
angles and steered BRIEF-256 in the "matmul" form, and the depth lookup.

A frozen copy, in plain PyTorch, of these functions of lc_crf_slam_torch
at commit d6d14bc: `ops/pyramid.py` (`pyramid_shapes`,
`_resize_weights_np`, `resize_bilinear`, `features_per_level`,
`gaussian_kernel`), `ops/fast.py` (`CIRCLE_OFFSETS`, `_has_arc`,
`_score`, `nms3`, `_circle`, `fast_score_dual`), `ops/select.py`
(`_cell_reduce`, `cell_best`, `select_from_cells`), `_ops.py`
(`stable_topk`, `words_to_int32`), `ops/orb.py` (`brief_pattern`,
`_ic_mask`, `_brief_bin_matrix`, `_gather_patches`,
`ic_angles_from_patches`, `_blur_patches`, `brief_descriptors_matmul`,
`pack_bits`) and `models/frame.py` (`build_frames` for one frame of a
camera without distortion). It imports nothing of the program and takes
only the rendered image and depth.

`tf32=True` computes every matrix product with its operands rounded to
TF32 (10 mantissa bits), the precision below the float32 the program
states: the benchmark's control.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9
HALF_PATCH = 15
PATCH_MARGIN = 19
N_ANGLE_BINS = 30


class RefFrame(NamedTuple):
    uv: torch.Tensor      # (K, 2) float32 level-0 pixel coords, 0 where invalid
    level: torch.Tensor   # (K,) int32
    desc: torch.Tensor    # (K, 8) int32 bit-views of the descriptor words
    depth: torch.Tensor   # (K,) float32, 0 where no depth
    valid: torch.Tensor   # (K,) bool


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000 + ((bits >> 13) & 1)) & ~0x1FFF
    return rounded.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return to_tf32(a) @ to_tf32(b) if tf32 else a @ b


# ---- pyramid --------------------------------------------------------------
def pyramid_shapes(height, width, n_levels, scale_factor):
    return [(int(round(height / scale_factor**l)), int(round(width / scale_factor**l)))
            for l in range(n_levels)]


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 antialiased triangle-filter weights."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centres.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, shape, tf32: bool) -> torch.Tensor:
    H, W = img.shape[-2:]
    h, w = shape
    out = img
    if h != H:
        out = matmul(torch.from_numpy(_resize_weights_np(H, h)).to(img.device).T, out, tf32)
    if w != W:
        out = matmul(out, torch.from_numpy(_resize_weights_np(W, w)).to(img.device), tf32)
    return out


def features_per_level(n_features, n_levels, scale_factor):
    q = 1.0 / (scale_factor * scale_factor)
    raw = [q**l for l in range(n_levels)]
    total = sum(raw)
    quota = [max(1, int(round(n_features * r / total))) for r in raw]
    quota[0] += n_features - sum(quota)
    return quota


@functools.lru_cache(maxsize=8)
def gaussian_kernel(ksize: int, sigma: float):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return tuple(float(v) for v in k)


# ---- FAST ----------------------------------------------------------------
def _has_arc(mask):
    ext = torch.cat([mask, mask[: ARC_LENGTH - 1]], dim=0)
    run = ext[:16]
    for j in range(1, ARC_LENGTH):
        run = run & ext[j: j + 16]
    return run.any(dim=0)


def _score(img, circ, t):
    hi = img + t
    lo = img - t
    brighter = circ > hi
    darker = circ < lo
    margin_b = torch.zeros_like(img)
    margin_d = torch.zeros_like(img)
    for k in range(16):
        margin_b = margin_b + torch.where(brighter[k], (circ[k] - img) - t, 0.0)
        margin_d = margin_d + torch.where(darker[k], (img - circ[k]) - t, 0.0)
    sc = torch.maximum(torch.where(_has_arc(brighter), margin_b, 0.0),
                       torch.where(_has_arc(darker), margin_d, 0.0))
    H, W = img.shape
    inside = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    inside[3:H - 3, 3:W - 3] = True
    return torch.where(inside, sc, 0.0)


def nms3(score):
    pad = torch.nn.functional.pad(score[None, None], (1, 1, 1, 1), value=float("-inf"))
    m = torch.nn.functional.max_pool2d(pad, 3, stride=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def fast_score_dual(img, th_high, th_low):
    circ = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for dy, dx in CIRCLE_OFFSETS])
    return nms3(_score(img, circ, th_high)), nms3(_score(img, circ, th_low))


# ---- per-cell best and top-k -----------------------------------------------
def _cell_reduce(score, cell, margin):
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
    arg = torch.argmax((s == best[:, None]).to(torch.uint8), dim=-1)
    cells = torch.arange(ny * nx, device=score.device)
    y = (cells // nx) * cell + arg // cell
    x = (cells % nx) * cell + arg % cell
    return best, y.to(torch.int32), x.to(torch.int32)


def cell_best(score_hi, score_lo, cell, margin):
    b_hi, y_hi, x_hi = _cell_reduce(score_hi, cell, margin)
    b_lo, y_lo, x_lo = _cell_reduce(score_lo, cell, margin)
    use_lo = b_hi <= 0.0
    return (torch.where(use_lo, b_lo, b_hi), torch.where(use_lo, y_lo, y_hi),
            torch.where(use_lo, x_lo, x_hi))


def select_from_cells(best, y, x, k):
    kk = min(k, best.shape[-1])
    vals, idx = torch.sort(best, dim=-1, descending=True, stable=True)
    top, idx = vals[..., :kk], idx[..., :kk]
    uv = torch.stack([torch.gather(x, -1, idx), torch.gather(y, -1, idx)], dim=-1)
    valid = top > 0.0
    if kk < k:
        pad = torch.nn.functional.pad
        uv = pad(uv, (0, 0, 0, k - kk))
        valid = pad(valid, (0, k - kk))
    uv = torch.where(valid[..., None], uv, 0)
    return uv, valid


# ---- orientation and steered BRIEF ------------------------------------------
@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    rng = np.random.default_rng(42)
    return np.clip(np.round(rng.normal(0.0, 31 / 5.0, size=(256, 4))), -13, 13
                   ).astype(np.int8)


@functools.lru_cache(maxsize=1)
def _ic_mask():
    r = HALF_PATCH
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = (xs * xs + ys * ys) <= r * r
    return mask.astype(np.float32), xs.astype(np.float32), ys.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _brief_bin_matrix() -> np.ndarray:
    pat = brief_pattern().astype(np.float64)
    size = 2 * PATCH_MARGIN + 1
    D = np.zeros((size * size, N_ANGLE_BINS, 256), np.float32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for pt, sign in ((0, -1.0), (2, +1.0)):
            x = ca * pat[:, pt] - sa * pat[:, pt + 1]
            y = sa * pat[:, pt] + ca * pat[:, pt + 1]
            x0, y0 = np.floor(x), np.floor(y)
            fx, fy = x - x0, y - y0
            for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                              (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
                idx = ((y0 + dy + PATCH_MARGIN) * size
                       + (x0 + dx + PATCH_MARGIN)).astype(int)
                np.add.at(D, (idx, b, np.arange(256)), (sign * w).astype(np.float32))
    return D.reshape(size * size, N_ANGLE_BINS * 256)


def _gather_patches(img, uv, half):
    size = 2 * half + 1
    H, W = img.shape
    ar = torch.arange(size, device=img.device)
    y0 = torch.clamp(uv[:, 1] - half, 0, H - size).long()
    x0 = torch.clamp(uv[:, 0] - half, 0, W - size).long()
    return img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def ic_angles_from_patches(patches):
    mask, xs, ys = _ic_mask()
    wx = torch.from_numpy(mask * xs).to(patches.device)
    wy = torch.from_numpy(mask * ys).to(patches.device)
    m = patches.shape[1] // 2 - HALF_PATCH
    ctr = patches[:, m:m + 2 * HALF_PATCH + 1, m:m + 2 * HALF_PATCH + 1]
    m10 = torch.sum(ctr * wx, dim=(-2, -1))
    m01 = torch.sum(ctr * wy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def _blur_patches(patches, ksize=7, sigma=2.0):
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    S1, S2 = patches.shape[1], patches.shape[2]
    pad = torch.nn.functional.pad
    p = pad(patches[:, None], (r, r, 0, 0), mode="replicate")[:, 0]
    out = k[0] * p[:, :, 0:S2]
    for i in range(1, ksize):
        out = out + k[i] * p[:, :, i: i + S2]
    p = pad(out[:, None], (0, 0, r, r), mode="replicate")[:, 0]
    res = k[0] * p[:, 0:S1, :]
    for i in range(1, ksize):
        res = res + k[i] * p[:, i: i + S1, :]
    return res


def pack_bits(bits):
    K = bits.shape[0]
    b = bits.reshape(K, 8, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def brief_descriptors_matmul(patches, angles, tf32):
    K = patches.shape[0]
    blurred = _blur_patches(patches)[:, 3:-3, 3:-3]
    flat = blurred.reshape(K, -1)
    D = torch.from_numpy(_brief_bin_matrix()).to(patches.device)
    diffs = matmul(flat, D, tf32).reshape(K, N_ANGLE_BINS, 256)
    two_pi = 2.0 * math.pi
    pos = torch.remainder(angles, two_pi) / (two_pi / N_ANGLE_BINS)
    fl = torch.floor(pos)
    b0 = fl.long() % N_ANGLE_BINS
    b1 = (b0 + 1) % N_ANGLE_BINS
    w = (pos - fl)[:, None]
    rows = torch.arange(K, device=patches.device)
    d = (1.0 - w) * diffs[rows, b0] + w * diffs[rows, b1]
    return pack_bits(d > 0.1)


# ---- one frame -----------------------------------------------------------
def reference_frame(gray: np.ndarray, depth: np.ndarray, orb: dict, device,
                    tf32: bool = False) -> RefFrame:
    """The front end of one (H, W) float32 image and depth [m] under the
    configuration's ORB settings (`n_levels`, `scale_factor`,
    `ini_th_fast`, `min_th_fast`, `cell_size`, `edge_margin`,
    `max_keypoints`), in float32 with TF32 off unless `tf32`."""
    n_levels, sf = orb["n_levels"], orb["scale_factor"]
    img = torch.as_tensor(gray, dtype=torch.float32, device=device).contiguous()
    dimg = torch.as_tensor(depth, dtype=torch.float32, device=device)
    H, W = img.shape
    shapes = pyramid_shapes(H, W, n_levels, sf)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l], tf32).contiguous())
    quotas = features_per_level(orb["max_keypoints"], n_levels, sf)
    uv_all, lvl_all, desc_all, valid_all = [], [], [], []
    for l, lev in enumerate(levels):
        best, y, x = cell_best(*fast_score_dual(lev, float(orb["ini_th_fast"]),
                                                 float(orb["min_th_fast"])),
                               orb["cell_size"], orb["edge_margin"])
        uv_l, val_l = select_from_cells(best, y, x, quotas[l])
        patches = _gather_patches(lev, uv_l, PATCH_MARGIN + 3)
        ang = ic_angles_from_patches(patches)
        desc_all.append(brief_descriptors_matmul(patches, ang, tf32))
        uv_all.append(uv_l.to(torch.float32) * (sf**l))
        lvl_all.append(torch.full((quotas[l],), l, dtype=torch.int32, device=device))
        valid_all.append(val_l)
    uv = torch.cat(uv_all)
    valid = torch.cat(valid_all)
    xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, H - 1)
    d = dimg[yi, xi]
    has_d = (d > 0) & valid
    return RefFrame(uv=torch.where(valid[:, None], uv, 0.0), level=torch.cat(lvl_all),
                    desc=torch.cat(desc_all), depth=torch.where(has_d, d, 0.0),
                    valid=valid)
