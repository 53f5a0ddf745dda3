"""Oriented BRIEF-256: intensity-centroid angle + steered BRIEF
(counterpart of lc_crf_slam_tpu/ops/orb.py), in two variants.

"matmul" (the default): one 45x45 patch per keypoint feeds both the angle
and an in-patch blur; the blurred 39x39 support times the angle-binned
difference matrix (`_brief_bin_matrix`, bilinear sample taps) gives every
bin's sample differences, and the keypoint's two neighbouring bins are
interpolated. "direct" (the reference semantics, computeOrbDescriptor):
the angle from a 31x31 patch (`ic_angles`), and each pair's two samples
read from the blurred level at their positions rotated by the exact angle
and rounded (`brief_descriptors_direct`).
Descriptors are (K, 8) int32 bit-views of the reference's uint32 words.
`brief_pattern` and `_brief_bin_matrix` are numpy constants, rebuilt here
by the reference's own recipe (a test holds them equal).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._ops import words_to_int32
from .pyramid import gaussian_kernel

HALF_PATCH = 15       # orientation circle radius (patch 31)
PATCH_MARGIN = 19     # descriptor gather half-width (covers rotated pairs)
N_ANGLE_BINS = 30     # steered-BRIEF angle discretisation


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(256, 4) int8 sampling pairs (x1, y1, x2, y2), radius <= 13."""
    rng = np.random.default_rng(42)
    return np.clip(
        np.round(rng.normal(0.0, 31 / 5.0, size=(256, 4))), -13, 13
    ).astype(np.int8)


@functools.lru_cache(maxsize=4)
def _brief_pattern_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(brief_pattern().astype(np.float32)).to(device)


@functools.lru_cache(maxsize=1)
def _ic_mask():
    """(31, 31) circular mask and coordinate grids for the moment sums."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = (xs * xs + ys * ys) <= r * r
    return mask.astype(np.float32), xs.astype(np.float32), ys.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _ic_weights(device: torch.device):
    mask, xs, ys = _ic_mask()
    return (torch.from_numpy(mask * xs).to(device),
            torch.from_numpy(mask * ys).to(device))


@functools.lru_cache(maxsize=1)
def _brief_bin_matrix() -> np.ndarray:
    """(39*39, 30*256) float32 difference-selection matrix: column (b, i)
    holds the bilinear taps of pair i's second sample (+w) and first
    sample (-w), both rotated by bin b's angle."""
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
            for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)),
                              (1, 0, fx * (1 - fy)),
                              (0, 1, (1 - fx) * fy),
                              (1, 1, fx * fy)):
                idx = ((y0 + dy + PATCH_MARGIN) * size
                       + (x0 + dx + PATCH_MARGIN)).astype(int)
                np.add.at(D, (idx, b, np.arange(256)),
                          (sign * w).astype(np.float32))
    return D.reshape(size * size, N_ANGLE_BINS * 256)


@functools.lru_cache(maxsize=4)
def _brief_bin_matrix_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_brief_bin_matrix()).to(device)


def _gather_patches(img: torch.Tensor, uv: torch.Tensor, half: int) -> torch.Tensor:
    """(H, W), (K, 2) int (x, y) -> (K, 2*half+1, 2*half+1) patches; start
    indices clamp at the borders (dynamic_slice semantics)."""
    size = 2 * half + 1
    H, W = img.shape
    ar = torch.arange(size, device=img.device)
    y0 = torch.clamp(uv[:, 1] - half, 0, H - size).long()
    x0 = torch.clamp(uv[:, 0] - half, 0, W - size).long()
    return img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def ic_angles_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation from (K, S, S) unblurred patches,
    S >= 31 odd (centre 31x31 used): (K,) radians."""
    wx, wy = _ic_weights(patches.device)
    m = patches.shape[1] // 2 - HALF_PATCH
    ctr = patches[:, m:m + 2 * HALF_PATCH + 1, m:m + 2 * HALF_PATCH + 1]
    m10 = torch.sum(ctr * wx, dim=(-2, -1))
    m01 = torch.sum(ctr * wy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def ic_angles(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation of each keypoint from its 31x31
    patch of the unblurred level image: (K,) radians."""
    return ic_angles_from_patches(_gather_patches(img, uv, HALF_PATCH))


def brief_descriptors_direct(img_blur: torch.Tensor, uv: torch.Tensor,
                             angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 sampled on the blurred level image directly: each
    pair's two points rotated by the keypoint's angle, rounded to the
    pixel and clamped to the image; bit = first sample < second. (K, 8)
    int32."""
    pat = _brief_pattern_on(img_blur.device)
    ca, sa = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None, None]
    px = torch.stack([pat[:, 0], pat[:, 2]], dim=-1)         # (256, 2)
    py = torch.stack([pat[:, 1], pat[:, 3]], dim=-1)
    rx = torch.round(ca * px - sa * py).to(torch.int64)
    ry = torch.round(sa * px + ca * py).to(torch.int64)
    H, W = img_blur.shape
    x = torch.clamp(uv[:, 0:1, None].to(torch.int64) + rx, 0, W - 1)
    y = torch.clamp(uv[:, 1:2, None].to(torch.int64) + ry, 0, H - 1)
    vals = img_blur.reshape(-1)[y * W + x]                     # (K, 256, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])


def _blur_patches(patches: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of (K, S, S) patches, edges replicated."""
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


def brief_descriptors_matmul(patches: torch.Tensor,
                             angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 from (K, 45, 45) unblurred patches: (K, 8) int32."""
    K = patches.shape[0]
    blurred = _blur_patches(patches)[:, 3:-3, 3:-3]
    flat = blurred.reshape(K, -1)
    diffs = (flat @ _brief_bin_matrix_on(patches.device)).reshape(
        K, N_ANGLE_BINS, 256)
    two_pi = 2.0 * math.pi
    pos = torch.remainder(angles, two_pi) / (two_pi / N_ANGLE_BINS)
    fl = torch.floor(pos)
    b0 = fl.long() % N_ANGLE_BINS
    b1 = (b0 + 1) % N_ANGLE_BINS
    w = (pos - fl)[:, None]
    rows = torch.arange(K, device=patches.device)
    d = (1.0 - w) * diffs[rows, b0] + w * diffs[rows, b1]
    # strict threshold: on flat regions d is f32 roundoff of a 1521-term dot
    return pack_bits(d > 0.1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32, bit j of word w = bits[:, 32w + j]."""
    K = bits.shape[0]
    b = bits.reshape(K, 8, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return words_to_int32(torch.sum(b << shifts, dim=-1))


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(K, 8) int32 -> (K, 256) bool."""
    K = words.shape[0]
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, :, None] >> shifts) & 1).reshape(K, 256).bool()
