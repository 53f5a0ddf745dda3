"""Image pyramid + Gaussian blur (counterpart of lc_crf_slam_tpu/ops/pyramid.py).

The reference resizes with `jax.image.resize(..., "bilinear")`, which
antialiases when downsampling (a triangle filter widened by 1/scale).
`F.interpolate(mode="bilinear")` without antialias differs from it by up
to 70 graylevels, and with `antialias=True` by a few 1e-3. So the port
builds the same separable weight matrices as jax (its
`compute_weight_mat`, in float32) and applies them as two products.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch


def pyramid_shapes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """Static (H, W) per level."""
    return [
        (int(round(height / scale_factor**l)), int(round(width / scale_factor**l)))
        for l in range(n_levels)
    ]


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 antialiased triangle-filter weights: the
    matrix jax.image.resize contracts with (translation 0), as XLA:CPU
    compiles it (sample positions by one fused multiply-add, the kernel
    width applied as a reciprocal) to within one ulp."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))   # a Python-float constant in jax's trace
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


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., *shape), jax.image.resize(method="bilinear")
    semantics; leading dimensions are a batch."""
    H, W = img.shape[-2:]
    h, w = shape
    out = img
    if h != H:
        out = _resize_weights(H, h, img.device).T @ out
    if w != W:
        out = out @ _resize_weights(W, w, img.device)
    return out


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """Grayscale (H, W) float32 -> n_levels images, each resized from the
    previous one (level 0 = input)."""
    H, W = img.shape
    shapes = pyramid_shapes(H, W, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]).contiguous())
    return levels


class PyramidBatch(NamedTuple):
    """The pyramids of a batch of frames in one allocation: frame b's level
    l is the contiguous (H_l, W_l) image at `flat[b, offsets[l]:]`. One
    FAST launch takes the whole buffer."""

    flat: torch.Tensor                      # (B, sum H_l * W_l) float32
    shapes: Tuple[Tuple[int, int], ...]     # (H_l, W_l) per level

    @property
    def offsets(self) -> List[int]:
        """First element of each level in a frame's row of `flat`."""
        out, off = [], 0
        for h, w in self.shapes:
            out.append(off)
            off += h * w
        return out

    def level(self, l: int) -> torch.Tensor:
        """(B, H_l, W_l) view of level l."""
        h, w = self.shapes[l]
        off = self.offsets[l]
        return self.flat[:, off: off + h * w].view(-1, h, w)


def build_pyramid_batch(imgs: torch.Tensor, n_levels: int,
                        scale_factor: float) -> PyramidBatch:
    """Grayscale (B, H, W) float32 -> the B pyramids of `build_pyramid` in
    one buffer (the resize is two products with fixed weight matrices, so
    the batch rides a leading dimension)."""
    B, H, W = imgs.shape
    shapes = tuple(pyramid_shapes(H, W, n_levels, scale_factor))
    pyr = PyramidBatch(
        imgs.new_empty((B, sum(h * w for h, w in shapes))), shapes)
    prev = imgs
    pyr.level(0).copy_(prev)
    for l in range(1, n_levels):
        prev = resize_bilinear(prev, shapes[l])
        pyr.level(l).copy_(prev)
    return pyr


@functools.lru_cache(maxsize=8)
def gaussian_kernel(ksize: int, sigma: float) -> Tuple[float, ...]:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return tuple(float(v) for v in k)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, (H, W) -> (H, W).
    Taps are float32, summed in tap order like the reference."""
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    H, W = img.shape
    pad = torch.nn.functional.pad
    p = pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + k[i] * p[:, i: i + W]
    p = pad(out[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out2 = torch.zeros_like(img)
    for i in range(ksize):
        out2 = out2 + k[i] * p[i: i + H, :]
    return out2


def level_scales(n_levels: int, scale_factor: float) -> torch.Tensor:
    """(n_levels,) float32 scale of each pyramid level: scale_factor^l."""
    return torch.tensor([scale_factor**l for l in range(n_levels)], dtype=torch.float32)


def features_per_level(n_features: int, n_levels: int,
                       scale_factor: float) -> List[int]:
    """ORB-style per-level feature quota: N_l ∝ (1/s^2)^l, summing to
    n_features."""
    q = 1.0 / (scale_factor * scale_factor)
    raw = [q**l for l in range(n_levels)]
    total = sum(raw)
    quota = [max(1, int(round(n_features * r / total))) for r in raw]
    quota[0] += n_features - sum(quota)
    return quota
