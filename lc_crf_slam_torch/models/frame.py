"""Frame front-end: image -> fixed-capacity oriented-ORB feature set
(counterpart of lc_crf_slam_tpu/models/frame.py).

pyramid -> dual-threshold FAST + NMS (the CUDA kernel on the card) ->
grid top-k selection -> IC orientation + steered BRIEF-256 -> depth
lookup -> virtual right coordinate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SLAMConfig
from ..geometry.camera import Pinhole, undistort_pixels
from ..ops.fast_kernel import fast_score_dual_nms
from ..ops.orb import (
    PATCH_MARGIN,
    _gather_patches,
    brief_descriptors_matmul,
    ic_angles_from_patches,
)
from ..ops.pyramid import build_pyramid, features_per_level
from ..ops.select import select_keypoints


class Frame(NamedTuple):
    """Fixed-capacity feature set of one RGB-D frame (all arrays length K)."""

    uv: torch.Tensor        # (K, 2) float32 undistorted level-0 pixel coords
    level: torch.Tensor     # (K,) int32 pyramid level
    angle: torch.Tensor     # (K,) float32 orientation (radians)
    score: torch.Tensor     # (K,) float32 FAST score
    desc: torch.Tensor      # (K, 8) int32 bit-views of the uint32 ORB words
    depth: torch.Tensor     # (K,) float32 measured depth, 0 where invalid
    u_right: torch.Tensor   # (K,) float32 virtual right u; -1 where no depth
    valid: torch.Tensor     # (K,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def orient_and_describe(cfg: SLAMConfig, img_l: torch.Tensor, uv_l: torch.Tensor):
    """IC orientation + steered BRIEF-256 of one level's keypoints (the
    "matmul" variant, the reference's default)."""
    if cfg.orb.descriptor_variant != "matmul":
        raise NotImplementedError(
            f"descriptor_variant={cfg.orb.descriptor_variant!r} is not ported")
    patches_l = _gather_patches(img_l, uv_l, PATCH_MARGIN + 3)
    ang_l = ic_angles_from_patches(patches_l)
    return ang_l, brief_descriptors_matmul(patches_l, ang_l)


def build_frame(cam: Pinhole, cfg: SLAMConfig, gray: torch.Tensor,
                depth_img: torch.Tensor) -> Frame:
    """(H, W) float32 grayscale + (H, W) float32 depth [m] -> Frame."""
    orb = cfg.orb
    levels = build_pyramid(gray, orb.n_levels, orb.scale_factor)
    quotas = features_per_level(orb.max_keypoints, orb.n_levels, orb.scale_factor)
    dev = gray.device

    uv_all, lvl_all, ang_all, sc_all, desc_all, val_all = [], [], [], [], [], []
    for l, img_l in enumerate(levels):
        hi, lo = fast_score_dual_nms(
            img_l, float(orb.ini_th_fast), float(orb.min_th_fast))
        uv_l, sc_l, val_l = select_keypoints(
            hi, lo, quotas[l], cell=orb.cell_size, margin=orb.edge_margin)
        ang_l, desc_l = orient_and_describe(cfg, img_l, uv_l)
        uv_all.append(uv_l.to(torch.float32) * (orb.scale_factor**l))
        lvl_all.append(torch.full((quotas[l],), l, dtype=torch.int32, device=dev))
        ang_all.append(ang_l)
        sc_all.append(sc_l)
        desc_all.append(desc_l)
        val_all.append(val_l)

    uv = torch.cat(uv_all)
    valid = torch.cat(val_all)
    uv_und = undistort_pixels(cam, uv)

    # depth lookup at the detection location
    xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, cam.width - 1)
    yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, cam.height - 1)
    d = depth_img[yi, xi]
    has_d = (d > 0) & valid
    u_right = torch.where(
        has_d, uv_und[:, 0] - cam.bf / torch.where(has_d, d, 1.0), -1.0)

    return Frame(
        uv=torch.where(valid[:, None], uv_und, 0.0),
        level=torch.cat(lvl_all),
        angle=torch.cat(ang_all),
        score=torch.cat(sc_all),
        desc=torch.cat(desc_all),
        depth=torch.where(has_d, d, 0.0),
        u_right=u_right,
        valid=valid,
    )
