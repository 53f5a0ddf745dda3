"""Frame front-end: image -> fixed-capacity oriented-ORB feature set
(counterpart of lc_crf_slam_tpu/models/frame.py).

pyramid -> dual-threshold FAST + NMS + best corner per cell (one launch
of the fused CUDA kernel on the card, for all levels of all frames of a
batch) -> top-k over cells -> IC orientation + steered BRIEF-256 -> depth
lookup -> virtual right coordinate.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..config import SLAMConfig
from ..geometry.camera import Pinhole, undistort_pixels
from ..ops.fast_kernel import fast_cell_best
from ..ops.orb import (
    PATCH_MARGIN,
    _gather_patches,
    brief_descriptors_matmul,
    ic_angles_from_patches,
)
from ..ops.pyramid import build_pyramid_batch, features_per_level
from ..ops.select import select_from_cells


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


def build_frames(cam: Pinhole, cfg: SLAMConfig, grays: torch.Tensor,
                 depth_imgs: torch.Tensor) -> List[Frame]:
    """(B, H, W) float32 grayscale + (B, H, W) float32 depth [m] -> B
    Frames, each what `build_frame` makes of its image. The pyramids, the
    FAST launch and the top-k over cells are batched; orientation and
    descriptors run per frame and level."""
    orb = cfg.orb
    pyr = build_pyramid_batch(grays, orb.n_levels, orb.scale_factor)
    quotas = features_per_level(orb.max_keypoints, orb.n_levels, orb.scale_factor)
    cells = fast_cell_best(pyr, float(orb.ini_th_fast), float(orb.min_th_fast),
                           orb.cell_size, orb.edge_margin)
    picked = [select_from_cells(*cells[l], quotas[l]) for l in range(orb.n_levels)]
    dev = grays.device
    level = torch.cat([torch.full((q,), l, dtype=torch.int32, device=dev)
                       for l, q in enumerate(quotas)])

    frames = []
    for b in range(grays.shape[0]):
        uv_all, ang_all, desc_all = [], [], []
        for l, (uv_l, _, _) in enumerate(picked):
            ang_l, desc_l = orient_and_describe(cfg, pyr.level(l)[b], uv_l[b])
            uv_all.append(uv_l[b].to(torch.float32) * (orb.scale_factor**l))
            ang_all.append(ang_l)
            desc_all.append(desc_l)
        uv = torch.cat(uv_all)
        valid = torch.cat([val_l[b] for _, _, val_l in picked])
        uv_und = undistort_pixels(cam, uv)

        # depth lookup at the detection location
        xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, cam.width - 1)
        yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, cam.height - 1)
        d = depth_imgs[b][yi, xi]
        has_d = (d > 0) & valid
        u_right = torch.where(
            has_d, uv_und[:, 0] - cam.bf / torch.where(has_d, d, 1.0), -1.0)
        frames.append(Frame(
            uv=torch.where(valid[:, None], uv_und, 0.0),
            level=level,
            angle=torch.cat(ang_all),
            score=torch.cat([sc_l[b] for _, sc_l, _ in picked]),
            desc=torch.cat(desc_all),
            depth=torch.where(has_d, d, 0.0),
            u_right=u_right,
            valid=valid,
        ))
    return frames


def build_frame(cam: Pinhole, cfg: SLAMConfig, gray: torch.Tensor,
                depth_img: torch.Tensor) -> Frame:
    """(H, W) float32 grayscale + (H, W) float32 depth [m] -> Frame."""
    return build_frames(cam, cfg, gray[None], depth_img[None])[0]
