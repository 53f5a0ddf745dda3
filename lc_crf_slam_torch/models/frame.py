"""Frame front-end: image -> fixed-capacity oriented-ORB feature set
(counterpart of lc_crf_slam_tpu/models/frame.py).

pyramid -> dual-threshold FAST + NMS + best corner per cell (one launch
of the fused CUDA kernel on the card, for all levels of all frames of a
batch) -> top-k over cells -> IC orientation + steered BRIEF-256 (either
variant) -> depth lookup -> virtual right coordinate.
`frame_from_observations` makes a Frame from given keypoints instead (the
observation-level entry points).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .._ops import u32_to_i32
from ..config import SLAMConfig
from ..geometry.camera import Pinhole, undistort_pixels
from ..ops.fast_kernel import fast_cell_best
from ..ops.orb import (
    PATCH_MARGIN,
    _gather_patches,
    brief_descriptors_direct,
    brief_descriptors_matmul,
    ic_angles,
    ic_angles_from_patches,
)
from ..ops.pyramid import build_pyramid_batch, features_per_level, gaussian_blur
from ..ops.select import select_from_cells
from ..ops.stereo import stereo_match
from ..utils.profiling import span


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
    """IC orientation + steered BRIEF-256 of one level's keypoints, by
    `cfg.orb.descriptor_variant`: "matmul" (the default: one 45x45 patch
    feeds the angle and the angle-binned difference matmul) or "direct"
    (the reference semantics: the exact-angle rotated samples of the
    blurred level)."""
    variant = cfg.orb.descriptor_variant
    if variant == "matmul":
        patches_l = _gather_patches(img_l, uv_l, PATCH_MARGIN + 3)
        ang_l = ic_angles_from_patches(patches_l)
        return ang_l, brief_descriptors_matmul(patches_l, ang_l)
    if variant != "direct":
        raise ValueError(f"descriptor_variant={variant!r}: 'matmul' or 'direct'")
    ang_l = ic_angles(img_l, uv_l)
    return ang_l, brief_descriptors_direct(gaussian_blur(img_l, 7, 2.0), uv_l, ang_l)


def build_frames(cam: Pinhole, cfg: SLAMConfig, grays: torch.Tensor,
                 depth_imgs: Optional[torch.Tensor],
                 grays_right: Optional[torch.Tensor] = None) -> List[Frame]:
    """(B, H, W) float32 grayscale + (B, H, W) float32 depth [m] -> B
    Frames, each what `build_frame` makes of its image; `depth_imgs=None`
    for images without depth (stereo eyes, monocular). The pyramids, the
    FAST launch and the top-k over cells are batched; orientation and
    descriptors run per frame and level.

    With `grays_right`, the (B, H, W) right eyes of rectified pairs
    (`grays` the left ones, `depth_imgs` None), the B Frames are the
    pairs' left eyes with their depth and uR from the row match, as
    ORB-SLAM2's stereo Frame constructor makes them (`_stereo_frames`)."""
    if grays_right is not None:
        return _stereo_frames(cam, cfg, grays, grays_right)
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

        # depth lookup at the raw (distorted) detection location
        if depth_imgs is None:
            d = torch.zeros_like(uv[:, 0])
        else:
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


def _stereo_frames(cam: Pinhole, cfg: SLAMConfig, grays_left: torch.Tensor,
                   grays_right: torch.Tensor) -> List[Frame]:
    """Frame::ComputeStereoMatches of B pairs: all 2B images in one
    extraction (span `frontend.extract`), then the row match of each pair
    (span `stereo_match`)."""
    B = grays_left.shape[0]
    with span("frontend.extract"):
        frames = build_frames(cam, cfg, torch.cat([grays_left, grays_right]), None)
    out = []
    with span("stereo_match"):
        for fl, fr in zip(frames[:B], frames[B:]):
            u_right, depth = stereo_match(cam, fl.uv, fl.level, fl.desc, fl.valid,
                                          fr.uv, fr.level, fr.desc, fr.valid)
            out.append(fl._replace(u_right=u_right, depth=depth))
    return out


def build_frame(cam: Pinhole, cfg: SLAMConfig, gray: torch.Tensor,
                depth_img: Optional[torch.Tensor]) -> Frame:
    """(H, W) float32 grayscale + (H, W) float32 depth [m] (or None) -> Frame."""
    return build_frames(cam, cfg, gray[None],
                        None if depth_img is None else depth_img[None])[0]


def frame_from_observations(uv, depth, desc, capacity: int,
                            cam: Pinhole | None = None,
                            device: str | torch.device = "cpu") -> Frame:
    """A Frame built directly from observations (keypoints (M, 2), depth
    (M,), descriptors (M, 8) as uint32 words or their int32 bit-views),
    bypassing the image front-end: the pipeline-test path. Pads or
    truncates to `capacity`; every feature is level 0 with angle 0."""
    if isinstance(desc, np.ndarray) and desc.dtype == np.uint32:
        desc = u32_to_i32(desc)
    n = min(len(uv), capacity)

    def pad(x, dtype):
        x = torch.as_tensor(x[:n]).to(device=device, dtype=dtype)
        return torch.cat([x, x.new_zeros((capacity - n,) + tuple(x.shape[1:]))])

    uvp = pad(uv, torch.float32)
    dp = pad(depth, torch.float32)
    valid = torch.arange(capacity, device=device) < n
    bf = cam.bf if cam is not None else 40.0
    has_d = (dp > 0) & valid
    return Frame(
        uv=uvp,
        level=torch.zeros((capacity,), dtype=torch.int32, device=device),
        angle=torch.zeros((capacity,), dtype=torch.float32, device=device),
        score=torch.where(valid, 1.0, 0.0),
        desc=pad(desc, torch.int32),
        depth=torch.where(valid, dp, 0.0),
        u_right=torch.where(has_d, uvp[:, 0] - bf / torch.where(dp > 0, dp, 1.0), -1.0),
        valid=valid,
    )
