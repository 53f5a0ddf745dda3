"""Stereo matching: left-right feature association along epipolar rows
(counterpart of lc_crf_slam_tpu/ops/stereo.py; Frame::ComputeStereoMatches).

Each left keypoint searches the right keypoints inside a row band (wider
on coarser pyramid levels), a disparity range and one pyramid level of
its own, by Hamming distance with a ratio test: one masked (K, K)
matching problem. A match gives the virtual right coordinate uR and the
depth z = bf / disparity.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry.camera import Pinhole
from .match import hamming_matrix, match_nn


def stereo_match(
    cam: Pinhole,
    uv_l: torch.Tensor, level_l: torch.Tensor, desc_l: torch.Tensor,
    valid_l: torch.Tensor,
    uv_r: torch.Tensor, level_r: torch.Tensor, desc_r: torch.Tensor,
    valid_r: torch.Tensor,
    max_dist: int = 100,
    row_tolerance: float = 2.0,
    min_disparity: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_right (K,), depth (K,)) per left feature; -1 / 0 where unmatched."""
    band = row_tolerance * (1.0 + 0.5 * level_l[:, None].to(torch.float32))
    row_gate = torch.abs(uv_l[:, 1][:, None] - uv_r[:, 1][None, :]) <= band
    disparity = uv_l[:, 0][:, None] - uv_r[:, 0][None, :]
    max_disp = cam.bf / 0.3   # the closest depth represented: 0.3 m
    disp_gate = (disparity >= min_disparity) & (disparity <= max_disp)
    lvl_gate = torch.abs(level_l[:, None] - level_r[None, :]) <= 1
    gate = row_gate & disp_gate & lvl_gate & valid_l[:, None] & valid_r[None, :]
    r = match_nn(hamming_matrix(desc_l, desc_r), mask=gate, max_dist=max_dist,
                 ratio=0.9)
    disp = torch.gather(disparity, 1, r.idx[:, None])[:, 0]
    ok = r.valid & (disp > min_disparity)
    u_right = torch.where(ok, uv_r[r.idx, 0], -1.0)
    depth = torch.where(ok, cam.bf / torch.clamp(disp, min=min_disparity), 0.0)
    return u_right, depth
