"""The plain stereo front end, for holding the program's to: the
left-right row match of a rectified pair, and with `frontend.py`'s
`reference_frame` on each eye the whole front end of a stereo frame
(tests/test_torch_stereo_reference.py).

Written from the semantics the program and the JAX package share, in
float32 with no kernel. For each valid left keypoint (level l, pixel
(u, v)) the candidates are the valid right keypoints
- in a row band: |v - v_r| <= 2 * (1 + 0.5 * l) px;
- at a disparity d = u - u_r within [0.1, bf / 0.3] (no point nearer
  than 0.3 m);
- at a pyramid level at most one away from l.
The match is the candidate nearest in Hamming distance (the lowest right
index among equals), kept where that distance is at most 100 and under
0.9 times the second nearest candidate's (a lone candidate passes), and
where its disparity is above 0.1. It gives uR = u_r and z = bf / d; an
unmatched keypoint reads uR = -1, z = 0.

Departures from ORB-SLAM2's `Frame::ComputeStereoMatches`, which the
program shares:
- no SAD patch refinement along the row and no parabolic sub-pixel fit:
  uR is the right keypoint's own column, so a depth is quantised to the
  keypoints' (level-scaled) pixel grid;
- no cull of the matches whose SAD distance exceeds 1.5 * 1.4 times the
  median;
- the row band is 2 * (1 + 0.5 * l) px around the left keypoint's row,
  l its level, in place of 2 * scale^o px around each right keypoint's
  row, o that keypoint's octave (both take right keypoints of levels
  l - 1 to l + 1);
- a match needs a Hamming distance of at most 100 and the ratio test,
  where ORB-SLAM2 takes the nearest under (TH_HIGH + TH_LOW) / 2 = 75
  with no ratio test;
- the nearest depth is 0.3 m, where ORB-SLAM2's is one baseline.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .frontend import RefFrame, reference_frame

MAX_DIST = 100          # the largest Hamming distance of a match (TH_HIGH)
RATIO = 0.9             # best under RATIO times the second best
ROW_BAND = 2.0          # px of row band at level 0
MIN_DISPARITY = 0.1     # px
MIN_DEPTH = 0.3         # m: the nearest depth represented
UNMATCHED = 10_000      # a distance no pair of 256-bit descriptors reaches


class StereoFrame(NamedTuple):
    """The left eye's keypoints with the depth of their right match."""

    left: RefFrame
    u_right: torch.Tensor   # (K,) float32, -1 where unmatched
    depth: torch.Tensor     # (K,) float32 [m], 0 where unmatched


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def hamming(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 descriptor words -> (N, M) int64 distances."""
    out = torch.zeros((desc_a.shape[0], desc_b.shape[0]), dtype=torch.int64,
                      device=desc_a.device)
    for w in range(desc_a.shape[1]):
        out += _popcount32(desc_a[:, None, w] ^ desc_b[None, :, w])
    return out


def stereo_match(left: RefFrame, right: RefFrame,
                 bf: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_right, depth) of each left keypoint, as the module's docstring
    states, of two eyes' keypoints (`RefFrame`s) and the rig's baseline
    times fx, `bf`."""
    u_l, v_l = left.uv[:, 0], left.uv[:, 1]
    u_r, v_r = right.uv[:, 0], right.uv[:, 1]
    band = ROW_BAND * (1.0 + 0.5 * left.level.to(torch.float32))
    disparity = u_l[:, None] - u_r[None, :]
    allowed = ((torch.abs(v_l[:, None] - v_r[None, :]) <= band[:, None])
               & (disparity >= MIN_DISPARITY) & (disparity <= bf / MIN_DEPTH)
               & (torch.abs(left.level[:, None] - right.level[None, :]) <= 1)
               & left.valid[:, None] & right.valid[None, :])
    dist = torch.where(allowed, hamming(left.desc, right.desc), UNMATCHED)
    best, j = torch.min(dist, dim=1)     # the first of equal minima
    rows = torch.arange(dist.shape[0], device=dist.device)
    rest = dist.clone()
    rest[rows, j] = UNMATCHED
    second = torch.min(rest, dim=1).values
    d = disparity[rows, j]
    ok = ((best <= MAX_DIST)
          & (best.to(torch.float32) < RATIO * second.to(torch.float32))
          & (d > MIN_DISPARITY))
    u_right = torch.where(ok, u_r[j], -1.0)
    depth = torch.where(ok, bf / torch.clamp(d, min=MIN_DISPARITY), 0.0)
    return u_right, depth


def reference_stereo_frame(left: np.ndarray, right: np.ndarray, orb: dict, bf: float,
                           device) -> StereoFrame:
    """The plain front end of a rectified pair of (H, W) float32 images:
    `reference_frame` of each eye (no depth image), then the row match."""
    no_depth = np.zeros_like(left)
    fl = reference_frame(left, no_depth, orb, device)
    fr = reference_frame(right, no_depth, orb, device)
    u_right, depth = stereo_match(fl, fr, bf)
    return StereoFrame(left=fl, u_right=u_right, depth=depth)
