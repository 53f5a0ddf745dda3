"""Pinhole RGB-D camera model (counterpart of lc_crf_slam_tpu/geometry/camera.py).

The port keeps its own `Pinhole` with the reference's field order, since
the reference module imports jax. The port runs distortion-free cameras
only: `undistort_pixels` is the identity path, and `SLAMSystem` refuses a
camera with distortion terms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pinhole(NamedTuple):
    """Static camera parameters (concrete floats)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float = 40.0  # baseline * fx
    # rad-tan distortion
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 1e-12 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def undistort_pixels(cam: Pinhole, uv: torch.Tensor) -> torch.Tensor:
    """Identity for distortion-free cameras, the only ones the port runs."""
    if cam.has_distortion:
        raise NotImplementedError("the port does not undistort keypoints yet")
    return uv


# TUM RGB-D freiburg3 preset (distortion-free, like the reference's TUM3).
TUM3 = Pinhole(fx=535.4, fy=539.2, cx=320.1, cy=247.6,
               width=640, height=480, bf=40.0)
