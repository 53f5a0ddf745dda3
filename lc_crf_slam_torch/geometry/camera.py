"""Pinhole RGB-D camera model (counterpart of lc_crf_slam_tpu/geometry/camera.py).

The port keeps its own `Pinhole` with the reference's field order, since
the reference module imports jax. Keypoints are undistorted once, at
extraction (Frame::UndistortKeyPoints): `undistort_pixels` inverts the
radial-tangential model by the reference's 8 fixed-point iterations, and
is the identity for a camera without distortion terms.
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

    def intrinsic_matrix(self, device=None) -> torch.Tensor:
        """The 3x3 float32 K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def project_points(cam: Pinhole, p_cam: torch.Tensor):
    """Camera-frame points (..., 3) -> pixel (..., 2), depth (...,); no
    distortion (the pipeline works on undistorted pixels)."""
    z = p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * p_cam[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(cam: Pinhole, p_cam: torch.Tensor):
    """-> (u, v, uR) (..., 3) and depth; uR = u - bf/z (RGB-D virtual right)."""
    uv, z = project_points(cam, p_cam)
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf / z_safe
    return torch.cat([uv, ur[..., None]], dim=-1), z


def unproject_depth(cam: Pinhole, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def in_image(cam: Pinhole, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Boolean mask (...,) for pixels inside the image bounds."""
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))


def _rad_tan(cam: Pinhole, x: torch.Tensor, y: torch.Tensor):
    """(radial factor, tangential dx, dy) of normalised coordinates."""
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return radial, dx, dy


def distort_normalized(cam: Pinhole, xy: torch.Tensor) -> torch.Tensor:
    """Apply rad-tan distortion to normalised coordinates (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    radial, dx, dy = _rad_tan(cam, x, y)
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def undistort_pixels(cam: Pinhole, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert rad-tan distortion for pixels (..., 2) by fixed-point
    iteration (the cv::undistortPoints scheme) with a fixed trip count.
    Identity when the camera has no distortion terms."""
    if not cam.has_distortion:
        return uv
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    x = xd
    for _ in range(iters):
        radial, dx, dy = _rad_tan(cam, x[..., 0], x[..., 1])
        x = torch.stack([xd[..., 0] - dx, xd[..., 1] - dy], dim=-1) / radial[..., None]
    return torch.stack([x[..., 0] * cam.fx + cam.cx, x[..., 1] * cam.fy + cam.cy], dim=-1)


# TUM RGB-D presets (Examples/RGB-D/TUM{1,2,3}.yaml): freiburg1 and 2 with
# their distortion terms, freiburg3 distortion-free.
TUM1 = Pinhole(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
               width=640, height=480, bf=40.0,
               k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
TUM2 = Pinhole(fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
               width=640, height=480, bf=40.0,
               k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105, k3=0.917205)
TUM3 = Pinhole(fx=535.4, fy=539.2, cx=320.1, cy=247.6,
               width=640, height=480, bf=40.0)
# Bonn RGB-D Dynamic dataset: Asus Xtion Pro Live, rectified 640x480, the
# TUM file layout and depth factor 5000 (the reference's intrinsics).
BONN = Pinhole(fx=542.822841, fy=542.576870, cx=315.593520, cy=237.756098,
               width=640, height=480, bf=40.0)
