"""TUM RGB-D dataset I/O (counterpart of lc_crf_slam_tpu/utils/io_tum.py).

Covers `rgbd_tum.cc::LoadImages`, TUM's `associate.py` timestamp pairing
and `System::SaveTrajectoryTUM`. Trajectory format: `timestamp tx ty tz
qx qy qz qw` per line, poses camera-to-world (Twc). The reference decodes
PNGs with OpenCV; `TUMSequence` decodes them with `utils/png.py` to the
same arrays, and rotations go through the port's `se3`.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..geometry.se3 import quat_to_rotmat, rotmat_to_quat
from . import png


def read_file_list(path: str) -> List[Tuple[float, List[str]]]:
    """Parse a TUM-format file (rgb.txt / depth.txt / groundtruth.txt)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(
    list_a: Sequence[Tuple[float, List[str]]],
    list_b: Sequence[Tuple[float, List[str]]],
    max_difference: float = 0.02,
    offset: float = 0.0,
) -> List[Tuple[float, List[str], float, List[str]]]:
    """Greedy best-first timestamp association (TUM associate.py logic)."""
    pairs = []
    for i, (ta, _) in enumerate(list_a):
        for j, (tb, _) in enumerate(list_b):
            d = abs(ta - (tb + offset))
            if d < max_difference:
                pairs.append((d, i, j))
    pairs.sort()
    used_a, used_b, matches = set(), set(), []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            matches.append((list_a[i][0], list_a[i][1], list_b[j][0], list_b[j][1]))
    matches.sort()
    return matches


def load_association_file(path: str) -> List[Tuple[float, str, float, str]]:
    """Parse an `associate.py` output file: t_rgb rgb t_depth depth."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            out.append((float(p[0]), p[1], float(p[2]), p[3]))
    return out


class TUMSequence:
    """Iterates (timestamp, gray float32 (H, W), depth float32 metres
    (H, W)): the rgbd_tum.cc main loop's image loading, with the
    DepthMapFactor scaling of the 16-bit depth PNGs."""

    def __init__(self, seq_dir: str, assoc_path: str | None = None,
                 depth_map_factor: float = 5000.0):
        self.seq_dir = seq_dir
        self.depth_map_factor = depth_map_factor
        if assoc_path is None:
            rgb = read_file_list(os.path.join(seq_dir, "rgb.txt"))
            depth = read_file_list(os.path.join(seq_dir, "depth.txt"))
            m = associate(rgb, depth)
            self.entries = [(ta, fa[0], tb, fb[0]) for ta, fa, tb, fb in m]
        else:
            self.entries = load_association_file(assoc_path)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int):
        t_rgb, rgb_rel, _, depth_rel = self.entries[idx]
        gray = png.imread_gray(os.path.join(self.seq_dir, rgb_rel)).astype(np.float32)
        depth_raw = png.imread(os.path.join(self.seq_dir, depth_rel))
        depth = depth_raw.astype(np.float32) / self.depth_map_factor
        return t_rgb, gray, depth


def load_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt -> (timestamps (N,), poses (N, 7) tx..qw)."""
    entries = read_file_list(path)
    ts = np.array([t for t, _ in entries])
    poses = np.array([[float(x) for x in vals[:7]] for _, vals in entries])
    return ts, poses


def poses_from_tum(vals: np.ndarray) -> np.ndarray:
    """(N, 7) `tx ty tz qx qy qz qw` rows -> (N, 4, 4) float64 Twc."""
    R = quat_to_rotmat(torch.as_tensor(vals[:, 3:7], dtype=torch.float64)).numpy()
    T = np.tile(np.eye(4), (len(vals), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = vals[:, :3]
    return T


def write_trajectory_tum(path: str, timestamps, poses_twc) -> None:
    """Write a TUM-format trajectory. poses_twc: (N, 4, 4) camera-to-world."""
    poses_twc = np.asarray(poses_twc)
    quats = rotmat_to_quat(
        torch.as_tensor(poses_twc[:, :3, :3], dtype=torch.float32)).numpy()
    with open(path, "w") as fh:
        for t, T, q in zip(timestamps, poses_twc, quats):
            tx, ty, tz = T[:3, 3]
            fh.write(
                f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def read_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory -> (timestamps (N,), Twc (N, 4, 4))."""
    ts, vals = load_groundtruth(path)
    return ts, poses_from_tum(vals)
