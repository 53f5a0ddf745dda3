"""TUM trajectory output (`timestamp tx ty tz qx qy qz qw`, camera-to-world).

The reference's `utils/io_tum.write_trajectory_tum` converts rotations
with jax; this one uses the port's `rotmat_to_quat`. Reading TUM
sequences is not ported: the port's only data source so far is
`utils/synthetic.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.se3 import rotmat_to_quat


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
