"""SE(3) Lie ops, pinhole camera, Umeyama alignment (PyTorch)."""

from .align import horn_sim3, umeyama_alignment
from .camera import Pinhole, project_points, unproject_depth
from .se3 import (exp_se3, exp_so3, hat_so3, log_se3, log_so3, make_se3, quat_to_rotmat,
                  rotmat_to_quat, se3_compose, se3_inverse, vee_so3)
from .sim3 import exp_sim3, log_sim3, sim3_apply, sim3_compose, sim3_inverse

__all__ = [
    "hat_so3",
    "vee_so3",
    "exp_so3",
    "log_so3",
    "exp_se3",
    "log_se3",
    "se3_inverse",
    "se3_compose",
    "quat_to_rotmat",
    "rotmat_to_quat",
    "make_se3",
    "exp_sim3",
    "log_sim3",
    "sim3_inverse",
    "sim3_compose",
    "sim3_apply",
    "Pinhole",
    "project_points",
    "unproject_depth",
    "umeyama_alignment",
    "horn_sim3",
]
