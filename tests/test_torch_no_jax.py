"""The port runs without jax: in a fresh interpreter where `import jax`
fails, every module of lc_crf_slam_torch and chip_smoke.py import, a
SLAMSystem with mapping and the CRF on is built on the CPU and tracks
four frames and a black one (keyframes, mapping passes, the flow chain, a
relocalisation attempt), a second one with loop detection on runs the
chunked `track_sequence` (batched front-end and LK, in-chunk keyframes,
detect_loop), and nothing of the JAX package (lc_crf_slam_tpu) was
imported. (A subprocess, because conftest.py has already imported jax
into this one.)"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import dataclasses, importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
import lc_crf_slam_torch
names = [m.name for m in pkgutil.walk_packages(lc_crf_slam_torch.__path__,
                                               "lc_crf_slam_torch.")]
for name in names:
    importlib.import_module(name)
from lc_crf_slam_torch.config import (LoopConfig, MapConfig, ORBConfig, SLAMConfig,
                                      TrackingConfig)
from lc_crf_slam_torch.geometry.camera import Pinhole
from lc_crf_slam_torch.models.system import SLAMSystem
from lc_crf_slam_torch.utils.synthetic import SyntheticWorld
cam = Pinhole(fx=134.0, fy=135.0, cx=80.0, cy=60.0, width=160, height=120, bf=10.0)
cfg = SLAMConfig(loop=LoopConfig(enabled=False),
                 orb=ORBConfig(max_keypoints=256, n_levels=4),
                 map=MapConfig(max_points=4096, max_keyframes=32, max_features=256),
                 tracking=TrackingConfig(max_frames_between_kf=1, min_frames_between_kf=0))
# mapping, the CRF chain and (on the black frame, lost) relocalisation
slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cpu")
world = SyntheticWorld(cam=cam, n_frames=4, n_static=200, n_dynamic=0, seed=1)
for k in range(5):
    f = world.frame(min(k, 3), render=True)
    img, dep = (f.image, f.depth_image) if k < 4 else (0 * f.image, 0 * f.depth_image)
    slam.track_rgbd(img, dep, 0.1 * k)
slam.flush_stats()
assert slam.get_trajectory()[1].shape == (5, 4, 4)
assert slam.n_mapping_steps >= 1 and slam.n_crf_steps == 4, (slam.n_mapping_steps,
                                                              slam.n_crf_steps)
assert slam.stats[-1]["status"] == 2 and int(slam.map.n_kfs) >= 2
# the chunked path with loop detection on: 1 + 4 frames in chunks of 3
import numpy as np
seq = SLAMSystem(cam, dataclasses.replace(cfg, loop=LoopConfig()), enable_mapping=True,
                 enable_crf=True, device="cpu")
fr = [world.frame(k, render=True) for k in (0, 1, 2, 3, 3)]
poses = seq.track_sequence(np.stack([f.image for f in fr]),
                           np.stack([f.depth_image for f in fr]),
                           [0.1 * k for k in range(5)], chunk=3)
assert poses.shape == (4, 4, 4) and seq.get_trajectory()[1].shape == (5, 4, 4)
assert seq.n_crf_steps == 2 and seq.n_detect_loops == seq.n_mapping_steps >= 1, (
    seq.n_crf_steps, seq.n_detect_loops, seq.n_mapping_steps)
import chip_smoke
assert callable(chip_smoke.main)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lc_crf_slam_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK", len(names))
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO], cwd=REPO,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout


def test_chip_smoke_imports_neither_package():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|lc_crf_slam_tpu)\b", src, re.M)
