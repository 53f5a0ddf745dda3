"""The port runs without jax: in a fresh interpreter where `import jax`
fails, every module of lc_crf_slam_torch and chip_smoke.py import, a
SLAMSystem with mapping and the CRF on is built on the CPU and tracks
four frames and a black one (keyframes, mapping passes, the flow chain, a
relocalisation attempt), a second one with loop detection on runs the
chunked `track_sequence` (batched front-end and LK, in-chunk keyframes,
detect_loop), a third closes a loop on a hand-built map with a drifted
revisit (verify_loop, correct_loop, the budgeted global BA, the group-wide
fuse) and a fourth closes the same loop over Sim(3) (`fix_scale=False`:
correct_loop_sim3), a stereo system runs `track_stereo` and
`track_sequence_stereo` (ops/stereo.py), a monocular one
`track_monocular` and `track_observations_mono` (models/initializer.py),
the command line (`run_slam.main`) runs a synthetic sequence on the CPU
with its log, map plot and checkpoint, the chunked path runs with its
frames split over a "frames" mesh, a gloo world of one runs the
distributed BA and CRF (lc_crf_slam_torch/parallel/), the block-coordinate
global BA and the "direct" descriptor run, and nothing of the JAX package
(lc_crf_slam_tpu) was imported. (A
subprocess, because conftest.py has already imported jax into this
one.)"""

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
assert "lc_crf_slam_torch.ops.segment_sum" in names, names
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
# a loop closure: keyframe 0 and keyframe 13 see one cloud of 200 points, 12
# keyframes between look elsewhere, keyframe 13 is recorded 0.3 m off
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.geometry.se3 import exp_se3
from lc_crf_slam_torch.models.frame import Frame
from lc_crf_slam_torch.models.mapstate import add_keyframe, add_points, empty_map
lcfg = SLAMConfig(loop=LoopConfig(min_kfs_since_last=5),
                  map=MapConfig(max_points=4096, max_keyframes=32, max_features=256))
gen = torch.Generator().manual_seed(8)
n_pts, K = 200, 256
lo, hi = torch.tensor([-2.0, -1.5, 2.5]), torch.tensor([2.0, 1.5, 6.0])
pts = lo + (hi - lo) * torch.rand((n_pts, 3), generator=gen)
def words():
    return torch.randint(-2**31, 2**31, (n_pts, 8), generator=gen).to(torch.int32)
def observing(pw, desc, Tcw):
    pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
    uv = torch.stack([TUM3.fx * pc[:, 0] / pc[:, 2] + TUM3.cx,
                      TUM3.fy * pc[:, 1] / pc[:, 2] + TUM3.cy], -1)
    pad = lambda a: torch.cat([a, a.new_zeros((K - n_pts,) + a.shape[1:])])
    z = pad(pc[:, 2])
    return Frame(uv=pad(uv), level=torch.zeros(K, dtype=torch.int32), angle=torch.zeros(K),
                 score=torch.ones(K), desc=pad(desc), depth=z,
                 u_right=torch.where(z > 0, pad(uv[:, 0]) - TUM3.bf / z.clamp(min=1e-6), -1.0),
                 valid=torch.arange(K) < n_pts)
desc = words()
m = empty_map(lcfg, "cpu")
m, ids = add_points(m, pts, desc, torch.zeros(n_pts, 3), torch.zeros(n_pts),
                    torch.full((n_pts,), 100.0), torch.ones(n_pts, dtype=torch.bool),
                    torch.tensor(0, dtype=torch.int32))
none = torch.full((K,), -1, dtype=torch.int32)
eye = torch.eye(4)
m, _ = add_keyframe(m, observing(pts, desc, eye), eye, torch.tensor(0.0),
                    torch.cat([ids, none[n_pts:]]))
for i in range(1, 13):
    Ti = exp_se3(torch.tensor([0.2 * i, 0, 0, 0, 0.02 * i, 0]))
    m, _ = add_keyframe(m, observing(pts + torch.tensor([8.0, 0, 0]), words(), Ti), Ti,
                        torch.tensor(float(i)), none)
T_true = exp_se3(torch.tensor([0.05, 0.02, 0.0, 0.0, 0.03, 0.0]))
drift = torch.eye(4)
drift[:3, 3] = torch.tensor([0.25, 0.1, -0.15])
m, kf_loop = add_keyframe(m, observing(pts, desc, T_true), T_true @ drift,
                          torch.tensor(13.0), none)
closer = SLAMSystem(TUM3, lcfg, enable_mapping=False, enable_crf=False, device="cpu")
closer.map, closer.initialized = m, True
closer.ts = closer.ts._replace(ref_kf=kf_loop, Tcw=m.kf_Tcw[13])
cands = np.full((lcfg.loop.retrieval_topk,), -1)
cands[0] = 0
groups = np.zeros((lcfg.loop.retrieval_topk, 32), bool)
groups[0, 0] = True
for _ in range(lcfg.loop.consistency_needed):
    closer._try_close_loop(pre=(13, True, cands, groups))
assert len(closer.loop_log) == 1 and closer.loop_log[0]["cand"] == 0, closer.loop_log
assert closer._gba_pending is not None
err = lambda mm: float(torch.linalg.norm(mm.kf_Tcw[13, :3, 3] - T_true[:3, 3]))
assert err(closer.map) < 0.3 * err(m), (err(m), err(closer.map))
closer.shutdown()
assert closer._gba_pending is None and closer.timer.count("global_ba_slice") == 1
# the same closure over Sim(3)
mcfg = dataclasses.replace(lcfg, loop=LoopConfig(min_kfs_since_last=5, fix_scale=False))
mono_closer = SLAMSystem(TUM3, mcfg, enable_mapping=False, enable_crf=False, device="cpu")
mono_closer.map, mono_closer.initialized = m, True
mono_closer.ts = mono_closer.ts._replace(ref_kf=kf_loop, Tcw=m.kf_Tcw[13])
for _ in range(mcfg.loop.consistency_needed):
    mono_closer._try_close_loop(pre=(13, True, cands, groups))
assert len(mono_closer.loop_log) == 1, mono_closer.loop_log
assert err(mono_closer.map) < 0.3 * err(m), (err(m), err(mono_closer.map))
# stereo, per frame and chunked
pairs = [(world.frame(k, render=True).image, world.right_eye(k)) for k in range(4)]
stereo = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cpu")
for k, (gl, gr) in enumerate(pairs[:2]):
    stereo.track_stereo(gl, gr, 0.1 * k)
poses = stereo.track_sequence_stereo(np.stack([p[0] for p in pairs[2:]]),
                                     np.stack([p[1] for p in pairs[2:]]), [0.2, 0.3],
                                     chunk=2)
assert poses.shape == (2, 4, 4) and stereo.cfg.sensor == "stereo"
assert stereo.stats[-1].get("status", 1) == 1 and int(stereo.map.n_points) > 0
# monocular: images, and observations until the two-view initialisation
mono = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=False, device="cpu")
for k in range(2):
    mono.track_monocular(world.frame(k, render=True).image, 0.1 * k)
assert mono.cfg.sensor == "monocular" and mono.stats[0]["event"] == "mono_wait"
mworld = SyntheticWorld(cam=cam, n_frames=12, n_static=400, n_dynamic=0, seed=2,
                        trajectory="line")
obs = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=False, device="cpu")
for k in range(12):
    f = mworld.frame(k)
    obs.track_observations_mono(f.uv, f.desc, f.timestamp)
events = [s.get("event") for s in obs.stats]
assert "mono_init" in events and obs.initialized, events
# the command line: a synthetic run with every output, in a scratch directory
import json, os, tempfile
from lc_crf_slam_torch import run_slam
with tempfile.TemporaryDirectory() as tmp:
    with open(os.path.join(tmp, "small.yaml"), "w") as fh:
        fh.write("orb.max_keypoints: 512\nmap.max_points: 4096\nmap.max_features: 512\n")
    out = lambda name: os.path.join(tmp, name)
    import contextlib, io
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert run_slam.main(["--synthetic", "--frames", "4", "--device", "cpu",
                              "--config", out("small.yaml"), "--out", out("t.txt"),
                              "--kf-out", out("kf.txt"), "--log", out("run.jsonl"),
                              "--viz", out("map.png"), "--checkpoint", out("ck.npz")]) == 0
    assert json.loads(printed.getvalue().splitlines()[-1])["frames"] == 4
    assert all(os.path.exists(out(n)) for n in ("t.txt", "kf.txt", "map.png", "ck.npz"))
    assert len(open(out("run.jsonl")).read().splitlines()) == 4
# the multi-device layer: a "frames" mesh of two CPU devices under the
# chunked path, and a gloo world of one running the distributed BA and CRF
import socket
from lc_crf_slam_torch.models.loopclosing import _map_ba_problem, global_ba_alternating
from lc_crf_slam_torch.parallel import dist_ba, dist_crf
from lc_crf_slam_torch.parallel.mesh import edge_sharding, init_distributed, make_mesh
sharded = SLAMSystem(cam, dataclasses.replace(cfg, loop=LoopConfig()), enable_mapping=True,
                     enable_crf=True, device="cpu",
                     mesh=make_mesh(devices=["cpu"] * 2, axis="frames"))
sharded.track_sequence(np.stack([f.image for f in fr]), np.stack([f.depth_image for f in fr]),
                       [0.1 * k for k in range(5)], chunk=3)
assert np.array_equal(sharded.get_trajectory()[1], seq.get_trajectory()[1])
assert sharded.kf_log == seq.kf_log
with socket.socket() as sock:
    sock.bind(("localhost", 0))
    free = sock.getsockname()[1]
init_distributed(f"localhost:{free}", num_processes=1, process_id=0, device="cpu")
emesh = make_mesh()
prob = dist_ba.partition_point_blocks(_map_ba_problem(lcfg, closer.map), emesh.size)
cam_d, p_d, st = dist_ba.dist_solve_ba_blocks(TUM3, dist_ba.shard_problem(prob, emesh, True),
                                              emesh, n_iters=2)
assert torch.isfinite(st.cost) and p_d.shape == prob.p_xyz.shape
nbr, w_knn = dist_crf.dist_knn_graph(lcfg, edge_sharding(emesh, pts), torch.ones(n_pts,
                                     dtype=torch.bool), emesh)
assert nbr.shape[0] == n_pts
torch.distributed.destroy_process_group()
assert torch.isfinite(global_ba_alternating(lcfg, TUM3, closer.map, n_rounds=1).p_xyz).all()
# the "direct" descriptor
direct = SLAMSystem(cam, cfg.replace(orb=dataclasses.replace(cfg.orb,
                                                            descriptor_variant="direct")),
                    enable_mapping=False, enable_crf=False, device="cpu")
direct.track_rgbd(world.frame(0, render=True).image, world.frame(0, render=True).depth_image,
                  0.0)
assert int(direct.map.n_kfs) == 1
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
