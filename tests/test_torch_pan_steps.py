"""Where the per-frame QVGA pan runs of the port and the JAX reference part,
one frame at a time: the port starts from the reference's own whole state
after frame k - 1 (map, tracker, the loop glue's host state, the previous
frame's image, the reference's next draws) and runs frame k, which the
reference ran from the same state. Chaotic growth cannot hide a difference
there. Each step is held to one frame's float order: the same inliers
within 2 (a descriptor bit that the IC angle's float order flips,
`test_torch_frontend.py::test_pan_world_descriptor_flips_come_from_the_angle`,
can add or drop a match or two), the same keyframe decision, status, live
points and consistency streaks, the same CRF labels on the live points up
to one flip (the known one in ~320 tracks, ROADMAP's standing
divergences), and the pose to 1e-5 (frame 1's bound,
`test_torch_loop_close.py::test_pan_frame1_pose_is_the_reference_op_by_op`)
or, where the reference's own step is less steady, to twice its own
spread: how far its pose moves when its previous pose moves by 1e-7 to
1e-6 m (tests/ref_unfused_worker.py's `pose_spread`; its final pose solve
turns such moves into up to ~1e-4 m on this world).

The reference is the op-by-op one (XLA's backend optimisations off,
tests/ref_unfused_worker.py), which the port follows on frame 1 to 2.5e-7;
the jitted reference rounds otherwise from frame 1 on.

Tier-1: frame 26, where the free-running runs part, from the committed
reference state after frame 25 (tests/data/pan_unfused_state_025.npz, the
worker's `save_state` plus what the reference's frame 26 gave). Slow: every
frame from 20 to 129 from the worker's state, written afresh, and the
committed file checked against it."""

import os
import subprocess
import sys

import numpy as np
import pytest

from lc_crf_slam_tpu.config import SLAMConfig
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import CAM, CAM_REF, PAN_WORLD, load_reference_state, render

N_FRAMES = 130
PARTS_AT = 26          # the first frame whose decisions differ in the free runs
SWEEP_FROM = 20
STATE_FILE = os.path.join(os.path.dirname(__file__), "data",
                          f"pan_unfused_state_{PARTS_AT - 1:03d}.npz")
# what the comparison reads of the reference's state after the step
NEXT_KEYS = ("ts/Tcw", "rec/n_inliers", "rec/need_kf", "rec/status", "rec/pose_spread",
             "map/p_dyn", "map/p_alive", "map/n_kfs", "consistent_masks",
             "consistent_streaks")
POSE_TOL = 1e-5
# the reference's own spread (`rec/pose_spread`) is the largest move of 24
# draws; the port's inputs differ from the reference's by such moves at
# several points of a step (the front end's rounding, the solves' sums),
# so its pose may land a little past it: up to twice
SPREAD_FACTOR = 2.0
INLIER_TOL = 2
LABEL_FLIPS = 1


def pan_frames(n):
    """The pan world's first n frames, rendered in order (its depth noise
    follows the render order)."""
    world = RefWorld(cam=CAM_REF, n_frames=N_FRAMES, **PAN_WORLD)
    return [render(world, k) for k in range(n)]


def step_from_state(frames, z, k, cfg=SLAMConfig()):
    """A port system with config `cfg` loaded with the reference's state
    after frame k - 1 (`z`), after running frame k with the reference's
    draws."""
    port = SLAMSystem(CAM, cfg, enable_mapping=True, enable_crf=True, device="cpu")
    load_reference_state(port, z, frames[k - 1][0])
    port.track_rgbd(*frames[k], k / 30.0)
    port.flush_stats()
    return port


def step_differences(port, nxt) -> dict:
    """The port's step against the reference's (`nxt`: NEXT_KEYS of its
    state after the same frame)."""
    rec = port.stats[-1]
    n = len(nxt["map/p_alive"])
    thr = port.cfg.crf.dynamic_threshold
    live = nxt["map/p_alive"] & port.map.p_alive[:n].numpy()
    labels_ref = nxt["map/p_dyn"] > thr
    labels = port.map.p_dyn[:n].numpy() > thr
    groups = [(np.asarray(g, bool), s) for g, s in port._consistent_groups]
    same_groups = len(groups) == len(nxt["consistent_streaks"]) and all(
        np.array_equal(g, gr) and s == sr for (g, s), gr, sr in zip(
            groups, nxt["consistent_masks"], nxt["consistent_streaks"]))
    return dict(
        pose=float(np.abs(port.ts.Tcw.numpy() - nxt["ts/Tcw"]).max()),
        spread=float(nxt["rec/pose_spread"]),
        inliers=int(rec["n_inliers"]) - int(nxt["rec/n_inliers"]),
        need_kf=bool(rec["need_kf"]) == bool(nxt["rec/need_kf"]),
        status=int(rec["status"]) == int(nxt["rec/status"]),
        n_kfs=int(port.map.n_kfs) == int(nxt["map/n_kfs"]),
        alive=bool(np.array_equal(port.map.p_alive[:n].numpy(), nxt["map/p_alive"])),
        label_flips=int((labels != labels_ref)[live].sum()),
        n_labels=int((labels_ref & live).sum()),
        groups=same_groups)


def within_one_frame(d) -> bool:
    return (d["pose"] <= max(POSE_TOL, SPREAD_FACTOR * d["spread"])
            and abs(d["inliers"]) <= INLIER_TOL
            and d["need_kf"]
            and d["status"] and d["n_kfs"] and d["groups"]
            and d["label_flips"] <= LABEL_FLIPS)


def test_pan_step_where_the_runs_part():
    """Frame 26 from the reference's state after frame 25: within one
    frame's float order (the free-running port and reference part here)."""
    z = np.load(STATE_FILE)
    frames = pan_frames(PARTS_AT + 1)
    port = step_from_state(frames, z, PARTS_AT)
    d = step_differences(port, {k: z[f"next/{k}"] for k in NEXT_KEYS})
    print("frame", PARTS_AT, d)
    assert within_one_frame(d), d


def committed_view(states, k, keys=NEXT_KEYS):
    """A tier-1 file's contents for frame k: the state after k - 1 and
    `keys` of the state after k (under "next/")."""
    z, nxt = (np.load(os.path.join(states, f"state_{i:03d}.npz")) for i in (k - 1, k))
    out = {f: z[f] for f in z.files}
    out.update({f"next/{key}": nxt[key] for key in keys})
    return out


@pytest.mark.slow
def test_pan_steps_from_the_reference_state(tmp_path):
    """Every frame from 20 to 129 from the op-by-op reference's state
    before it (~70 min: the worker's run, then 110 port steps). Prints each
    step's differences; every step within one frame's float order. The
    committed tier-1 state must be the worker's (else the new one is in
    tmp_path)."""
    states = tmp_path / "states"
    states.mkdir()
    env = dict(os.environ, XLA_FLAGS="--xla_backend_optimization_level=0")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__),
                                                 "ref_unfused_worker.py"),
                    str(tmp_path / "reference.npz"), str(N_FRAMES), "--states", str(states),
                    "--first", str(SWEEP_FROM - 1)], env=env, check=True, timeout=3600)
    view = committed_view(str(states), PARTS_AT)
    committed = np.load(STATE_FILE)
    same_file = sorted(committed.files) == sorted(view) and all(
        np.array_equal(committed[f], view[f]) for f in view)
    if not same_file:
        np.savez_compressed(tmp_path / os.path.basename(STATE_FILE), **view)
    frames = pan_frames(N_FRAMES)
    broken = []
    for k in range(SWEEP_FROM, N_FRAMES):
        z = np.load(states / f"state_{k - 1:03d}.npz")
        nxt = np.load(states / f"state_{k:03d}.npz")
        d = step_differences(step_from_state(frames, z, k), nxt)
        print("frame", k, d, flush=True)
        if not within_one_frame(d):
            broken.append((k, d))
    assert same_file, f"{STATE_FILE} is not the worker's state; the new one is in {tmp_path}"
    assert not broken, broken
