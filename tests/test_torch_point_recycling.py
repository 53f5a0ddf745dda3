"""Point-slot recycling in a system run, held to the JAX reference one
frame at a time.

The world is the QVGA pan (`torch_parity.PAN_WORLD`, 130 frames) with the
smallest point table tracking allows, 4096 slots (`torch_parity.
PAN4096_CFG`; tracking takes a top-k of LOCAL_POINTS = 4096 over the
table). `add_points` fills never-used slots first; once the high-water
mark `n_points` reaches the table's end it hands culled slots out again,
condemns the keyframe references to them to -2 and sends the ones still
vetoing movers (`p_dyn > 0.5`, observed) to the tombstone ring. The
op-by-op reference (tests/ref_unfused_worker.py --world pan4096) reaches
the mark on frame 83, a keyframe frame whose insert and mapping pass reuse
168 slots, condemn 388 references and tombstone 28 slots; every later
keyframe frame recycles too (frame 90: 37 tombstones, the ring's cursor
at 46).

As in tests/test_torch_pan_steps.py, the port starts from the reference's
own whole state after frame k - 1 and runs frame k, which the reference
ran from the same state. Held exactly: the high-water mark, the live
points, the reused slots (dead before the step, alive after it), the -2
marks of the keyframes' observation table, the tombstone cursor and
slots, the keyframe log and the status; the pose within one frame's float
order (`test_pan_steps.within_one_frame`: 1e-5 or twice the reference's
own spread), the reused slots' positions and the tombstones' positions to
POINT_TOL.

Tier-1: frames 83 and 90 from the committed reference states
(tests/data/pan4096_state_082.npz, _089.npz: the worker's `save_state`
after the frame before, plus NEXT_KEYS of its state after the frame).
Slow: every frame from 83 to 129 from the worker's state, written afresh,
and the committed files checked against it."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lc_crf_slam_torch.models import system

from test_torch_pan_steps import (committed_view, pan_frames, step_differences,
                                  step_from_state, within_one_frame)
from torch_parity import PAN4096_CFG

N_FRAMES = 130         # the pan world's length
MARK_AT = 83           # the first frame whose add_points reuses a slot
STEP_CASES = (MARK_AT, 90)
DATA = os.path.join(os.path.dirname(__file__), "data")
# what the comparison reads of the reference's state after the step
NEXT_KEYS = ("ts/Tcw", "rec/n_inliers", "rec/need_kf", "rec/status", "rec/pose_spread",
             "map/p_dyn", "map/p_alive", "map/n_kfs", "consistent_masks",
             "consistent_streaks", "map/n_points", "map/p_xyz", "map/kf_obs",
             "map/tomb_xyz", "map/tomb_valid", "map/tomb_n")
# a reused slot's new point: made from the step's pose and then moved by
# its mapping pass's local BA, so held as tests/test_torch_mapping.py and
# test_torch_capacity.py hold a mapping pass on equal inputs (1e-3 m +
# 1e-3 relative; frame 83 differs by 1.9e-4 m at most); a tombstone is a
# copy of the state's position (equal inputs): exactly
POINT_TOL, POINT_RTOL = 1e-3, 1e-3


def state_file(k) -> str:
    return os.path.join(DATA, f"pan4096_state_{k - 1:03d}.npz")


def recycling_differences(port, z, nxt, k) -> dict:
    """The port's step from state `z` (after frame k - 1) against the
    reference's (`nxt`, its state after frame k), on what recycling
    touches: {name: (port's, reference's)} of the exact fields, and the
    largest float differences."""
    m = port.map
    n_before = int(z["map/n_points"])
    dead_before = ~z["map/p_alive"][:n_before]
    n_after = int(nxt["map/n_points"])
    kfs_before = int(z["map/n_kfs"])
    p_alive = m.p_alive.numpy()
    reused = np.flatnonzero(dead_before & p_alive[:n_before])
    reused_ref = np.flatnonzero(dead_before & nxt["map/p_alive"][:n_before])
    kf_obs, kf_obs_ref = m.kf_obs.numpy(), nxt["map/kf_obs"]
    kf_log_ref = [(k / 30.0, kfs_before)] if int(nxt["map/n_kfs"]) > kfs_before else []
    exact = {
        "n_points": (int(m.n_points), n_after),
        "p_alive": (p_alive[:n_after].tolist(), nxt["map/p_alive"].tolist()),
        "reused": (reused.tolist(), reused_ref.tolist()),
        "condemned": ((kf_obs[:len(kf_obs_ref)] == -2).tolist(),
                      (kf_obs_ref == -2).tolist()),
        "tomb_n": (int(m.tomb_n), int(nxt["map/tomb_n"])),
        "tomb_valid": (m.tomb_valid.numpy().tolist(), nxt["map/tomb_valid"].tolist()),
        "kf_log": ([(t, int(i)) for t, i in port.kf_log], kf_log_ref),
        "status": (int(port.stats[-1]["status"]), int(nxt["rec/status"])),
    }
    both = reused_ref if np.array_equal(reused, reused_ref) else np.array([], int)
    return dict(
        exact=exact,
        n_reused=len(reused_ref),
        n_condemned=int((kf_obs_ref == -2).sum() - (z["map/kf_obs"] == -2).sum()),
        n_tombstoned=int(nxt["map/tomb_n"]) - int(z["map/tomb_n"]),
        reused_xyz=float(np.abs(m.p_xyz.numpy()[both] - nxt["map/p_xyz"][both]).max(
            initial=0.0)),
        reused_close=bool(np.allclose(m.p_xyz.numpy()[both], nxt["map/p_xyz"][both],
                                      atol=POINT_TOL, rtol=POINT_RTOL)),
        tomb_xyz=float(np.abs(m.tomb_xyz.numpy() - nxt["map/tomb_xyz"]).max()),
    )


def same_recycling(r) -> bool:
    return (all(a == b for a, b in r["exact"].values())
            and r["reused_close"] and r["tomb_xyz"] == 0.0)


def mismatches(r) -> list:
    return [name for name, (a, b) in r["exact"].items() if a != b]


def step_with_reference_pose(frames, z, nxt, k):
    """The port's step from state `z` with the tracker's pose set to the
    reference's own result for frame k just before the keyframe insert
    (recycling happens only there and in the mapping pass after it): what
    the modules after tracking do on the reference's inputs."""
    insert = system.insert_keyframe
    Tcw = torch.as_tensor(nxt["ts/Tcw"])

    def pinned(cfg, cam, m, ts, *args, **kwargs):
        return insert(cfg, cam, m, ts._replace(Tcw=Tcw), *args, **kwargs)

    system.insert_keyframe = pinned
    try:
        return step_from_state(frames, z, k, PAN4096_CFG)
    finally:
        system.insert_keyframe = insert


@pytest.fixture(scope="module")
def frames():
    return pan_frames(max(STEP_CASES) + 1)


@pytest.mark.parametrize("k", STEP_CASES)
def test_recycling_step_from_the_reference_state(frames, k):
    """Frame k from the reference's state after frame k - 1: the same slots
    reused, references condemned and slots tombstoned, and the frame
    within one frame's float order."""
    z = np.load(state_file(k))
    nxt = {key: z[f"next/{key}"] for key in NEXT_KEYS}
    port = step_from_state(frames, z, k, PAN4096_CFG)
    d = step_differences(port, nxt)
    r = recycling_differences(port, z, nxt, k)
    print("frame", k, d, {key: v for key, v in r.items() if key != "exact"},
          "mismatches", mismatches(r))
    # what the case holds: the step recycles, condemns and tombstones
    assert r["n_reused"] > 0 and r["n_condemned"] > 0 and r["n_tombstoned"] > 0
    assert int(z["map/n_points"]) < PAN4096_CFG.map.max_points or k != MARK_AT
    assert not mismatches(r), mismatches(r)
    assert same_recycling(r), r
    assert within_one_frame(d), d


@pytest.mark.slow
def test_recycling_steps_from_the_reference_state(tmp_path):
    """Every frame from the mark (83) to 129 from the op-by-op reference's
    state before it (~35 min: the worker's run, then 47 port steps). Every
    step lies within one frame's float order and recycles as the
    reference's does (the exact fields above: reused slots, condemned
    references, tombstones, live points, keyframe decisions). Where the
    pose lands within the reference's spread but the recycling differs,
    the difference must come from that pose alone: the step again with
    the reference's pose at the insert recycles exactly as the reference
    (frame 87: the port's pose lies 7.9e-5 m from the reference's, whose
    own spread is 8.4e-5 m, and one more point is triangulated; the
    reference moved by 1e-7 m lands on the port's result). The committed
    tier-1 states must be the worker's (else the new ones are in
    tmp_path)."""
    states = tmp_path / "states"
    states.mkdir()
    env = dict(os.environ, XLA_FLAGS="--xla_backend_optimization_level=0")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__),
                                                 "ref_unfused_worker.py"),
                    str(tmp_path / "reference.npz"), str(N_FRAMES), "--world", "pan4096",
                    # from MARK_AT - 2 on, so that the state after MARK_AT - 1
                    # has its pose spread, as the committed one has
                    "--states", str(states), "--first", str(MARK_AT - 2)],
                   env=env, check=True, timeout=7200)
    stale = []
    for k in STEP_CASES:
        view = committed_view(str(states), k, NEXT_KEYS)
        committed = np.load(state_file(k))
        if not (sorted(committed.files) == sorted(view) and all(
                np.array_equal(committed[f], view[f]) for f in view)):
            np.savez_compressed(tmp_path / os.path.basename(state_file(k)), **view)
            stale.append(k)
    frames = pan_frames(N_FRAMES)
    broken, pinned, totals = [], [], np.zeros(3, int)
    for k in range(MARK_AT, N_FRAMES):
        z = np.load(states / f"state_{k - 1:03d}.npz")
        nxt = np.load(states / f"state_{k:03d}.npz")
        port = step_from_state(frames, z, k, PAN4096_CFG)
        d = step_differences(port, nxt)
        r = recycling_differences(port, z, nxt, k)
        totals += (r["n_reused"], r["n_condemned"], r["n_tombstoned"])
        print("frame", k, d, {key: v for key, v in r.items() if key != "exact"},
              "mismatches", mismatches(r), flush=True)
        ok = within_one_frame(d) and same_recycling(r)
        if within_one_frame(d) and not ok:
            rp = recycling_differences(step_with_reference_pose(frames, z, nxt, k),
                                       z, nxt, k)
            print("frame", k, "with the reference's pose: mismatches", mismatches(rp),
                  flush=True)
            pinned.append(k)
            ok = same_recycling(rp)
        if not ok:
            broken.append((k, mismatches(r), d))
    print("reused, condemned, tombstoned over the steps", totals.tolist(),
          "steps held with the reference's pose", pinned)
    assert not stale, f"committed states of frames {stale} are not the worker's; " \
                      f"the new ones are in {tmp_path}"
    assert not broken, broken
    assert (totals > 0).all()
