"""Shared fixtures for the port's parity tests (tests/test_torch_*.py):
the small camera and configuration both packages run, rendered frames
(and stereo pairs), the reference's own random draws (consensus audit,
PnP, Horn RANSAC, the two-view initialisation), a hand-built map with a
drifted revisit, the reference's whole system state loaded into a port
system, the port's `track_rgbd` beside the reference run op for op
(tests/ref_unfused_worker.py), and the run-and-compare of both packages'
`track_sequence`."""

from types import SimpleNamespace

import numpy as np
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import LoopConfig, MapConfig, SLAMConfig
from lc_crf_slam_tpu.geometry.camera import Pinhole as RefPinhole
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_torch.geometry.camera import Pinhole
from lc_crf_slam_torch.models.system import CHUNK_PHASES, SLAMSystem

# 6 xdist workers share the machine
torch.set_num_threads(2)

# the QVGA camera of tests/test_tracking_e2e.py
QVGA = dict(fx=268.0, fy=270.0, cx=160.0, cy=120.0, width=320, height=240,
            bf=20.0)
CAM_REF = RefPinhole(**QVGA)
CAM = Pinhole(**QVGA)

# the slice: tracking + keyframe insertion, no loop closing; LOCAL_POINTS
# (4096) is a top-k over all points, so capacity must reach it
SLICE_CFG = SLAMConfig(loop=LoopConfig(enabled=False),
                       map=MapConfig(max_points=4096))
# the chunked path: the default configuration (loop detection on) at the
# same small point capacity
SEQ_CFG = SLAMConfig(map=MapConfig(max_points=4096))
# the reference's default-config loop world (tests/test_loop_throughput_e2e.py:34-43):
# a 1.2-turn pan over a textured wall with 1.5 cm depth noise
PAN_WORLD = dict(n_static=900, n_dynamic=0, seed=5, trajectory="pan", wall=True,
                 pan_leadin=0.1, pan_turns=1.2, pan_translation=0.25,
                 render_depth_noise=0.015)
# the same world at 640x480 is chip_smoke.py's loop phase (its LOOP_WORLD,
# kept there as a copy of its own: the script imports no test)
LOOP_WORLD = PAN_WORLD
# a second pass after the closure: the 130-frame pan world rendered on, at
# the same yaw per frame, to 1.72 turns (chip_smoke.py stops at frame 158)
TWO_LOOP_FRAMES = 180
# the tracking phase's orbit world (chip_smoke.py, bench.py:72-75) without
# its length: the camera stays on one 600-point scene, and past the
# world's n_frames the orbit repeats; with 16 keyframe slots (the least
# the local-BA window takes) the table fills within ~40 frames at 640x480
ORBIT_WORLD = dict(n_static=600, n_dynamic=0, seed=0)
ORBIT_CFG = SLAMConfig(map=MapConfig(max_points=4096, max_keyframes=16))
# the pan world with the smallest point table tracking allows (its top-k
# of LOCAL_POINTS = 4096): the high-water mark reaches the table's end
# near frame 70 and add_points recycles culled slots from then on (the
# mover-revisit world, tests/test_loopclosure_render_e2e.py:32-55, makes
# 2312 slots in its 96 frames at this size, short of the mark)
PAN4096_CFG = SLAMConfig(map=MapConfig(max_points=4096))
# the runs tests/ref_unfused_worker.py makes, by its --world name: (world,
# config, camera: "qvga" or "tum3", 640x480)
UNFUSED_RUNS = {"pan": (PAN_WORLD, SLAMConfig(), "qvga"),
                "pan4096": (PAN_WORLD, PAN4096_CFG, "qvga"),
                "orbit16": (ORBIT_WORLD, ORBIT_CFG, "tum3"),
                "loop640": (LOOP_WORLD, SLAMConfig(), "tum3")}
# the worker's worlds that run through `track_sequence`, by their chunk
CHUNKED_RUNS = {"loop640": 15}


def cameras(name):
    """(reference camera, port camera) by name: "qvga" or "tum3"."""
    if name == "qvga":
        return CAM_REF, CAM
    from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
    from lc_crf_slam_torch.geometry.camera import TUM3
    return REF_TUM3, TUM3


# the keyframe terms of a chunk step, as `keyframe_terms` names them
STEP_TERMS = ("frame_idx", "n_inliers", "n_ref_matches", "need_close", "weak",
              "n_since_kf", "need_kf", "status")


def keyframe_terms(cfg, m, ts, ts2, info) -> dict:
    """The keyframe decision's terms of one `track_step` from `ts` to `ts2`
    (m: the map it returned, info: its TrackInfo), as `track_step`
    computes them under `cfg` (in a chunk, the throttled gap), from numpy
    arrays or torch tensors alike, so that both packages' steps report the
    same quantities; `m`, `ts`, `ts2` and `info` need only the fields read."""
    ref_obs = m.kf_obs[ts.ref_kf]
    ids = ref_obs.clip(min=0)
    ref_min_obs = 2 if int(m.n_kfs) <= 2 else 3
    live = (ref_obs >= 0) & m.kf_valid[ts.ref_kf] & m.p_alive[ids] & (
        m.p_n_obs[ids] >= ref_min_obs)
    n_ref, n_in, tcfg = int(live.sum()), int(info.n_inliers), cfg.tracking
    return dict(
        frame_idx=int(ts.frame_idx), n_inliers=n_in, n_ref_matches=n_ref,
        need_close=(int(info.n_tracked_close) < tcfg.kf_min_close_tracked
                    and int(info.n_untracked_close) > tcfg.kf_max_close_insertable),
        weak=n_in < int(np.float32(tcfg.kf_ref_ratio) * np.float32(n_ref)),
        n_since_kf=int(ts.n_since_kf), need_kf=bool(info.need_kf),
        status=int(ts2.status))


def render(world, k):
    f = world.frame(k, render=True)
    return f.image.astype(np.float32), f.depth_image.astype(np.float32)


def render_pair(world, k, cam):
    """(left, right) images of world frame k: the right eye is the ground
    truth pose shifted by the baseline bf / fx along camera x (as
    tests/test_mono_stereo_e2e.py renders it)."""
    shift = np.eye(4)
    shift[0, 3] = cam.bf / cam.fx
    left = world.frame(k, render=True).image
    right = world.frame(k, render=True, T_wc=world.gt_pose_twc(k) @ shift).image
    return left.astype(np.float32), right.astype(np.float32)


def reference_consensus_sampler(frame_idx: int):
    """A port `Sampler` that makes the reference track_step's own draws
    (tracking.py: fold_in(PRNGKey(17), frame_idx), then pose_consensus's
    split into the hypothesis choice and the audit uniforms)."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), frame_idx)
    k_sample, k_audit = jax.random.split(key)

    def sampler(p: torch.Tensor, n_hyp: int):
        p_j = jnp.asarray(p.detach().cpu().numpy())
        n = p_j.shape[0]
        idx = jax.random.choice(k_sample, n, shape=(n_hyp, 3), p=p_j)
        u = jax.random.uniform(k_audit, (n,))
        return (torch.from_numpy(np.asarray(idx).astype(np.int64)).to(p.device),
                torch.from_numpy(np.array(u)).to(p.device))

    return sampler


def use_reference_draws(port, key=None) -> None:
    """Make a port SLAMSystem draw what the reference SLAMSystem draws:
    the audit's per-frame keys, and the relocalisation and loop
    verification keys split off PRNGKey(7) (or the reference system's
    `_reloc_key` as `key`, uint32 (2,)) one attempt at a time."""
    state = {"key": jax.random.PRNGKey(7) if key is None else jnp.asarray(key, jnp.uint32)}
    port._reference_keys = state        # the next key, for `save_port_state`

    def next_key():
        state["key"], sub = jax.random.split(state["key"])
        return sub

    port._sampler = lambda: reference_consensus_sampler(int(port.ts.frame_idx))
    port._reloc_sampler = lambda: reference_pnp_sampler(next_key(), batched=True)
    port._loop_sampler = lambda: reference_horn_sampler(next_key())
    port._mono_sampler = lambda: reference_mono_sampler(next_key())


def reference_horn_sampler(key):
    """A port `HornSampler` that makes the reference horn_ransac's draws
    (`jax.random.choice(key, N, (n_hyp, 3), p=p_valid)`)."""
    def sampler(p: torch.Tensor, n_hyp: int):
        p_j = jnp.asarray(p.detach().cpu().numpy())
        idx = jax.random.choice(key, p_j.shape[0], shape=(n_hyp, 3), p=p_j)
        return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(p.device)

    return sampler


def reference_mono_sampler(key):
    """A port sampler that makes the reference initialize_mono's draws
    (`jax.random.choice(key, N, (n_hyp, 8), p=p)`)."""
    def sampler(p: torch.Tensor, n_hyp: int):
        p_j = jnp.asarray(p.detach().cpu().numpy())
        idx = jax.random.choice(key, p_j.shape[0], shape=(n_hyp, 8), p=p_j)
        return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(p.device)

    return sampler


def reference_pnp_sampler(key, batched: bool = False):
    """A port `PnPSampler` that makes the reference pnp_ransac's draws
    (`randint(key, (n_hyp, 6), 0, max(n_valid, 1))`); `batched`: one key
    per candidate from `split(key, n)`, as relocalize splits its key."""
    from lc_crf_slam_tpu.ops.pnp import SAMPLE

    def sampler(n_valid: torch.Tensor, n_hyp: int):
        nv = np.atleast_1d(n_valid.cpu().numpy())
        keys = jax.random.split(key, len(nv)) if batched else [key]
        out = np.stack([np.asarray(jax.random.randint(
            k, (n_hyp, SAMPLE), 0, max(int(n), 1))) for k, n in zip(keys, nv)])
        out = out if batched else out[0]
        return torch.from_numpy(out.astype(np.int64)).to(n_valid.device)

    return sampler


FLOAT_TOL = 1e-4       # float map fields after one stage (f32, other sum order)


def assert_map_equal(ref, out, float_tol=FLOAT_TOL, rtol=0.0, skip=()):
    """A reference MapState against a port one: integer, bool and
    descriptor fields exactly; float fields to float_tol (+ rtol relative)."""
    from lc_crf_slam_torch import convert

    got = convert.to_numpy(out)
    for f in ref._fields:
        if f in skip:
            continue
        a = np.asarray(getattr(ref, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, got[f], atol=float_tol, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, got[f], err_msg=f)


# ---- a hand-built map with a drifted revisit ----------------------------

def _observing_frame(rng, pts_w, descs, Tcw, cfg, noise=0.0):
    """World points projected through Tcw into a reference Frame (with
    depth), TUM3 camera."""
    from lc_crf_slam_tpu.geometry.camera import TUM3, project_points
    from lc_crf_slam_tpu.models.frame import frame_from_observations

    pc = pts_w @ np.asarray(Tcw)[:3, :3].T + np.asarray(Tcw)[:3, 3]
    uv, z = project_points(TUM3, jnp.asarray(pc))
    uv = np.asarray(uv) + rng.normal(0, noise, (len(pts_w), 2))
    return frame_from_observations(uv.astype(np.float32), np.asarray(z, np.float32),
                                   descs, cfg.map.max_features, TUM3)


def drifted_loop_map(cfg, n_mid=12, drift_t=(0.25, 0.1, -0.15), seed=8):
    """The reference's loop-closing test map (tests/test_loopclosing.py),
    built with the reference: keyframe 0 observes a cloud of 400 points at
    the true pose, `n_mid` keyframes look elsewhere, and the last keyframe
    re-observes the cloud from a pose recorded with drift. Returns the
    reference (map, loop keyframe index, true pose, drifted pose)."""
    from lc_crf_slam_tpu.geometry.se3 import exp_se3
    from lc_crf_slam_tpu.models.mapstate import add_keyframe, add_points, empty_map

    rng = np.random.default_rng(seed)
    n_pts, K = 400, cfg.map.max_features
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(2.5, 6, n_pts)], -1).astype(np.float32)
    descs = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    m = empty_map(cfg)
    f0 = _observing_frame(rng, pts, descs, np.eye(4), cfg)
    m, ids = add_points(m, jnp.asarray(pts), jnp.asarray(descs[:K]),
                        jnp.zeros((n_pts, 3)), jnp.zeros(n_pts),
                        jnp.full((n_pts,), 100.0), jnp.ones(n_pts, bool),
                        jnp.asarray(0))
    no_obs = jnp.full((K,), -1, jnp.int32)
    m, _ = add_keyframe(m, f0, jnp.eye(4), jnp.asarray(0.0),
                        no_obs.at[jnp.arange(n_pts)].set(ids[:n_pts]))
    for i in range(1, n_mid + 1):
        descs_i = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
        Ti = np.asarray(exp_se3(jnp.asarray(
            [0.3 * i / n_mid * 8, 0, 0, 0, 0.02 * i, 0], jnp.float32)))
        fi = _observing_frame(rng, pts + np.array([8.0, 0, 0], np.float32), descs_i,
                              Ti, cfg)
        m, _ = add_keyframe(m, fi, jnp.asarray(Ti), jnp.asarray(float(i)), no_obs)
    T_true = np.asarray(exp_se3(jnp.asarray([0.05, 0.02, 0.0, 0.0, 0.03, 0.0],
                                            jnp.float32)))
    f_loop = _observing_frame(rng, pts, descs, T_true, cfg)
    dT = np.eye(4, dtype=np.float32)
    dT[:3, 3] = drift_t
    T_drift = (T_true @ dT).astype(np.float32)
    m, kf_loop = add_keyframe(m, f_loop, jnp.asarray(T_drift),
                              jnp.asarray(float(n_mid + 1)), no_obs)
    return m, kf_loop, T_true, T_drift


def with_loop_twins(m, kf_loop, T_true, T_drift):
    """The drifted branch's own copies of the cloud (the loop keyframe's
    observations back-projected through its drifted pose), observed by the
    loop keyframe: what SearchAndFuse has to merge after the correction.
    Returns (map, the number of points in the cloud)."""
    from lc_crf_slam_tpu.models.mapstate import add_points

    n = int(np.asarray(m.p_alive).sum())
    pts, descs = np.asarray(m.p_xyz[:n]), np.asarray(m.p_desc[:n])
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    Twc = np.linalg.inv(T_drift)
    pts_dup = (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
    m, dup_ids = add_points(m, jnp.asarray(pts_dup), jnp.asarray(descs),
                            jnp.zeros((n, 3)), jnp.zeros(n), jnp.full((n,), 100.0),
                            jnp.ones(n, bool), kf_loop)
    return m._replace(kf_obs=m.kf_obs.at[kf_loop, :n].set(dup_ids[:n]),
                      p_n_obs=m.p_n_obs.at[dup_ids].add(1)), n


# ---- the reference's whole system state, into a port system ------------

def gba_slices(port) -> int:
    """The port's global-BA slices so far: its `global_ba_slice` spans."""
    return port.timer.count("global_ba_slice")


def load_reference_state(port, z, gray_prev) -> None:
    """Put the reference system's state after a frame (an npz of
    tests/ref_unfused_worker.py's `save_state`, read with `np.load`) into
    the port system `port`, with `gray_prev` (that frame's image) as the
    previous frame's flow input: the map and tracker, the loop glue's host
    state, and the reference's draws from its next key on."""
    from lc_crf_slam_torch import convert

    dev = port.device
    port.map = convert.map_from_slots(
        port.cfg, {f[4:]: z[f] for f in z.files if f.startswith("map/")}, dev)
    port.ts = convert.track_to_torch(
        SimpleNamespace(**{f[3:]: z[f] for f in z.files if f.startswith("ts/")}), dev)
    port.initialized = True
    port._n_frames = int(port.ts.frame_idx)
    port._last_gray = torch.as_tensor(gray_prev, dtype=torch.float32, device=dev)
    port._last_Tcw = port.ts.Tcw
    port._consistent_groups = [(mask, int(st)) for mask, st in
                               zip(z["consistent_masks"], z["consistent_streaks"])]
    port._last_loop_kf = int(z["last_loop_kf"])
    port._gba_pending = None if int(z["gba_left"]) < 0 else {
        "left": int(z["gba_left"]), "kf": int(z["gba_kf"])}
    # the state's "gba_slices_run" stays unloaded: the port counts its own
    # global-BA slices in its timer (`gba_slices`)
    use_reference_draws(port, z["reloc_key"])


def save_port_state(path, port) -> None:
    """The port system's state in the layout of tests/ref_unfused_worker.py's
    `save_state` (map and tracker in the reference's dtypes, cut to the
    used slots; the loop glue's host state; the next reference key of
    `use_reference_draws`), so that the reference can start from it
    (`load_into_reference`)."""
    from lc_crf_slam_torch import convert

    m = convert.to_numpy(port.map)
    n_kfs, n_pts = int(m["n_kfs"]), int(m["n_points"])
    out = {f"map/{f}": a[:n_kfs] if f.startswith("kf_") else
           a[:n_pts] if f.startswith("p_") else a for f, a in m.items()}
    out["map/kf_time"] = out["map/kf_time"].astype(np.float32)
    out.update({f"ts/{f}": a for f, a in convert.to_numpy(port.ts).items()})
    groups = convert.consistent_groups_to_numpy(port._consistent_groups)
    out["consistent_masks"] = np.array([g for g, _ in groups], bool).reshape(
        len(groups), port.map.capacity_kfs)
    out["consistent_streaks"] = np.array([st for _, st in groups], np.int64)
    out["last_loop_kf"] = np.int64(port._last_loop_kf)
    pending = port._gba_pending or {"left": -1, "kf": -1}
    out["gba_left"], out["gba_kf"] = np.int64(pending["left"]), np.int64(pending["kf"])
    out["gba_slices_run"] = np.int64(gba_slices(port))
    out["reloc_key"] = np.asarray(port._reference_keys["key"])
    np.savez_compressed(path, **out)


def load_into_reference(ref, z, gray_prev) -> None:
    """`load_reference_state`'s counterpart: a state of that layout (the
    worker's `save_state` or `save_port_state`) into the reference system
    `ref`, with `gray_prev` as the previous frame's image."""
    from lc_crf_slam_tpu.models.mapstate import MapState as RefMapState, empty_map
    from lc_crf_slam_tpu.models.tracking import TrackState as RefTrackState

    m = {}
    for f, empty in empty_map(ref.cfg)._asdict().items():
        full = np.array(empty)
        a = z[f"map/{f}"].astype(full.dtype)
        if full.ndim == 0:
            full = a.reshape(())
        else:
            full[:a.shape[0]] = a
        m[f] = jnp.asarray(full)
    ref.map = RefMapState(**m)
    ref.ts = RefTrackState(**{f: jnp.asarray(z[f"ts/{f}"]) for f in RefTrackState._fields})
    ref.initialized = True
    ref._last_gray = jnp.asarray(gray_prev, jnp.float32)
    ref._last_Tcw = ref.ts.Tcw
    ref._consistent_groups = [(mask, int(st)) for mask, st in
                              zip(z["consistent_masks"], z["consistent_streaks"])]
    ref._last_loop_kf = int(z["last_loop_kf"])
    ref._gba_pending = None if int(z["gba_left"]) < 0 else {
        "left": int(z["gba_left"]), "kf": int(z["gba_kf"])}
    ref._gba_slices_run = int(z["gba_slices_run"])
    ref._reloc_key = jnp.asarray(z["reloc_key"], jnp.uint32)


# ---- the port's track_rgbd against the reference run op for op ----------

def run_against_unfused(tmp_path, world_name, n, run=None):
    """The port's `track_rgbd` (the reference's draws) over the first `run`
    (default n) frames of the worker's world `world_name` (n frames long)
    while tests/ref_unfused_worker.py runs the reference op for op over
    the same frames in its own process: (port system, its stats flushed;
    the worker's npz; the world)."""
    import os
    import subprocess
    import sys

    from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld

    out = tmp_path / f"reference_{world_name}.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_backend_optimization_level=0")
    worker = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(__file__), "ref_unfused_worker.py"),
         str(out), str(n), "--world", world_name, "--run", str(run or n)], env=env)
    try:
        world_kw, cfg, cam = UNFUSED_RUNS[world_name]
        cam_ref, cam = cameras(cam)
        world = RefWorld(cam=cam_ref, n_frames=n, **world_kw)
        port = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cpu")
        use_reference_draws(port)
        for k in range(run or n):
            port.track_rgbd(*render(world, k), k / 30.0)
        port.flush_stats()
        assert worker.wait(timeout=3600) == 0
    finally:
        worker.kill()
    return port, np.load(out), world


# ---- track_sequence in both packages ----------------------------------

POS_TOL_M = 1e-3
ROT_TOL_RAD = 1e-3


def rot_angle(Ra, Rb):
    """Rotation angle of Ra^T Rb, (N, 3, 3) each, by atan2(sin, cos)."""
    rel = np.einsum("nji,njk->nik", Ra, Rb)
    skew = rel - np.swapaxes(rel, 1, 2)
    sin = 0.5 * np.linalg.norm(
        np.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], -1), axis=-1)
    return np.arctan2(sin, (np.trace(rel, axis1=1, axis2=2) - 1) / 2)


def assert_poses_close(a, b, pos_tol=POS_TOL_M, rot_tol=ROT_TOL_RAD, frames=None):
    """Poses (N, 4, 4) agree within the tolerances, on all frames or on
    those of the boolean mask `frames`."""
    assert a.shape == b.shape
    frames = np.ones(len(a), bool) if frames is None else frames
    dpos = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1)[frames]
    drot = rot_angle(a[:, :3, :3], b[:, :3, :3])[frames]
    assert dpos.max() <= pos_tol, dpos
    assert drot.max() <= rot_tol, drot


def stack_frames(world, ks):
    """World frame indices -> (grays, depths, timestamps); -1 is a black
    frame without depth."""
    grays, depths = [], []
    for k in ks:
        g, d = render(world, max(k, 0))
        grays.append(g if k >= 0 else np.zeros_like(g))
        depths.append(d if k >= 0 else np.zeros_like(d))
    return np.stack(grays), np.stack(depths), np.arange(len(ks)) / 30.0


def run_sequences(world, ks, chunk, cam_ref=CAM_REF, cam=CAM, cfg=SEQ_CFG,
                  stereo=False):
    """Both packages' `track_sequence` (mapping and CRF on) over the world
    frames `ks`, with `stereo` the rendered pairs in place of the depth:
    (reference system, port system, reference poses, port poses)."""
    grays, depths, ts = stack_frames(world, ks)
    if stereo:
        depths = np.stack([render_pair(world, k, cam_ref)[1] for k in ks])
    ref = RefSystem(cam_ref, cfg, enable_mapping=True, enable_crf=True)
    port = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cpu")
    use_reference_draws(port)
    poses_ref = ref.track_sequence(grays, depths, ts, chunk=chunk, stereo=stereo)
    poses_port = port.track_sequence(grays, depths, ts, chunk=chunk, stereo=stereo)
    return ref, port, np.asarray(poses_ref), poses_port


def compare_sequences(ref, port, poses_ref, poses_port, n_frames, chunk,
                      pos_tol=POS_TOL_M, rot_tol=ROT_TOL_RAD, frames=None):
    """Poses and trajectory to 1 mm / 1 mrad (or the given tolerances, on
    the frames of the mask `frames` (n_frames,)); keyframes, lost-frame
    events and statuses equal; the port's stage counts as the reference's
    cadence."""
    assert poses_port.shape == (n_frames - 1, 4, 4)
    assert_poses_close(poses_ref, poses_port, pos_tol, rot_tol,
                       None if frames is None else frames[1:])
    _, tr = ref.get_trajectory()
    _, tp = port.get_trajectory()
    assert_poses_close(tr, tp, pos_tol, rot_tol, frames)
    ref.flush_stats()
    port.flush_stats()
    # keyframe flags (which frames inserted one) and their indices
    assert ref.kf_log == port.kf_log
    assert int(ref.map.n_kfs) == int(port.map.n_kfs)
    # statuses: the lost frames of every chunk, and relocalisations
    events = lambda s: [(e["event"], e["t"], e.get("lost_frames")) for e in s.stats
                        if e.get("event", "").startswith("chunk_")]
    assert events(ref) == events(port)
    assert int(ref.ts.status) == int(port.ts.status)
    # the stages ran where the reference runs them, counted: the first
    # frame's keyframe initialises the map and runs none of them
    n_chunks = -(-(n_frames - 1) // chunk)
    assert port.n_mapping_steps == len(port.kf_log)
    assert port.n_detect_loops == len(port.kf_log)
    assert port.n_crf_steps == n_chunks
    assert tuple(port.timer.span_totals("chunk.")) == CHUNK_PHASES
    assert {p for name in CHUNK_PHASES for p in port.timer.parents[name]} == {
        "track_sequence"}
    assert ref._consistent_groups == [] and port._consistent_groups == []
