"""Localisation mode, the JSONL log, the stage timer, checkpoints and the
keyframe times, against the reference.

The world is tests/test_localization_mode.py's (an orbit over 900 points,
seed 5, no noise) at QVGA over 12 frames instead of 40, so that the orbit
asks for a keyframe every second frame, with its timestamps offset to Unix
seconds (1305031102.175304 s, a TUM sequence's start): frames 0-2 map
(keyframes on 0 and 2), 3-4 run in localisation mode (the keyframe due on
4 is not made), 5-6 map again, with 512 features a frame (the
reference's loop closing and CRF off). Both packages, fed the same frames and
the reference's draws, must keep the map frozen through 5-7 (keyframes and
live points unchanged, no mapping pass), give the same poses to 1 mm and
resume mapping after. On the same run: the JSONL log has one line per
record; the timer names the reference's stages; a checkpoint taken after
the localised frames loads in the other package with every field and dtype
equal, and a port system resumed from it tracks on (and makes the keyframe
due) to the uninterrupted poses to 1e-5; `KeyFrameTrajectory.txt` holds each keyframe's own frame time to
1e-6 s, where the reference's float32 keyframe times collapse (the one
deliberate divergence). The 640x480, 40-frame world is `slow`.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lc_crf_slam_tpu.config import LoopConfig, MapConfig, ORBConfig
from lc_crf_slam_tpu.config import SLAMConfig as RefConfig
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.utils import checkpoint as ref_ckpt
from lc_crf_slam_tpu.utils.evaluate import evaluate_ate as ref_evaluate_ate
from lc_crf_slam_tpu.utils.io_tum import read_trajectory_tum as ref_read_trajectory
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.geometry.se3 import exp_se3
from lc_crf_slam_torch.models.system import SLAMSystem
from lc_crf_slam_torch.utils import checkpoint
from lc_crf_slam_torch.utils.evaluate import evaluate_ate
from lc_crf_slam_torch.utils.io_tum import read_trajectory_tum
from lc_crf_slam_torch.utils.profiling import StageTimer, trace

from torch_parity import CAM, CAM_REF, assert_poses_close, render, use_reference_draws

OFFSET = 1305031102.175304      # a TUM sequence's first Unix timestamp
MAP, LOC, BACK = 3, 2, 2        # frames mapped, localised, mapped again
N = MAP + LOC + BACK
POSE_TOL_M = 1e-3               # the two packages
# at 640x480 float order moves a few inliers (frame 9: 446 against 442)
# and two frames' poses by ~10 mm; both are back within 1 mm on frame 11
SPLIT_TOL_M, SPLIT_TOL_RAD, SPLIT_FRAMES = 0.015, 0.015, 4
RESUME_TOL = 1e-5               # a resumed port run against the uninterrupted one
TIME_TOL_S = 1e-6
CFG = RefConfig(loop=LoopConfig(enabled=False), orb=ORBConfig(max_keypoints=512),
                map=MapConfig(max_points=4096, max_features=512))
CKPT = MAP + LOC                # the checkpoint: before frame 5


def _orbit(cam, n):
    return RefWorld(cam=cam, n_frames=n, n_static=900, n_dynamic=0, seed=5,
                    trajectory="orbit", pixel_noise=0.0, depth_noise=0.0)


def _n_alive(m) -> int:
    return int(np.asarray(m.p_alive).sum())


def _drive(slam, frames, first, n_map, n_loc, on_frame=None, poses=None):
    """Track frames[first:], localisation mode on for frames n_map ..
    n_map + n_loc - 1; returns {frame: (keyframes, live points,
    mapping passes or None)} after each frame. A list `poses` collects
    the poses Tcw that `track_rgbd` returns."""
    seen = {}
    for k in range(first, len(frames)):
        if on_frame is not None:
            on_frame(k)
        slam.set_localization_mode(n_map <= k < n_map + n_loc)
        Tcw = slam.track_rgbd(*frames[k], OFFSET + k / 30.0)
        if poses is not None:
            poses.append(Tcw.cpu().numpy() if isinstance(Tcw, torch.Tensor)
                         else np.asarray(Tcw))
        seen[k] = (int(slam.map.n_kfs), _n_alive(slam.map),
                   getattr(slam, "n_mapping_steps", None))
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("localization")
    frames = [render(_orbit(CAM_REF, 12), k) for k in range(N)]
    ref = RefSystem(CAM_REF, CFG, log_path=str(d / "ref.jsonl"), enable_crf=False)
    port = SLAMSystem(CAM, CFG, log_path=str(d / "port.jsonl"), enable_crf=False,
                      device="cpu")
    use_reference_draws(port)
    out = {"dir": d, "frames": frames, "ref": ref, "port": port}

    def checkpoint_at_map_end(slam, name, save):
        def hook(k):
            if k == CKPT:
                slam.flush_stats()
                save(str(d / f"{name}.npz"), slam.map, slam.ts,
                     trajectory=slam.trajectory, kf_log=slam.kf_log)
                out[f"{name}_at_ckpt"] = (slam.map, slam.ts, list(slam.trajectory),
                                          list(slam.kf_log), getattr(slam, "_n_frames", 0))
        return hook

    out["ref_seen"] = _drive(ref, frames, 0, MAP, LOC,
                             checkpoint_at_map_end(ref, "ref", ref_ckpt.save_checkpoint))
    out["port_seen"] = _drive(port, frames, 0, MAP, LOC,
                              checkpoint_at_map_end(port, "port", checkpoint.save_checkpoint))
    for name in ("ref", "port"):
        out[name].save_keyframe_trajectory_tum(str(d / f"{name}_kf.txt"))
        out[name].shutdown()
    return out


def test_localization_mode_freezes_the_map_as_reference(runs):
    ref_seen, port_seen = runs["ref_seen"], runs["port_seen"]
    assert {k: v[:2] for k, v in ref_seen.items()} == \
        {k: v[:2] for k, v in port_seen.items()}
    before = port_seen[MAP - 1]
    assert before[0] >= 2
    for k in range(MAP, MAP + LOC):
        # keyframes, live points and mapping passes frozen
        assert port_seen[k] == before, (k, port_seen[k], before)
    # mapping resumed: the orbit has moved on, so a keyframe is due
    assert port_seen[N - 1][0] > before[0] and port_seen[N - 1][2] > before[2]
    port, ref = runs["port"], runs["ref"]
    assert all(s.get("status") == 1 for s in port.stats[1:])
    assert [s.get("need_kf") for s in port.stats] == [s.get("need_kf") for s in ref.stats]
    assert not any(s.get("need_kf") for s in port.stats[MAP:MAP + LOC])
    _, pr = ref.get_trajectory()
    _, pp = port.get_trajectory()
    assert_poses_close(pr, pp, POSE_TOL_M, POSE_TOL_M)
    gt_t, gt = _orbit(CAM_REF, 12).groundtruth()
    ts, _ = port.get_trajectory()
    assert evaluate_ate(ts, pp, gt_t[:N] + OFFSET, gt[:N]).rmse < 0.02
    assert not port._localization_only
    port_copy = SLAMSystem(CAM, CFG, device="cpu")
    port_copy.set_localization_mode(True)
    port_copy.reset()
    assert not port_copy._localization_only


def test_jsonl_log_and_timer(runs):
    """One JSONL line per record, as `json.dumps(record)`, with the
    reference's keys and control values (event, keyframe decision, status,
    keyframe count; match counts may part by float order); the timer's
    stages are the reference's, with the same counts."""
    d, ref, port = runs["dir"], runs["ref"], runs["port"]
    lines = (d / "port.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == port.stats
    assert lines == [json.dumps(r) for r in port.stats]
    ref_lines = [json.loads(x) for x in (d / "ref.jsonl").read_text().splitlines()]
    assert len(ref_lines) == len(lines) == N
    for a, b in zip(ref_lines, port.stats):
        assert a.keys() == b.keys()
        control = ("event", "need_kf", "status", "n_kfs")
        assert {k: a[k] for k in control if k in a} == {k: b[k] for k in control if k in b}
    got, want = port.timer.summary(), ref.timer.summary()
    assert got.keys() == want.keys() == {"frontend", "track", "insert_kf", "mapping"}
    assert {k: v["n"] for k, v in got.items()} == {k: v["n"] for k, v in want.items()}
    assert "frontend" in port.timer.report()


def test_stage_timer_and_trace(tmp_path):
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            pass
    assert timer.summary()["a"]["n"] == 3
    with trace(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8)
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert "traceEvents" in text and "aten::" in text


def test_keyframe_times_float64_per_frame(runs):
    """The port's KeyFrameTrajectory.txt holds each keyframe's own frame
    time; the reference's float32 `kf_time` puts them up to 64 s off."""
    d, port = runs["dir"], runs["port"]
    # keyframe 0 is the map's initialisation on frame 0; kf_log holds the
    # frame time of every keyframe inserted after it
    want = np.array([OFFSET] + [t for t, _ in port.kf_log])
    t_port, _ = read_trajectory_tum(str(d / "port_kf.txt"))
    assert len(t_port) == len(want) == int(port.map.n_kfs) >= 3
    np.testing.assert_allclose(t_port, want, atol=TIME_TOL_S, rtol=0)
    assert port.map.kf_time.dtype == torch.float64
    t_ref, _ = ref_read_trajectory(str(d / "ref_kf.txt"))
    np.testing.assert_allclose(t_ref, np.float32(want), atol=TIME_TOL_S, rtol=0)
    assert np.abs(t_ref - want).max() > 1.0
    assert len(set(t_ref)) < len(want)


def _assert_checkpoint_equal(loaded, state, want_dtypes):
    """A loaded state (numpy) against the saved one: every field equal
    (the float64 keyframe times cast to the loader's dtype), each dtype
    the loading package's own."""
    for f, a in loaded.items():
        b = state[f]
        assert a.dtype == want_dtypes[f], (f, a.dtype, want_dtypes[f])
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


def test_port_checkpoint_loads_in_reference(runs):
    m, ts, traj, kf_log, _ = runs["port_at_ckpt"]
    ref_m, ref_ts, meta = ref_ckpt.load_checkpoint(str(runs["dir"] / "port.npz"))
    ref_dtypes = {f: np.asarray(v).dtype for f, v in runs["ref"].map._asdict().items()}
    _assert_checkpoint_equal({f: np.asarray(v) for f, v in ref_m._asdict().items()},
                             convert.to_numpy(m), ref_dtypes)
    ref_ts_dtypes = {f: np.asarray(v).dtype for f, v in runs["ref"].ts._asdict().items()}
    _assert_checkpoint_equal({f: np.asarray(v) for f, v in ref_ts._asdict().items()},
                             convert.to_numpy(ts), ref_ts_dtypes)
    assert meta["kf_log"] == [(t, int(k)) for t, k in kf_log]
    assert [(t, r) for t, _, r in meta["trajectory"]] == [(t, int(r)) for t, _, r in traj]
    for (_, a, _), (_, b, _) in zip(meta["trajectory"], traj):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reference_checkpoint_loads_in_port(runs):
    m, ts, traj, kf_log, _ = runs["ref_at_ckpt"]
    pm, pts, meta = checkpoint.load_checkpoint(str(runs["dir"] / "ref.npz"), device="cpu")
    port_dtypes = {f: v.dtype for f, v in convert.to_numpy(runs["port"].map).items()}
    _assert_checkpoint_equal(convert.to_numpy(pm),
                             {f: np.asarray(v) for f, v in m._asdict().items()}, port_dtypes)
    port_ts_dtypes = {f: v.dtype for f, v in convert.to_numpy(runs["port"].ts).items()}
    _assert_checkpoint_equal(convert.to_numpy(pts),
                             {f: np.asarray(v) for f, v in ts._asdict().items()},
                             port_ts_dtypes)
    assert pm.kf_time.dtype == torch.float64 and pm.p_xyz.device.type == "cpu"
    assert meta["kf_log"] == [(t, int(k)) for t, k in kf_log]
    assert [r for _, _, r in meta["trajectory"]] == [int(r) for _, _, r in traj]


def test_resumed_port_tracks_as_uninterrupted(runs):
    """Resumed from the checkpoint, a new port system runs the rest of the
    schedule to the uninterrupted poses and keyframes."""
    port = runs["port"]
    resumed = SLAMSystem(CAM, CFG, enable_crf=False, device="cpu")
    use_reference_draws(resumed)
    m, ts, meta = checkpoint.load_checkpoint(str(runs["dir"] / "port.npz"), device="cpu")
    resumed.restore(m, ts, meta["trajectory"], meta["kf_log"])
    assert resumed._n_frames == runs["port_at_ckpt"][4] == CKPT
    seen = _drive(resumed, runs["frames"], CKPT, MAP, LOC)
    assert {k: v[:2] for k, v in seen.items()} == \
        {k: runs["port_seen"][k][:2] for k in seen}
    _, want = port.get_trajectory()
    _, got = resumed.get_trajectory()
    assert got.shape == want.shape == (N, 4, 4)
    np.testing.assert_allclose(got, want, atol=RESUME_TOL)
    resumed.flush_stats()
    assert resumed.kf_log == port.kf_log


# ---- get_trajectory's walk through dead reference keyframes ----------
# (the maps of tests/test_trajectory_anchor.py, in both packages)

def _pose(tx, ty=0.0, yaw=0.0):
    return exp_se3(torch.tensor([tx, ty, 0.0, 0.0, yaw, 0.0])).numpy()


def _anchor_scenario(name):
    """(keyframe poses, dead keyframes, anchors, Tca, moved keyframe and
    its new pose, the frame's (t, Tcr, ref))."""
    if name == "one_hop":
        T = [_pose(0.0), _pose(0.1), _pose(0.2)]
        Tcr = _pose(0.12) @ np.linalg.inv(T[1])
        return T, [1], {1: 2}, {1: T[1] @ np.linalg.inv(T[2])}, \
            (2, T[2] @ _pose(0.05, 0.02, 0.01)), (1.5, Tcr, 1)
    T = [_pose(0.1 * i) for i in range(4)]
    Tcr = _pose(0.05) @ np.linalg.inv(T[1])
    return T, [1, 2], {1: 2, 2: 3}, {1: T[1] @ np.linalg.inv(T[2]),
                                     2: T[2] @ np.linalg.inv(T[3])}, \
        (3, T[3] @ _pose(0.0, 0.03, -0.02)), (0.5, Tcr, 1)


def _with_map(slam, scenario, to_array):
    T, dead, anchor, Tca, (moved, T_new), entry = scenario
    m = slam.map
    F = m.capacity_kfs
    kf_Tcw, alive = np.array(m.kf_Tcw), np.zeros(F, bool)
    kf_anchor, kf_Tca = np.array(m.kf_anchor), np.array(m.kf_Tca)
    kf_Tcw[:len(T)] = T
    alive[:len(T)] = True
    alive[dead] = False
    for k, a in anchor.items():
        kf_anchor[k], kf_Tca[k] = a, Tca[k]
    kf_Tcw[moved] = T_new
    slam.map = m._replace(kf_Tcw=to_array(kf_Tcw.astype(np.float32)),
                          kf_alive=to_array(alive), kf_anchor=to_array(kf_anchor),
                          kf_Tca=to_array(kf_Tca.astype(np.float32)),
                          kf_time=to_array(np.arange(F, dtype=np.asarray(m.kf_time).dtype)),
                          n_kfs=to_array(np.array(len(T), np.int32)))
    slam.initialized = True
    slam.trajectory.append(entry)
    return slam


@pytest.mark.parametrize("name", ["one_hop", "multi_hop"])
def test_get_trajectory_walks_dead_reference_keyframes(name, tmp_path):
    scenario = _anchor_scenario(name)
    ref = _with_map(RefSystem(REF_TUM3, RefConfig(), enable_mapping=False, enable_crf=False),
                    scenario, jnp.asarray)
    port = _with_map(SLAMSystem(TUM3, RefConfig(), enable_mapping=False, enable_crf=False,
                                device="cpu"), scenario, torch.from_numpy)
    _, want = ref.get_trajectory()
    _, got = port.get_trajectory()
    np.testing.assert_allclose(got, want, atol=1e-5)
    T, dead, _, Tca, (moved, T_new), (_, Tcr, _) = scenario
    chain = Tcr
    for k in dead:
        chain = chain @ Tca[k]
    np.testing.assert_allclose(got[0], np.linalg.inv(chain @ T_new), atol=1e-5)
    # the keyframe export skips the dead keyframes
    for slam, tag in ((ref, "ref"), (port, "port")):
        slam.save_keyframe_trajectory_tum(str(tmp_path / f"{tag}.txt"))
    lines = (tmp_path / "port.txt").read_text().splitlines()
    assert len(lines) == len(T) - len(dead)
    assert [ln.split()[0] for ln in lines] == \
        [ln.split()[0] for ln in (tmp_path / "ref.txt").read_text().splitlines()]


@pytest.mark.slow
def test_localization_mode_full_size_matches_reference():
    """tests/test_localization_mode.py's world at 640x480 and its schedule
    (frames 0-19 map, 20-33 localise, 34-39 map), default config, in both
    packages: the same keyframes on every frame, each map frozen over
    20-33, no frame lost, mapping resumed, ATE under the reference test's
    bar, and the poses `track_rgbd` returns to 1 mm on all but
    SPLIT_FRAMES frames, which stay within SPLIT_TOL_*: float order moves
    a few inliers and live points from frame 7 on (ROADMAP queue 3, float
    drift), so the exported trajectories are held by their ATE."""
    world = _orbit(REF_TUM3, 40)
    frames = [render(world, k) for k in range(40)]
    ref = RefSystem(REF_TUM3, RefConfig())
    port = SLAMSystem(TUM3, RefConfig(), device="cpu")
    use_reference_draws(port)
    seen, tracked = [], ([], [])
    for slam, Tcw in zip((ref, port), tracked):
        seen.append(_drive(slam, frames, 0, 20, 14, poses=Tcw))
    assert {k: v[0] for k, v in seen[0].items()} == {k: v[0] for k, v in seen[1].items()}
    for k in range(20, 34):
        assert seen[0][k][:2] == seen[0][19][:2] and seen[1][k] == seen[1][19]
    assert seen[1][39][0] >= seen[1][19][0]
    assert all(s.get("status", 1) == 1 for s in port.stats)
    Twc = [np.linalg.inv(np.stack(t).astype(np.float64)) for t in tracked]
    assert_poses_close(*Twc, SPLIT_TOL_M, SPLIT_TOL_RAD)
    split = np.linalg.norm(Twc[0][:, :3, 3] - Twc[1][:, :3, 3], axis=-1) > POSE_TOL_M
    assert split.sum() <= SPLIT_FRAMES and not split[-10:].any(), np.flatnonzero(split)
    gt_t, gt = world.groundtruth()
    ts, pr = ref.get_trajectory()
    assert ref_evaluate_ate(ts, pr, gt_t + OFFSET, gt).rmse < 0.02
    ts, pp = port.get_trajectory()
    assert evaluate_ate(ts, pp, gt_t + OFFSET, gt).rmse < 0.02
