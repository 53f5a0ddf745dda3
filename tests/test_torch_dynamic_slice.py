"""The per-frame dynamic slice end to end: the reference SLAMSystem and
the port's with local mapping and the CRF labeler on (loop closing off),
on the same rendered frames, the port making the reference's random
draws. Per-frame poses must agree to 1 mm and 1 mrad; keyframes and
statuses must be equal, and at QVGA the CRF's per-frame counts too."""

import numpy as np
import pytest

from lc_crf_slam_tpu.config import LoopConfig, SLAMConfig
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.utils.evaluate import evaluate_ate
from lc_crf_slam_tpu.utils.io_tum import read_trajectory_tum
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import CAM, CAM_REF, SLICE_CFG, render, use_reference_draws

POS_TOL_M = 1e-3
ROT_TOL_RAD = 1e-3


def run_both(world, frames, cam_ref=CAM_REF, cam=CAM, cfg=SLICE_CFG):
    """Both systems over `frames` (world frame indices; -1 is a black
    frame without depth)."""
    ref = RefSystem(cam_ref, cfg, enable_mapping=True, enable_crf=True)
    port = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cpu")
    use_reference_draws(port)
    for i, k in enumerate(frames):
        gray, depth = render(world, max(k, 0))
        if k < 0:
            gray, depth = np.zeros_like(gray), np.zeros_like(depth)
        ref.track_rgbd(gray, depth, i / 30.0)
        port.track_rgbd(gray, depth, i / 30.0)
    ref.flush_stats()
    port.flush_stats()
    return ref, port


def compare(ref, port, crf_rel_tol=0.0):
    """Poses to 1 mm / 1 mrad; keyframes, statuses and keyframe decisions
    equal; the CRF's per-frame track and dynamic counts equal, or within
    crf_rel_tol relative."""
    _, pr = ref.get_trajectory()
    _, pp = port.get_trajectory()
    assert pr.shape == pp.shape
    dpos = np.linalg.norm(pr[:, :3, 3] - pp[:, :3, 3], axis=-1)
    # rotation angle of R_ref^T R_port by atan2(sin, cos)
    rel = np.einsum("nji,njk->nik", pr[:, :3, :3], pp[:, :3, :3])
    skew = rel - np.swapaxes(rel, 1, 2)
    sin = 0.5 * np.linalg.norm(
        np.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], -1), axis=-1)
    drot = np.arctan2(sin, (np.trace(rel, axis1=1, axis2=2) - 1) / 2)
    assert dpos.max() <= POS_TOL_M, dpos
    assert drot.max() <= ROT_TOL_RAD, drot
    assert int(ref.map.n_kfs) == int(port.map.n_kfs)
    for key in ("status", "need_kf", "n_kfs"):
        assert [s.get(key) for s in ref.stats] == [s.get(key) for s in port.stats], key
    for key in ("n_dynamic", "crf_tracks"):
        a = np.array([s.get(key, 0) for s in ref.stats])
        b = np.array([s.get(key, 0) for s in port.stats])
        assert np.all(np.abs(a - b) <= crf_rel_tol * a), (key, a, b)
    assert [k for _, k in ref.kf_log] == [k for _, k in port.kf_log]
    # the stages ran where the reference runs them, counted
    assert port.n_mapping_steps == len(port.kf_log)
    assert port.n_crf_steps == len(port.stats) - 1
    return pp


@pytest.fixture(scope="module")
def billboard_run():
    """bench.py's billboard world at QVGA: a rigid textured mover crossing
    a static scene, 8 frames (3 keyframes)."""
    world = RefWorld(cam=CAM_REF, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line", billboard=True, bb_speed=0.04)
    return run_both(world, range(8))


def test_static_world_matches_reference():
    world = RefWorld(cam=CAM_REF, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line")
    ref, port = run_both(world, range(8))
    compare(ref, port)
    assert int(port.map.n_kfs) >= 3


def test_billboard_world_matches_reference(billboard_run):
    ref, port = billboard_run
    compare(ref, port)
    assert int(port.map.n_kfs) >= 3
    assert any(s.get("n_dynamic", 0) > 0 for s in port.stats)
    # the flow gate condemned mover features at a keyframe
    assert (port.map.kf_obs == -2).any()


def test_keyframe_trajectory_export(billboard_run, tmp_path):
    ref, port = billboard_run
    ref.save_keyframe_trajectory_tum(str(tmp_path / "ref.txt"))
    port.save_keyframe_trajectory_tum(str(tmp_path / "port.txt"))
    t_ref, p_ref = read_trajectory_tum(str(tmp_path / "ref.txt"))
    t_out, p_out = read_trajectory_tum(str(tmp_path / "port.txt"))
    np.testing.assert_allclose(t_ref, t_out)
    np.testing.assert_allclose(p_ref, p_out, atol=POS_TOL_M)


@pytest.mark.slow
def test_full_size_billboard_matches_reference(capsys):
    """chip_smoke.py's dynamic phase on the CPU: TUM3 640×480, bench.py's
    billboard world, frames 0-30, default capacities. Prints both ATEs
    (chip_smoke.py quotes the reference's)."""
    cfg = SLAMConfig(loop=LoopConfig(enabled=False))
    world = RefWorld(cam=REF_TUM3, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line", billboard=True, bb_speed=0.04)
    ref, port = run_both(world, range(31), REF_TUM3, TUM3, cfg)
    # CRF counts to 1%: at 640×480 one of ~320 tracks drifts apart by frame
    # 28 (a point's statistics crossing a gate differently in f32); poses,
    # keyframes and statuses stay equal
    pp = compare(ref, port, crf_rel_tol=0.01)
    gt_t, gt = world.groundtruth()
    ts, pr = ref.get_trajectory()
    ate_ref = evaluate_ate(ts, pr, gt_t[:31], gt[:31]).rmse
    ate_port = evaluate_ate(ts, pp, gt_t[:31], gt[:31]).rmse
    with capsys.disabled():
        print(f"\nfull-size billboard, 31 frames: ATE reference {ate_ref!r} m, "
              f"port {ate_port!r} m")
    assert ate_port < 0.02 and abs(ate_port - ate_ref) < 1e-3
