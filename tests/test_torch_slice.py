"""The slice end to end: the reference SLAMSystem and the port's, in the
slice configuration (tracking + keyframe insertion; no mapping, CRF or
loop closing), on the same rendered frames. Per-frame poses must agree
to 1 mm and 1 mrad, and both must make the same keyframes."""

import numpy as np
import pytest
import torch

from lc_crf_slam_tpu.config import LoopConfig, SLAMConfig
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import config
from lc_crf_slam_torch.geometry.camera import TUM3, Pinhole
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import CAM, CAM_REF, QVGA, SLICE_CFG, render

POS_TOL_M = 1e-3
ROT_TOL_RAD = 1e-3


def _run_both(cam_ref, cam, cfg, world, n):
    ref = RefSystem(cam_ref, cfg, enable_mapping=False, enable_crf=False)
    port = SLAMSystem(cam, cfg, enable_mapping=False, enable_crf=False, device="cpu")
    for k in range(n):
        gray, depth = render(world, k)
        ref.track_rgbd(gray, depth, k / 30.0)
        port.track_rgbd(gray, depth, k / 30.0)
    ref.flush_stats()
    port.flush_stats()
    return ref, port


def _compare(ref, port):
    """The port draws its audit hypotheses from torch, the reference from
    jax.random: the poses agree as long as the audit never replaced a
    solve in either run (a static world gives it no reason to)."""
    assert not any(s.get("rescued") for s in ref.stats + port.stats)
    _, pr = ref.get_trajectory()
    _, pp = port.get_trajectory()
    assert pr.shape == pp.shape
    dpos = np.linalg.norm(pr[:, :3, 3] - pp[:, :3, 3], axis=-1)
    # rotation angle of R_ref^T R_port by atan2(sin, cos): arccos of the
    # trace alone has a ~5e-4 rad floor from float32 rounding near 0
    rel = np.einsum("nji,njk->nik", pr[:, :3, :3], pp[:, :3, :3])
    skew = rel - np.swapaxes(rel, 1, 2)
    sin = 0.5 * np.linalg.norm(
        np.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], -1), axis=-1)
    drot = np.arctan2(sin, (np.trace(rel, axis1=1, axis2=2) - 1) / 2)
    assert dpos.max() <= POS_TOL_M, dpos
    assert drot.max() <= ROT_TOL_RAD, drot
    assert int(ref.map.n_kfs) == int(port.map.n_kfs)
    assert [s.get("status") for s in ref.stats] == [s.get("status") for s in port.stats]


def test_slice_matches_reference_qvga():
    world = RefWorld(cam=CAM_REF, n_frames=6, n_static=500, n_dynamic=0, seed=5)
    ref, port = _run_both(CAM_REF, CAM, SLICE_CFG, world, 6)
    _compare(ref, port)
    assert int(port.map.n_kfs) >= 2


def test_slice_matches_reference_qvga_direct_descriptor():
    """8 frames of `track_rgbd` with the "direct" descriptor in both
    packages, the port making the reference's draws (the audit rescues a
    solve on this world): poses to 1 mm / 1 mrad, the same keyframes,
    statuses and rescues."""
    import dataclasses

    from torch_parity import assert_poses_close, use_reference_draws

    cfg = SLICE_CFG.replace(orb=dataclasses.replace(SLICE_CFG.orb,
                                                    descriptor_variant="direct"))
    world = RefWorld(cam=CAM_REF, n_frames=8, n_static=500, n_dynamic=0, seed=5)
    ref = RefSystem(CAM_REF, cfg, enable_mapping=False, enable_crf=False)
    port = SLAMSystem(CAM, cfg, enable_mapping=False, enable_crf=False, device="cpu")
    use_reference_draws(port)
    for k in range(8):
        gray, depth = render(world, k)
        ref.track_rgbd(gray, depth, k / 30.0)
        port.track_rgbd(gray, depth, k / 30.0)
    ref.flush_stats()
    port.flush_stats()
    assert_poses_close(ref.get_trajectory()[1], port.get_trajectory()[1],
                       POS_TOL_M, ROT_TOL_RAD)
    for key in ("status", "need_kf", "rescued"):
        assert [s.get(key) for s in ref.stats] == [s.get(key) for s in port.stats], key
    assert int(ref.map.n_kfs) == int(port.map.n_kfs) >= 2


@pytest.mark.slow
def test_slice_matches_reference_full_size():
    """The chip_smoke world: TUM3 640x480, 31 frames, default capacities
    (the reference makes 7 keyframes here)."""
    cfg = SLAMConfig(loop=LoopConfig(enabled=False))
    world = RefWorld(cam=REF_TUM3, n_frames=31, n_static=600, n_dynamic=0, seed=0)
    ref, port = _run_both(REF_TUM3, TUM3, cfg, world, 31)
    _compare(ref, port)


def test_trajectory_export(tmp_path):
    world = RefWorld(cam=CAM_REF, n_frames=3, n_static=300, n_dynamic=0, seed=2)
    slam = SLAMSystem(CAM, SLICE_CFG, enable_mapping=False, enable_crf=False,
                      device="cpu")
    for k in range(3):
        gray, depth = render(world, k)
        slam.track_rgbd(gray, depth, k / 30.0)
    path = tmp_path / "traj.txt"
    slam.save_trajectory_tum(str(path))
    from lc_crf_slam_tpu.utils.io_tum import read_trajectory_tum

    ts, poses = read_trajectory_tum(str(path))
    np.testing.assert_allclose(poses, slam.get_trajectory()[1], atol=1e-5)
    slam.reset()
    assert not slam.initialized and int(slam.map.n_points) == 0


def test_cuda_device_required_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem(CAM, SLICE_CFG, enable_mapping=False, enable_crf=False)


@pytest.mark.parametrize("what", ["mapping", "crf", "loop", "direct", "distortion",
                                  "fix_scale"])
def test_unported_options_raise(what):
    """What used to raise by name and is ported now runs: mapping's
    loop-closing fuse (`fuse_duplicates(loop_mode=True)`, here on an empty
    map); a ready loop candidate, which a system with loop closing on
    (with the CRF and mapping on, with both off, and with the monocular
    Sim(3) loop, `loop.fix_scale=False`) verifies and, on an empty map,
    rejects; a camera with distortion terms, whose keypoints the first
    frame's keyframe holds undistorted as the reference's front-end makes
    them; and the "direct" descriptor, whose first keyframe holds the
    reference front-end's keypoints and, but for angles summed in another
    order, its descriptors."""
    if what == "mapping":
        from lc_crf_slam_torch.models.mapping import fuse_duplicates
        from lc_crf_slam_torch.models.mapstate import empty_map

        m = empty_map(SLICE_CFG, "cpu")
        out = fuse_duplicates(SLICE_CFG, CAM, m, torch.tensor(0), loop_mode=True)
        assert all(torch.equal(a, b) for a, b in zip(m, out))
        return
    cfg = config.SLAMConfig(loop=config.LoopConfig(enabled=what in ("loop", "crf")),
                            map=config.MapConfig(max_points=4096, max_keyframes=32))
    cam = CAM
    kw = dict(enable_mapping=what == "crf", enable_crf=what == "crf")
    if what == "direct":
        import dataclasses

        import jax
        from lc_crf_slam_tpu.models.frame import build_frame as ref_build_frame
        from lc_crf_slam_torch._ops import popcount32, u32_to_i32

        orb = dataclasses.replace(SLICE_CFG.orb, descriptor_variant="direct")
        gray, depth = render(RefWorld(cam=CAM_REF, n_frames=6, n_static=500,
                                      n_dynamic=0, seed=5), 2)
        ref = jax.jit(ref_build_frame, static_argnums=(0, 1))(
            CAM_REF, SLICE_CFG.replace(orb=orb), gray, depth)
        slam = SLAMSystem(cam, cfg.replace(orb=orb), device="cpu", **kw)
        slam.track_rgbd(gray, depth, 0.0)
        valid = slam.map.kf_valid[0].numpy()
        np.testing.assert_array_equal(np.asarray(ref.valid), valid)
        np.testing.assert_array_equal(np.asarray(ref.uv), slam.map.kf_uv[0].numpy())
        ham = popcount32(torch.from_numpy(u32_to_i32(np.asarray(ref.desc)))
                         ^ slam.map.kf_desc[0]).sum(-1).numpy()[valid]
        assert np.mean(ham == 0) >= 0.99 and ham.max() <= 2, (np.mean(ham == 0), ham.max())
        return
    if what == "distortion":
        import jax
        from lc_crf_slam_tpu.geometry.camera import Pinhole as RefPinhole
        from lc_crf_slam_tpu.models.frame import build_frame as ref_build_frame

        cam = Pinhole(**QVGA, k1=0.1, p2=0.002)
        gray, depth = render(RefWorld(cam=CAM_REF, n_frames=6, n_static=500,
                                      n_dynamic=0, seed=5), 2)
        ref = jax.jit(ref_build_frame, static_argnums=(0, 1))(
            RefPinhole(**QVGA, k1=0.1, p2=0.002), SLICE_CFG, gray, depth)
        slam = SLAMSystem(cam, cfg, device="cpu", **kw)
        slam.track_rgbd(gray, depth, 0.0)
        np.testing.assert_array_equal(np.asarray(ref.valid), slam.map.kf_valid[0].numpy())
        np.testing.assert_allclose(np.asarray(ref.uv), slam.map.kf_uv[0].numpy(), atol=1e-4)
        np.testing.assert_array_equal(np.asarray(ref.depth), slam.map.kf_depth[0].numpy())
        return
    if what == "fix_scale":
        cfg = cfg.replace(loop=config.LoopConfig(fix_scale=False))
    if what in ("loop", "crf", "fix_scale"):
        slam = SLAMSystem(cam, cfg, device="cpu", **kw)
        assert slam.enable_loop
        topk, F = cfg.loop.retrieval_topk, cfg.map.max_keyframes
        cands = np.full((topk,), -1)
        cands[0] = 2
        groups = np.zeros((topk, F), bool)
        groups[0, 1:4] = True
        for kf in range(20, 20 + cfg.loop.consistency_needed):
            assert slam.n_verify_loops == 0
            slam._try_close_loop(pre=(kf, True, cands, groups))
        assert slam.n_verify_loops == 1 and slam.loop_log == []
        assert slam._gba_pending is None and [s for _, s in slam._consistent_groups] == [3]
