"""The stereo sensor of the port against the JAX reference: `stereo_match`
on the reference's own QVGA left/right frames, the batched stereo front-end
against the reference's per-eye one, and `track_stereo` end to end on a
few rendered QVGA pairs with the reference's random draws.

Tolerances: `stereo_match` fed identical frames keeps the match mask and
`u_right` exactly, `depth` to 1e-6 relative (bf / disparity, one float32
division). The port's own front-end flips a descriptor bit where a
BRIEF sample difference sits at its threshold (tests/test_torch_frontend.py),
so its stereo depths equal the reference's on >= 99% of the left features.
`track_stereo`: poses to 1 mm / 1 mrad, keyframes and statuses equal.
The same comparisons, with the same tolerances, at the EuRoC stereo rig
cut to half its pixels (tests/euroc_rig.py: 376x240, ORB-SLAM2's EuRoC
settings with 1200 features and a keypoint capacity of 1200, fx and bf
halved) on its static orbit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.models.frame import build_frame as ref_build_frame
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.ops.stereo import stereo_match as ref_stereo_match
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.models.system import SLAMSystem
from lc_crf_slam_torch.ops.stereo import stereo_match

import euroc_rig
from lc_crf_slam_tpu.config import SLAMConfig as RefConfig
from lc_crf_slam_tpu.geometry.camera import Pinhole as RefPinhole
from lc_crf_slam_torch.geometry.camera import Pinhole
from torch_parity import (CAM, CAM_REF, SEQ_CFG, SLICE_CFG, assert_poses_close,
                          render_pair, use_reference_draws)

# the EuRoC rig at half its pixels with a small map; its tracking slice
EUROC = euroc_rig.camera(0.5)
EUROC_REF, EUROC_CAM = RefPinhole(**EUROC), Pinhole(**EUROC)
EUROC_CFG = euroc_rig.slam_config(RefConfig(), **{"map.max_points": 4096})
EUROC_SLICE_CFG = euroc_rig.slam_config(RefConfig(), **{"map.max_points": 4096,
                                                        "loop.enabled": False})


def stereo_world():
    """tests/test_mono_stereo_e2e.py's stereo world at QVGA."""
    return RefWorld(cam=CAM_REF, n_frames=24, n_static=900, n_dynamic=0, seed=11,
                    trajectory="line", pixel_noise=0.0, depth_noise=0.0)


def euroc_world():
    """The EuRoC rig's static orbit (tests/euroc_rig.py) at half its
    pixels, noise-free."""
    w = euroc_rig.WORLD
    return RefWorld(cam=EUROC_REF, n_frames=w["n_frames"], n_static=w["n_static"],
                    n_dynamic=0, seed=w["seed"], trajectory=w["trajectory"],
                    pixel_noise=0.0, depth_noise=0.0)


def reference_pairs(world, cam_ref, cfg, ks):
    """The reference's left and right Frames of world frames `ks`."""
    build = jax.jit(ref_build_frame, static_argnums=(0, 1))
    out = []
    for k in ks:
        gl, gr = render_pair(world, k, cam_ref)
        zero = jnp.zeros_like(jnp.asarray(gl))
        out.append((gl, gr, build(cam_ref, cfg, jnp.asarray(gl), zero),
                    build(cam_ref, cfg, jnp.asarray(gr), zero)))
    return out


@pytest.fixture(scope="module")
def ref_pairs():
    """The reference's left and right Frames of world frames 0 and 6."""
    return reference_pairs(stereo_world(), CAM_REF, SEQ_CFG, (0, 6))


@pytest.fixture(scope="module")
def euroc_pairs():
    """... and of the EuRoC rig's frames 0 and 17."""
    return reference_pairs(euroc_world(), EUROC_REF, EUROC_CFG, (0, 17))


def assert_stereo_match(pair, cam_ref, cam):
    _, _, fl, fr = pair
    ur_ref, d_ref = ref_stereo_match(cam_ref, fl.uv, fl.level, fl.desc, fl.valid,
                                     fr.uv, fr.level, fr.desc, fr.valid)
    pl, pr = convert.frame_to_torch(fl), convert.frame_to_torch(fr)
    ur, d = stereo_match(cam, pl.uv, pl.level, pl.desc, pl.valid,
                         pr.uv, pr.level, pr.desc, pr.valid)
    ur_ref, d_ref = np.asarray(ur_ref), np.asarray(d_ref)
    np.testing.assert_array_equal(ur_ref >= 0, ur.numpy() >= 0)
    np.testing.assert_array_equal(ur_ref, ur.numpy())
    np.testing.assert_allclose(d_ref, d.numpy(), rtol=1e-6, atol=0)
    # most features found their right eye; the median depth is the scene's
    matched = ur_ref >= 0
    assert matched.sum() > 0.5 * np.asarray(fl.valid).sum()
    assert 1.0 < np.median(d_ref[matched]) < 6.0


@pytest.mark.parametrize("which", [0, 1])
def test_stereo_match_matches_reference(ref_pairs, which):
    assert_stereo_match(ref_pairs[which], CAM_REF, CAM)


@pytest.mark.parametrize("which", [0, 1])
def test_stereo_match_matches_reference_at_the_euroc_rig(euroc_pairs, which):
    assert euroc_pairs[which][2].uv.shape[0] == 1200
    assert_stereo_match(euroc_pairs[which], EUROC_REF, EUROC_CAM)


def assert_stereo_frames(pairs, cam_ref, cam, cfg):
    """Both eyes of the pairs in one `build_frames` batch against the
    reference's `_make_stereo_frame` of each pair."""
    ref = RefSystem(cam_ref, cfg)
    port = SLAMSystem(cam, cfg, device="cpu")
    lefts = torch.from_numpy(np.stack([p[0] for p in pairs]))
    rights = torch.from_numpy(np.stack([p[1] for p in pairs]))
    frames = port._stereo_frames(lefts, rights)
    for (gl, gr, _, _), out in zip(pairs, frames):
        exp = ref._make_stereo_frame(gl, gr)
        for f in ("uv", "level", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(exp, f)),
                                          getattr(out, f).numpy(), err_msg=f)
        d_ref, d = np.asarray(exp.depth), out.depth.numpy()
        same = np.isclose(d_ref, d, rtol=1e-6, atol=0)
        assert same.mean() >= 0.99, same.mean()
        assert np.array_equal(np.asarray(exp.u_right)[same] >= 0, out.u_right.numpy()[same] >= 0)


def test_stereo_frames_match_reference(ref_pairs):
    """Two QVGA pairs."""
    assert_stereo_frames(ref_pairs, CAM_REF, CAM, SEQ_CFG)


def test_stereo_frames_match_reference_at_the_euroc_rig(euroc_pairs):
    """Two pairs of the EuRoC rig at half its pixels, each eye at a
    capacity of 1200 keypoints."""
    assert_stereo_frames(euroc_pairs, EUROC_REF, EUROC_CAM, EUROC_CFG)


def assert_track_stereo(world, cam_ref, cam, cfg, fps):
    """8 stereo pairs per frame through both packages' `track_stereo` (the
    tracking slice: mapping, the CRF and loop closing run the RGB-D code
    after the stereo front-end and are held by their own tests), the port
    with its own front-end and the reference's draws."""
    ref = RefSystem(cam_ref, cfg, enable_mapping=False, enable_crf=False)
    port = SLAMSystem(cam, cfg, enable_mapping=False, enable_crf=False, device="cpu")
    use_reference_draws(port)
    for k in range(8):
        gl, gr = render_pair(world, k, cam_ref)
        ref.track_stereo(gl, gr, k / fps)
        port.track_stereo(gl, gr, k / fps)
    assert ref.cfg.sensor == port.cfg.sensor == "stereo"
    _, pr = ref.get_trajectory()
    _, pp = port.get_trajectory()
    ref.flush_stats()
    port.flush_stats()
    assert ref.kf_log == port.kf_log
    assert len(port.kf_log) >= 2
    assert_poses_close(pr, pp)
    assert [s.get("status") for s in ref.stats] == [s.get("status") for s in port.stats]
    assert [s.get("status") for s in port.stats][1:] == [1] * 7
    assert int(ref.map.n_points) == int(port.map.n_points)
    with pytest.raises(RuntimeError, match="sensor mode"):
        port.track_rgbd(*render_pair(world, 6, cam_ref), 6 / fps)


def test_track_stereo_matches_reference():
    assert_track_stereo(stereo_world(), CAM_REF, CAM, SLICE_CFG, 30.0)


def test_track_stereo_matches_reference_at_the_euroc_rig():
    """At the EuRoC rig's settings: 20 pairs a second, ThDepth 35, at
    most 20 frames between keyframes, 1200 keypoints a frame."""
    assert_track_stereo(euroc_world(), EUROC_REF, EUROC_CAM, EUROC_SLICE_CFG, euroc_rig.FPS)


@pytest.mark.slow
def test_track_stereo_full_size(monkeypatch):
    """tests/test_mono_stereo_e2e.py's stereo world at 640×480, 24 pairs,
    default configuration. The port's own front-end passes the reference
    test's checks (no lost frame, ATE < 0.05 m, >= 3 keyframes). Fed the
    reference's stereo frames, it makes the reference's keyframes and
    statuses, and the poses `track_stereo` returns agree to 1 mm / 1 mrad
    through frame 14 (measured 0.25 mm at most, CPU). Later the packages
    part by float order alone: one inlier at frame 9, one CRF label at
    frame 15, one map point at frame 16, then differences of 2 mm (frame
    17) and 20 mm (frames 19-20, poses on ~70-170 inliers with ~60% of the
    points labelled dynamic) that shrink to 2.5 mm by frame 23. The
    exported trajectory rests every frame on its keyframe's final pose,
    which each later local BA moves: it departs by 2.7 mm from frame 4 on,
    so it is held to the reference's ATE bar, as the run of the port's
    own front-end is."""
    from lc_crf_slam_tpu.config import SLAMConfig
    from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
    from lc_crf_slam_tpu.utils.evaluate import evaluate_ate
    from lc_crf_slam_torch.geometry.camera import TUM3

    world = RefWorld(cam=REF_TUM3, n_frames=24, n_static=900, n_dynamic=0, seed=11,
                     trajectory="line", pixel_noise=0.0, depth_noise=0.0)
    pairs = [render_pair(world, k, REF_TUM3) for k in range(24)]
    gt_t, gt = world.groundtruth()
    ref = RefSystem(REF_TUM3, SLAMConfig())
    own = SLAMSystem(TUM3, SLAMConfig(), device="cpu")
    tracked_ref = []
    for k, (gl, gr) in enumerate(pairs):
        tracked_ref.append(np.asarray(ref.track_stereo(gl, gr, k / 30.0)))
        own.track_stereo(gl, gr, k / 30.0)
    for s in (ref, own):
        ts, pe = s.get_trajectory()
        assert evaluate_ate(ts, pe, gt_t, gt).rmse < 0.05
        assert all(e.get("status", 1) == 1 for e in s.stats)
        assert int(s.map.n_kfs) >= 3

    monkeypatch.setattr(SLAMSystem, "_stereo_frames", lambda self, gl, gr: [
        convert.frame_to_torch(ref._make_stereo_frame(a.numpy(), b.numpy()))
        for a, b in zip(gl, gr)])
    port = SLAMSystem(TUM3, SLAMConfig(), device="cpu")
    use_reference_draws(port)
    tracked = [port.track_stereo(gl, gr, k / 30.0).numpy() for k, (gl, gr) in enumerate(pairs)]
    assert_poses_close(np.stack(tracked_ref[:15]), np.stack(tracked[:15]))
    ref.flush_stats()
    port.flush_stats()
    assert ref.kf_log == port.kf_log
    assert [e.get("status") for e in ref.stats] == [e.get("status") for e in port.stats]
    ts, pe = port.get_trajectory()
    assert evaluate_ate(ts, pe, gt_t, gt).rmse < 0.05
