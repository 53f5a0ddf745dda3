"""Relocalisation parity: the 6-point DLT, PnP RANSAC and `relocalize`
against the reference, with the reference's own jax.random draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.geometry.se3 import exp_se3 as ref_exp_se3
from lc_crf_slam_tpu.models import loopclosing as ref_lc
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.ops import pnp as ref_pnp
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.models import loopclosing
from lc_crf_slam_torch.ops import pnp

from torch_parity import CAM, CAM_REF, SLICE_CFG, reference_pnp_sampler, render


def _t(a):
    return torch.from_numpy(np.array(a))


def _pnp_problem(n=300, outlier_frac=0.3, seed=0):
    """The reference test's problem: 300 points, 0.5 px noise, 30% gross
    outliers, random pyramid levels."""
    rng = np.random.default_rng(seed)
    pw = rng.uniform(-2, 2, (n, 3))
    pw[:, 2] += 4
    T = np.asarray(ref_exp_se3(jnp.asarray([0.1, -0.2, 0.05, 0.03, -0.1, 0.08])))
    pc = pw @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                   CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1) + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < outlier_frac
    uv[out] += rng.uniform(-80, 80, (out.sum(), 2))
    level = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return (pw.astype(np.float32), uv.astype(np.float32), level, valid), T


def _dlt_gap(pw, xy):
    """Second-smallest over largest singular value of each sample's
    12×12 DLT matrix, in float64: how well f32 can find the null vector."""
    X, x = pw.astype(np.float64), xy.astype(np.float64)
    o, z = np.ones(X.shape[:2]), np.zeros(X.shape[:2])
    ru = np.stack([X[..., 0], X[..., 1], X[..., 2], o, z, z, z, z,
                   -x[..., 0] * X[..., 0], -x[..., 0] * X[..., 1], -x[..., 0] * X[..., 2],
                   -x[..., 0]], -1)
    rv = np.stack([z, z, z, z, X[..., 0], X[..., 1], X[..., 2], o,
                   -x[..., 1] * X[..., 0], -x[..., 1] * X[..., 1], -x[..., 1] * X[..., 2],
                   -x[..., 1]], -1)
    s = np.linalg.svd(np.concatenate([ru, rv], 1), compute_uv=False)
    return s[:, -2] / s[:, 0]


def test_dlt_pose_batched():
    """Noise-free samples of 6 distinct points. The f32 normal matrix
    squares the DLT's conditioning, so only samples whose null vector f32
    can resolve (singular-value gap > 1e-2, float64) are held, to 1e-3.
    For the wrong sign, -P = -λR has no nearest rotation to speak of (its
    singular values tie), and where the cheirality count then ties too,
    each package returns its own rounding (the reference also on samples
    whose count decides, when its rounding of -P wins the count). So the
    port is held to the truth where its count decides, and to the
    reference where the reference gives the truth."""
    (pw, uv, _, _), T = _pnp_problem(n=60, outlier_frac=0.0)
    pc = pw @ T[:3, :3].T + T[:3, 3]
    xy = (pc[:, :2] / pc[:, 2:]).astype(np.float32)
    idx = np.argsort(np.random.default_rng(3).random((96, 60)), axis=1)[:, :6]
    idx = idx[_dlt_gap(pw[idx], xy[idx]) > 1e-2]
    R_ref, t_ref = jax.vmap(ref_pnp._dlt_pose)(jnp.asarray(pw[idx]), jnp.asarray(xy[idx]))
    Xw = _t(pw[idx])
    P = pnp._dlt_projection(Xw, _t(xy[idx]))
    R, t = pnp._pose_from_projection(P, Xw)
    z = [torch.sum(torch.einsum("hsj,hj->hs", Xw, Rk[:, 2]) + tk[:, 2:3] > 0, -1).numpy()
         for Rk, tk in (pnp._rigidify(s * P) for s in (1.0, -1.0))]
    decided = z[0] != z[1]
    assert decided.sum() >= 8
    np.testing.assert_allclose(R.numpy()[decided],
                               np.broadcast_to(T[:3, :3], R.shape)[decided], atol=1e-3)
    R_ref, t_ref = np.asarray(R_ref), np.asarray(t_ref)
    ref_true = decided & (np.abs(R_ref - T[:3, :3]).max((1, 2)) < 1e-3)
    assert ref_true.sum() >= 4
    np.testing.assert_allclose(R_ref[ref_true], R.numpy()[ref_true], atol=1e-3)
    np.testing.assert_allclose(t_ref[ref_true], t.numpy()[ref_true], atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_with_reference_draws(seed):
    """Fed the reference's randint draws, the port picks the same
    hypothesis: inlier mask and count equal, pose to 1e-3 (the winner is
    a 6-point DLT of noisy pixels, solved by f32 eigh: its rounding is
    ~1e-4)."""
    (pw, uv, level, valid), _ = _pnp_problem(seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = ref_pnp.pnp_ransac(CAM_REF, *map(jnp.asarray, (pw, uv, level, valid)), key)
    out = pnp.pnp_ransac(CAM, *map(_t, (pw, uv, level, valid)), reference_pnp_sampler(key))
    np.testing.assert_array_equal(np.asarray(ref.inliers), out.inliers.numpy())
    assert int(ref.n_inliers) == int(out.n_inliers)
    assert bool(ref.ok) == bool(out.ok) is True
    np.testing.assert_allclose(np.asarray(ref.R), out.R.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ref.t), out.t.numpy(), atol=1e-3)


def test_pnp_ransac_batched_and_degenerate():
    """A batch of two problems gives each one's unbatched result; an
    all-invalid problem is rejected."""
    (pw, uv, level, valid), _ = _pnp_problem(seed=2)
    gen = torch.Generator().manual_seed(0)
    draws = pnp.uniform_sampler(gen)(torch.tensor([int(valid.sum()), 0]), 64)
    assert draws.shape == (2, 64, pnp.SAMPLE) and int(draws[1].max()) == 0
    batch = pnp.pnp_ransac(
        CAM, _t(np.stack([pw, pw])), _t(uv), _t(level), _t(np.stack([valid, valid * 0 > 0])),
        lambda n, h: draws, n_hypotheses=64)
    single = pnp.pnp_ransac(CAM, *map(_t, (pw, uv, level, valid)), lambda n, h: draws[0],
                            n_hypotheses=64)
    assert bool(batch.ok[0]) and not bool(batch.ok[1])
    np.testing.assert_array_equal(batch.inliers[0].numpy(), single.inliers.numpy())
    np.testing.assert_allclose(batch.R[0].numpy(), single.R.numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def reference_lost_state():
    """A reference map from the first 6 tracked QVGA frames of a sweep (at
    least 2 keyframes), and the features of the sweep's frame 2 built
    afresh: a frame that retrieval must find among the keyframes."""
    world = RefWorld(cam=CAM_REF, n_frames=96, n_static=1600, n_dynamic=0, seed=5,
                     trajectory="sweep", pixel_noise=0.0, depth_noise=0.0)
    slam = RefSystem(CAM_REF, SLICE_CFG, enable_mapping=False, enable_crf=False)
    for k in (0, 1, 2, 3, 4, 5):
        gray, depth = render(world, k)
        slam.track_rgbd(gray, depth, k / 30.0)
    gray, depth = render(world, 2)
    frame = slam._build_frame(CAM_REF, SLICE_CFG, jnp.asarray(gray), jnp.asarray(depth))
    return slam.map, frame, world


def test_relocalize_from_reference_state(reference_lost_state):
    """Same candidates, matches and draws: acceptance and inlier count
    equal, the pose to 1e-4, and the pose is the frame's true pose."""
    m, frame, world = reference_lost_state
    assert int(m.n_kfs) >= 2
    key = jax.random.PRNGKey(7)
    ref = ref_lc.relocalize(SLICE_CFG, CAM_REF, m, frame, key)
    out = loopclosing.relocalize(SLICE_CFG, CAM, convert.map_to_torch(m),
                                 convert.frame_to_torch(frame),
                                 reference_pnp_sampler(key, batched=True))
    assert bool(ref.accepted) and bool(out.accepted)
    assert int(ref.n_inliers) == int(out.n_inliers)
    np.testing.assert_allclose(np.asarray(ref.Tcw), out.Tcw.numpy(), atol=1e-4)
    T_true = np.linalg.inv(world.gt_pose_twc(2))
    assert np.linalg.norm(out.Tcw.numpy()[:3, 3] - T_true[:3, 3]) < 0.01


@pytest.mark.slow
def test_blackout_world_relocalizes_in_both():
    """After tests/test_tracking_e2e.py's blackout world, per frame through
    track_rgbd with mapping and the CRF on: a 24-frame sweep (10
    keyframes), two black frames (lost; relocalisation attempted and
    rejected), then back to the sweep's start, which only retrieval can
    reach (the reference keyframe shares too little with it). Both
    packages relocalise on the first frame back; poses to 1 mm / 1 mrad
    throughout, statuses and keyframes equal."""
    from test_torch_dynamic_slice import compare, run_both

    world = RefWorld(cam=CAM_REF, n_frames=96, n_static=1600, n_dynamic=0, seed=5,
                     trajectory="sweep", pixel_noise=0.0, depth_noise=0.0)
    frames = list(range(24)) + [-1, -1, 0, 1, 2]
    ref, port = run_both(world, frames)
    compare(ref, port)
    statuses = [s.get("status") for s in port.stats]
    assert statuses[24:26] == [2, 2] and statuses[26:] == [1, 1, 1]
    # tracking alone failed on the first frame back: relocalisation fixed it
    assert port.stats[26]["n_inliers"] < SLICE_CFG.tracking.min_inliers_ok
    T_true = np.linalg.inv(world.gt_pose_twc(2))
    assert np.linalg.norm(port.ts.Tcw.numpy()[:3, 3] - T_true[:3, 3]) < 0.01
