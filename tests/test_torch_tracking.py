"""Tracking parity: match ops, motion-only BA and its audit, map
updates, and one whole track_step continued from the reference's state."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import MapConfig, PoseOptConfig, SLAMConfig
from lc_crf_slam_tpu.geometry.se3 import exp_se3 as ref_exp_se3
from lc_crf_slam_tpu.models import ba as ref_ba
from lc_crf_slam_tpu.models import mapstate as ref_ms
from lc_crf_slam_tpu.models.frame import Frame as RefFrame
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.ops import match as ref_match
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch._ops import u32_to_i32
from lc_crf_slam_torch.models import ba, mapstate
from lc_crf_slam_torch.models.tracking import track_step
from lc_crf_slam_torch.ops import match

from torch_parity import (CAM, CAM_REF, SLICE_CFG, reference_consensus_sampler,
                          render)

RNG = np.random.default_rng(11)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(u32_to_i32(a) if a.dtype == np.uint32 else np.array(a))


def _eq(ref, out, msg=""):
    np.testing.assert_array_equal(np.asarray(ref), out.numpy(), err_msg=msg)


# ---------------------------------------------------------------- matching
def test_hamming_matrix_exact():
    a = RNG.integers(0, 2**32, (37, 8), dtype=np.uint32)
    b = RNG.integers(0, 2**32, (53, 8), dtype=np.uint32)
    b[:5] = a[:5] ^ np.uint32(0x80000001)   # sign bit and low bit
    _eq(ref_match.hamming_matrix(jnp.asarray(a), jnp.asarray(b)),
        match.hamming_matrix(_t(a), _t(b)))


@pytest.mark.parametrize("ratio,mutual", [(1.0, False), (0.9, False), (0.7, True)])
def test_match_nn_and_duplicates_on_ties(ratio, mutual):
    """Integer distances from a narrow range: most rows have tied
    minima, so the tie order (lowest candidate index) decides."""
    dist = RNG.integers(20, 30, (64, 48)).astype(np.int32)
    mask = RNG.random((64, 48)) < 0.6
    ref = ref_match.match_nn(jnp.asarray(dist), jnp.asarray(mask), max_dist=25,
                             ratio=ratio, mutual=mutual)
    out = match.match_nn(_t(dist), _t(mask), max_dist=25, ratio=ratio, mutual=mutual)
    for f in ("idx", "dist", "valid"):
        _eq(getattr(ref, f), getattr(out, f), f)
    _eq(ref_match.resolve_duplicates(ref.idx, ref.dist, ref.valid, 48),
        match.resolve_duplicates(out.idx, out.dist, out.valid, 48))


def test_rotation_consistency_and_gate():
    n = 200
    aq = RNG.uniform(-np.pi, np.pi, n).astype(np.float32)
    ac = (aq - np.where(RNG.random(n) < 0.7, 0.3, RNG.uniform(-3, 3, n))).astype(np.float32)
    valid = RNG.random(n) < 0.8
    _eq(ref_match.rotation_consistency(jnp.asarray(aq), jnp.asarray(ac), jnp.asarray(valid)),
        match.rotation_consistency(_t(aq), _t(ac), _t(valid)))
    uq = RNG.uniform(0, 100, (30, 2)).astype(np.float32)
    up = RNG.uniform(0, 100, (40, 2)).astype(np.float32)
    rad = RNG.uniform(5, 30, 40).astype(np.float32)
    lq, lc = RNG.integers(0, 4, 30).astype(np.int32), RNG.integers(0, 4, 40).astype(np.int32)
    _eq(ref_match.projection_gate(jnp.asarray(uq), jnp.asarray(up), jnp.asarray(rad),
                                  jnp.asarray(lq), jnp.asarray(lc)),
        match.projection_gate(_t(uq), _t(up), _t(rad), _t(lq), _t(lc)))


# ---------------------------------------------------------------- pose BA
def _pose_problem(n=300, outlier_frac=0.15, seed=0):
    rng = np.random.default_rng(seed)
    T = np.asarray(ref_exp_se3(jnp.asarray([0.1, -0.05, 0.2, 0.03, -0.08, 0.02],
                                           jnp.float32)))
    pw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1).astype(np.float32)
    pc = pw @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                   CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < outlier_frac
    uv[bad] += rng.normal(0, 30, (bad.sum(), 2))
    ur = np.where(rng.random(n) < 0.6, uv[:, 0] - CAM.bf / pc[:, 2], -1.0)
    level = rng.integers(0, 4, n).astype(np.int32)
    valid = rng.random(n) < 0.95
    T0 = np.asarray(ref_exp_se3(jnp.asarray([0.02, 0.01, -0.03, 0.01, 0.0, -0.01],
                                            jnp.float32))) @ T
    pc_cam = (pc + rng.normal(0, 0.01, pc.shape))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(T0=f32(T0), pw=pw, uv=f32(uv), ur=f32(ur), level=level,
                valid=valid, pc_cam=f32(pc_cam))


def test_pose_optimize():
    """Pose to 1e-4 (f32 LM over 40 iterations, sums in another order);
    the inlier set exactly."""
    p = _pose_problem()
    args = [p[k] for k in ("T0", "pw", "uv", "ur", "level", "valid")]
    ref = ref_ba.pose_optimize(CAM_REF, *map(jnp.asarray, args), PoseOptConfig())
    out = ba.pose_optimize(CAM, *map(_t, args), PoseOptConfig())
    np.testing.assert_allclose(np.asarray(ref.Tcw), out.Tcw.numpy(), atol=1e-4)
    _eq(ref.inliers, out.inliers)
    assert int(ref.n_inliers) == int(out.n_inliers)


def test_pose_consensus_with_reference_draws():
    """The port takes its draws as inputs: fed the reference's own
    jax.random draws, it picks the same hypothesis."""
    p = _pose_problem(seed=1)
    n = len(p["pw"])
    trust = RNG.uniform(1, 3, n).astype(np.float32)
    valid3d = p["valid"] & (RNG.random(n) < 0.9)
    key = jax.random.PRNGKey(5)
    T_lm = np.asarray(ref_ba.pose_optimize(
        CAM_REF, *map(jnp.asarray, [p[k] for k in ("T0", "pw", "uv", "ur", "level",
                                                     "valid")])).Tcw)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    ref = ref_ba.pose_consensus(
        CAM_REF, jnp.asarray(T_lm), j["pw"], j["pc_cam"], j["uv"], j["level"],
        jnp.asarray(valid3d), j["valid"], key, n_hypotheses=64, tight_chi2=2.0,
        audit_points=128, trust=jnp.asarray(trust))
    k_sample, k_audit = jax.random.split(key)
    prob = ba.consensus_weights(_t(valid3d), _t(trust))
    idx = jax.random.choice(k_sample, n, shape=(64, 3), p=jnp.asarray(prob.numpy()))
    u = jax.random.uniform(k_audit, (n,))
    out = ba.pose_consensus(
        CAM, _t(T_lm), _t(p["pw"]), _t(p["pc_cam"]), _t(p["uv"]), _t(p["level"]),
        _t(p["valid"]), torch.from_numpy(np.asarray(idx).astype(np.int64)), _t(u),
        tight_chi2=2.0, audit_points=128, trust=_t(trust))
    np.testing.assert_allclose(np.asarray(ref[0]), out[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(float(ref[1]), float(out[1]), atol=1e-3)
    np.testing.assert_allclose(float(ref[2]), float(out[2]), atol=1e-3)
    _eq(ref[3], out[3])


# ---------------------------------------------------------------- map state
def _small_frame(K, seed):
    rng = np.random.default_rng(seed)
    valid = rng.random(K) < 0.8
    depth = np.where(rng.random(K) < 0.7, rng.uniform(0.5, 4, K), 0.0).astype(np.float32)
    uv = rng.uniform(0, 300, (K, 2)).astype(np.float32)
    return RefFrame(
        uv=jnp.asarray(uv), level=jnp.asarray(rng.integers(0, 8, K).astype(np.int32)),
        angle=jnp.asarray(rng.uniform(-3, 3, K).astype(np.float32)),
        score=jnp.asarray(rng.uniform(0, 50, K).astype(np.float32)),
        desc=jnp.asarray(rng.integers(0, 2**32, (K, 8), dtype=np.uint32)),
        depth=jnp.asarray(depth),
        u_right=jnp.asarray(np.where(depth > 0, uv[:, 0] - 20 / np.maximum(depth, 1e-3),
                                     -1).astype(np.float32)),
        valid=jnp.asarray(valid))


def _assert_state_equal(ref_state, out_state):
    """Every field exactly, but the keyframe embedding (a normalised mean,
    summed in another order) to 1e-6."""
    out = convert.to_numpy(out_state)
    for f in ref_state._fields:
        if f == "kf_emb":
            np.testing.assert_allclose(np.asarray(ref_state.kf_emb), out[f], atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(getattr(ref_state, f)), out[f],
                                          err_msg=f)


def test_add_points_and_keyframes_array_by_array():
    """Allocation order (virgin slots, then dead), recycling with kf_obs
    condemnation and the tombstone ring, and keyframe insertion up to
    and past capacity. Row writes here have unique targets."""
    cfg = SLAMConfig(map=MapConfig(max_points=48, max_keyframes=3, max_features=24))
    K, rng = 24, np.random.default_rng(2)
    m_ref = ref_ms.empty_map(cfg)
    m = mapstate.empty_map(cfg, "cpu")
    for step in range(5):
        f_ref = _small_frame(K, step)
        f = convert.frame_to_torch(f_ref)
        xyz = rng.normal(0, 1, (K, 3)).astype(np.float32)
        create = rng.random(K) < 0.7
        args = [xyz, np.asarray(f_ref.desc), -xyz, np.full(K, 0.5, np.float32),
                np.full(K, 5.0, np.float32), create]
        m_ref, ids_ref = ref_ms.add_points(m_ref, *map(jnp.asarray, args),
                                           jnp.asarray(step, jnp.int32))
        m, ids = mapstate.add_points(m, *map(_t, args),
                                     torch.tensor(step, dtype=torch.int32))
        _eq(ids_ref, ids, "ids")
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = step
        m_ref, kf_ref = ref_ms.add_keyframe(m_ref, f_ref, jnp.asarray(T),
                                            jnp.asarray(0.1 * step), ids_ref)
        m, kf = mapstate.add_keyframe(m, f, _t(T), torch.tensor(0.1 * step), ids)
        assert int(kf_ref) == int(kf)
        _assert_state_equal(m_ref, m)
        # kill some points, some of them dynamic and observed: the next
        # allocation recycles them (tombstones for the dynamic ones)
        kill = rng.random(48) < 0.3
        dyn = np.where(rng.random(48) < 0.5, 0.9, 0.0).astype(np.float32)
        m_ref = m_ref._replace(p_alive=m_ref.p_alive & ~jnp.asarray(kill),
                               p_dyn=jnp.asarray(dyn))
        m = m._replace(p_alive=m.p_alive & ~_t(kill), p_dyn=_t(dyn))
    q = rng.normal(0, 1, (20, 3)).astype(np.float32)
    _eq(ref_ms.near_dynamic_envelope(m_ref, jnp.asarray(q), 0.5, 0.35),
        mapstate.near_dynamic_envelope(m, _t(q), 0.5, 0.35))


# ---------------------------------------------------------------- track_step
@pytest.fixture(scope="module")
def reference_run():
    """The reference slice for 3 QVGA frames, then the 4th frame's
    features and the reference's own track_step on them."""
    world = RefWorld(cam=CAM_REF, n_frames=6, n_static=500, n_dynamic=0, seed=5)
    slam = RefSystem(CAM_REF, SLICE_CFG, enable_mapping=False, enable_crf=False)
    for k in range(3):
        gray, depth = render(world, k)
        slam.track_rgbd(gray, depth, k / 30.0)
    gray, depth = render(world, 3)
    frame = slam._build_frame(CAM_REF, SLICE_CFG, jnp.asarray(gray), jnp.asarray(depth))
    m0, ts0 = slam.map, slam.ts
    ts1, m1, info = slam._track(SLICE_CFG, CAM_REF, m0, ts0, frame)
    return m0, ts0, frame, ts1, m1, info


def test_track_step_from_reference_state(reference_run):
    m0, ts0, frame, ts1_ref, m1_ref, info_ref = reference_run
    ts1, m1, info = track_step(
        SLICE_CFG, CAM, convert.map_to_torch(m0), convert.track_to_torch(ts0),
        convert.frame_to_torch(frame), reference_consensus_sampler(int(ts0.frame_idx)))
    _eq(info_ref.obs, info.obs, "obs")
    _eq(info_ref.inlier, info.inlier, "inlier")
    for f in ("n_mm_matches", "n_inliers", "n_local_matches", "need_kf", "rescued",
              "ref_fallback", "near_map"):
        _eq(getattr(info_ref, f), getattr(info, f), f)
    np.testing.assert_allclose(np.asarray(ts1_ref.Tcw), ts1.Tcw.numpy(), atol=1e-4)
    for f in ("p_visible", "p_found", "p_last_seen"):
        _eq(getattr(m1_ref, f), getattr(m1, f), f)
    # EMA rows written once per frame (unique point ids) agree to f32 noise
    np.testing.assert_allclose(np.asarray(m1_ref.p_err_ema), m1.p_err_ema.numpy(),
                               atol=1e-3)
    assert int(ts1.status) == int(ts1_ref.status) == 1
