"""The monocular Sim(3) loop of the port against the JAX reference: the
Sim(3) pose graph (`Sim3Graph`, `sim3_edge_residuals`, the forward-mode
edge Jacobians, `optimize_pose_graph_sim3`) on the scale-drift world of
tests/test_posegraph_ransac.py, and `correct_loop_sim3` plus the
system's mono branch of `_try_close_loop` on `torch_parity.drifted_loop_map`
with its recent branch (the loop keyframe, its points and its twins)
rescaled by 1.25 and stripped of depth, as a monocular branch with scale
drift.

The reference never fires a closure on its own mono loop world
(tests/test_mono_sim3_loop_e2e.py is red), so the closure is handed in:
the reference's `verify_loop` with `fix_scale=False` on this map (the
draws of the system's first verification), whose `s_corr` is 1 / 1.25.

Tolerances (float32): residuals 1e-5, Jacobians 1e-4; the optimised
scales, rotations and translations 1e-4 after 20 × 64 iterations, free
and fixed scale; after `correct_loop_sim3` the integer state exactly,
`kf_Tcw` to 1e-3, `p_xyz` to 1e-3 m, the distance ranges to 1e-3
relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import LoopConfig, MapConfig, SLAMConfig
from lc_crf_slam_tpu.geometry import sim3 as ref_sim3
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.models import loopclosing as ref_lc
from lc_crf_slam_tpu.models import posegraph as ref_pg
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.models import loopclosing as lc
from lc_crf_slam_torch.models import posegraph as pg
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import (assert_map_equal, drifted_loop_map, use_reference_draws,
                          with_loop_twins)

CFG = SLAMConfig(loop=LoopConfig(min_kfs_since_last=5, fix_scale=False),
                 map=MapConfig(max_points=4096, max_keyframes=32, max_features=512))
GAMMA = 1.25
STATE_TOL = 1e-3
POSE_TOL = 1e-4


def scale_drift_graph(n=24, d=1.02, F=32):
    """tests/test_posegraph_ransac.py::TestSim3PoseGraph's world: a GT
    chain whose odometry translation drifts by d per step, chain edges
    from the drifted odometry and one loop edge (weight 5) carrying the
    accumulated scale; node 0 fixed."""
    from test_posegraph_ransac import TestSim3PoseGraph

    gt, est = TestSim3PoseGraph()._drifted_mono_loop(n, d)
    s0 = np.ones(F, np.float32)
    R0 = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
    t0 = np.zeros((F, 3), np.float32)
    R0[:n], t0[:n] = est[:, :3, :3], est[:, :3, 3]
    rel = np.stack([est[i] @ np.linalg.inv(est[i - 1]) for i in range(1, n)])
    D = np.float32(d ** (n - 1))
    R_rel = gt[n - 1][:3, :3] @ gt[0][:3, :3].T
    t_rel = D * gt[n - 1][:3, 3] - D * (R_rel @ gt[0][:3, 3])
    e_i = np.concatenate([np.arange(1, n), [n - 1]]).astype(np.int32)
    e_j = np.concatenate([np.arange(0, n - 1), [0]]).astype(np.int32)
    arrays = (s0, R0, t0, np.arange(F) < n, np.arange(F) == 0, e_i, e_j,
              np.concatenate([np.ones(n - 1), [D]]).astype(np.float32),
              np.concatenate([rel[:, :3, :3], R_rel[None]]).astype(np.float32),
              np.concatenate([rel[:, :3, 3], t_rel[None]]).astype(np.float32),
              np.concatenate([np.ones(n - 1), [5.0]]).astype(np.float32),
              np.ones(n, bool))
    return (ref_pg.Sim3Graph(*(jnp.asarray(a) for a in arrays)),
            convert.sim3_graph_to_torch(ref_pg.Sim3Graph(*arrays)))


def test_sim3_edge_residuals_and_jacobians():
    """Residuals, and the Jacobians against `jax.jacfwd` of the
    reference's residual at zero perturbation, at the drifted start and
    after perturbing every node."""
    g_ref, g = scale_drift_graph()
    rng = np.random.default_rng(2)
    xi = (rng.normal(0, [0.05] * 3 + [0.05] * 3 + [0.1], (g.s.shape[0], 7))
          .astype(np.float32))
    for S_ref in ((g_ref.s, g_ref.R, g_ref.t),
                  ref_sim3.sim3_compose(ref_sim3.exp_sim3(jnp.asarray(xi)),
                                        (g_ref.s, g_ref.R, g_ref.t))):
        S = tuple(torch.from_numpy(np.array(a)) for a in S_ref)
        r_ref = ref_pg.sim3_edge_residuals(S_ref, g_ref)
        np.testing.assert_allclose(np.asarray(r_ref), pg.sim3_edge_residuals(S, g).numpy(),
                                   atol=1e-5)

        def res_edge(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, se, Re, te):
            Si = ref_sim3.sim3_compose(ref_sim3.exp_sim3(xi_i), (si, Ri, ti))
            Sj = ref_sim3.sim3_compose(ref_sim3.exp_sim3(xi_j), (sj, Rj, tj))
            return ref_sim3.log_sim3(ref_sim3.sim3_compose(
                Si, ref_sim3.sim3_compose(ref_sim3.sim3_inverse(Sj),
                                          ref_sim3.sim3_inverse((se, Re, te)))))

        i, j = g_ref.e_i, g_ref.e_j
        args = (S_ref[0][i], S_ref[1][i], S_ref[2][i], S_ref[0][j], S_ref[1][j],
                S_ref[2][j], g_ref.e_s, g_ref.e_R, g_ref.e_t)
        z7 = jnp.zeros((7,), jnp.float32)
        J_ref = [jax.jit(jax.vmap(jax.jacfwd(res_edge, argnums=a),
                                  in_axes=(None, None) + (0,) * 9))(z7, z7, *args)
                 for a in (0, 1)]
        ends = lambda idx: tuple(x[idx.long()] for x in S)
        J = pg._sim3_edge_jacobians(ends(g.e_i), ends(g.e_j), (g.e_s, g.e_R, g.e_t))
        E = g.e_i.shape[0]
        np.testing.assert_allclose(np.asarray(J_ref[0]), J[:E].numpy(), atol=1e-4)
        np.testing.assert_allclose(np.asarray(J_ref[1]), J[E:].numpy(), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_pose_graph_sim3_matches_reference(fix_scale):
    g_ref, g = scale_drift_graph()
    ref = ref_pg.optimize_pose_graph_sim3(g_ref, n_iters=20, fix_scale=fix_scale)
    out = pg.optimize_pose_graph_sim3(g, n_iters=20, fix_scale=fix_scale)
    for name, a, b in zip("sRt", ref, out):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=POSE_TOL, err_msg=name)
    n = int(g.node_valid.sum())
    if fix_scale:
        assert torch.equal(out[0], torch.ones_like(out[0]))
    else:   # the scales absorb the drift profile (the reference test's bar)
        assert out[0][n - 1] > 1.2


def rescaled_loop_map():
    """The drifted-revisit map with the loop keyframe's twins, its branch
    (the loop keyframe's pose and the points it made) scaled by GAMMA
    about the origin and its depth removed: (reference map, loop keyframe
    index, true pose of the loop keyframe)."""
    m, kf, T_true, T_drift = drifted_loop_map(CFG)
    m, _ = with_loop_twins(m, kf, T_true, T_drift)
    kf = int(kf)
    branch = jnp.asarray(np.asarray(m.p_first_kf) == kf)
    m = m._replace(
        p_xyz=jnp.where(branch[:, None], m.p_xyz * GAMMA, m.p_xyz),
        p_min_dist=jnp.where(branch, m.p_min_dist * GAMMA, m.p_min_dist),
        p_max_dist=jnp.where(branch, m.p_max_dist * GAMMA, m.p_max_dist),
        kf_Tcw=m.kf_Tcw.at[kf, :3, 3].multiply(GAMMA),
        kf_depth=m.kf_depth.at[kf].set(0.0), kf_ur=m.kf_ur.at[kf].set(-1.0))
    return m, kf, T_true


@pytest.fixture(scope="module")
def sim3_loop():
    """The map, the reference's verification of (loop keyframe, keyframe
    0) with the system's first verification key, and the reference's
    `correct_loop_sim3` of it."""
    m_ref, kf, T_true = rescaled_loop_map()
    _, key = jax.random.split(jax.random.PRNGKey(7))
    kf_j, c_j = jnp.asarray(kf, jnp.int32), jnp.asarray(0, jnp.int32)
    ver = jax.jit(ref_lc.verify_loop, static_argnums=(0, 1))(CFG, REF_TUM3, m_ref, kf_j,
                                                             c_j, key)
    assert bool(ver.accepted) and abs(float(ver.s_corr) - 1 / GAMMA) < 0.01
    corrected = jax.jit(ref_lc.correct_loop_sim3, static_argnums=(0, 1))(
        CFG, REF_TUM3, m_ref, kf_j, c_j, ver.T_corr, ver.s_corr)
    return dict(m_ref=m_ref, m=convert.map_to_torch(m_ref), kf=kf, T_true=T_true,
                ver=ver, corrected=corrected)


def _assert_corrected(ref, out, m_before, kf, T_true):
    assert_map_equal(ref, out, float_tol=STATE_TOL,
                     skip=("p_min_dist", "p_max_dist"))
    for f in ("p_min_dist", "p_max_dist"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f)), getattr(out, f).numpy(),
                                   rtol=STATE_TOL, err_msg=f)
    # the branch came back to the loop's pose and scale; the anchor stayed
    before = np.linalg.norm(m_before.kf_Tcw[kf, :3, 3].numpy() - T_true[:3, 3])
    after = np.linalg.norm(out.kf_Tcw[kf, :3, 3].numpy() - T_true[:3, 3])
    assert after < 0.3 * before
    assert torch.equal(out.kf_Tcw[0], m_before.kf_Tcw[0])


def test_correct_loop_sim3_matches_reference(sim3_loop):
    s = sim3_loop
    ver = convert.loop_verification_to_torch(s["ver"])
    out = lc.correct_loop_sim3(CFG, TUM3, s["m"], torch.tensor(s["kf"], dtype=torch.int32),
                               torch.tensor(0, dtype=torch.int32), ver.T_corr, ver.s_corr)
    _assert_corrected(s["corrected"], out, s["m"], s["kf"], s["T_true"])


def test_try_close_loop_takes_the_sim3_branch(sim3_loop):
    """`fix_scale=False`: a ready candidate is verified with the
    reference's draws and closed through `correct_loop_sim3`, as the
    reference system does (system.py:1028-1039); the log carries the
    refined scale."""
    s = sim3_loop
    port = SLAMSystem(TUM3, CFG, enable_mapping=False, enable_crf=False, device="cpu")
    use_reference_draws(port)
    port.map, port.initialized = s["m"], True
    port.ts = port.ts._replace(ref_kf=torch.tensor(s["kf"], dtype=torch.int32),
                               Tcw=s["m"].kf_Tcw[s["kf"]])
    topk = CFG.loop.retrieval_topk
    cands = np.full((topk,), -1)
    cands[0] = 0
    groups = np.zeros((topk, CFG.map.max_keyframes), bool)
    groups[0, 0] = True
    for _ in range(CFG.loop.consistency_needed):
        port._try_close_loop(pre=(s["kf"], True, cands, groups))
    assert port.n_verify_loops == 1 and len(port.loop_log) == 1
    log = port.loop_log[0]
    assert (log["kf"], log["cand"], log["inliers"]) == (s["kf"], 0, int(s["ver"].n_inliers))
    assert abs(log["s_corr"] - float(s["ver"].s_corr)) < 1e-4
    _assert_corrected(s["corrected"], port.map, s["m"], s["kf"], s["T_true"])
    assert port._gba_pending is not None
