"""The SE(3) pose graph of the port against the JAX reference, on a
drifted chain closed by one loop edge: the same numpy inputs from a seed
through both.

Tolerances (float32): adjoints and the log's inverse Jacobian 1e-5;
residuals 1e-5; the optimised poses 1e-4 in every entry (20 LM x 64 CG
iterations whose sums over edges run in the reference's order on the
CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lc_crf_slam_tpu.geometry import se3 as ref_se3
from lc_crf_slam_tpu.models import posegraph as ref_pg
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.models import posegraph as pg

import torch_parity  # noqa: F401  (thread count)

POSE_TOL = 1e-4


def drifted_chain(F=40, n_valid=30, seed=0):
    """A circle of `n_valid` keyframes (capacity F) whose recorded poses
    accumulate drift; chain edges and a few skip edges carry the drifted
    odometry, one loop edge (weight 5) the true relative pose of the last
    keyframe to the first. Nodes 0 and 1 are the anchors; the edges of the
    unused capacity and one skip edge are invalid."""
    rng = np.random.default_rng(seed)
    steps = [np.asarray(ref_se3.exp_se3(jnp.asarray(
        [0.25, 0.0, 0.02, 0.0, 2 * np.pi / n_valid, 0.0], jnp.float32)))] * n_valid
    true = [np.eye(4, dtype=np.float32)]
    drift = [np.eye(4, dtype=np.float32)]
    for k in range(1, n_valid):
        noise = np.asarray(ref_se3.exp_se3(jnp.asarray(
            rng.normal(0, [4e-3] * 3 + [2e-3] * 3), jnp.float32)))
        true.append(steps[k] @ true[-1])
        drift.append(noise @ steps[k] @ drift[-1])
    pad = [np.eye(4, dtype=np.float32)] * (F - n_valid)
    Tcw = np.stack(drift + pad).astype(np.float32)
    e_i = list(range(1, F)) + [k + 3 for k in range(0, n_valid - 3, 4)] + [n_valid - 1]
    e_j = list(range(0, F - 1)) + [k for k in range(0, n_valid - 3, 4)] + [0]
    e_i, e_j = np.asarray(e_i, np.int32), np.asarray(e_j, np.int32)
    rel = Tcw[e_i] @ np.linalg.inv(Tcw[e_j])
    rel[-1] = true[n_valid - 1] @ np.linalg.inv(true[0])
    e_valid = (e_i < n_valid) & (e_j < n_valid)
    e_valid[F + 1] = False                     # one skip edge switched off
    e_w = np.ones(len(e_i), np.float32)
    e_w[-1] = 5.0
    node_valid = np.arange(F) < n_valid
    node_fixed = (np.arange(F) == 0) | (np.arange(F) == 1)
    g = ref_pg.PoseGraph(*(jnp.asarray(a) for a in (
        Tcw, node_valid, node_fixed, e_i, e_j, rel.astype(np.float32), e_w, e_valid)))
    return g, np.stack(true)


def test_adjoints_and_jacobian_series():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.3, (16, 6)).astype(np.float32)
    T = np.asarray(ref_se3.exp_se3(jnp.asarray(xi)))
    for name, arg in (("_ad_se3", xi), ("_adjoint", T), ("_jl_inv", xi)):
        ref = getattr(ref_pg, name)(jnp.asarray(arg))
        out = getattr(pg, name)(torch.tensor(arg))
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-5, rtol=0)


def test_edge_residuals_match_reference():
    g_ref, _ = drifted_chain()
    g = convert.pose_graph_to_torch(g_ref)
    ref = np.asarray(ref_pg.edge_residuals(g_ref.Tcw, g_ref))
    out = pg.edge_residuals(g.Tcw, g).numpy()
    np.testing.assert_allclose(ref, out, atol=1e-5, rtol=0)
    # odometry edges start consistent; the loop edge carries the drift
    assert np.abs(out[:-1]).max() < 1e-5 and np.abs(out[-1]).max() > 1e-2


@pytest.mark.parametrize("n_iters", [3, 20])
def test_optimize_pose_graph_matches_reference(n_iters):
    g_ref, true = drifted_chain()
    g = convert.pose_graph_to_torch(g_ref)
    ref = np.asarray(ref_pg.optimize_pose_graph(g_ref, n_iters=n_iters))
    out = pg.optimize_pose_graph(g, n_iters=n_iters).numpy()
    np.testing.assert_allclose(ref, out, atol=POSE_TOL, rtol=0)
    valid = np.asarray(g_ref.node_valid)
    Tcw0 = np.asarray(g_ref.Tcw)
    # anchors and invalid nodes stay; the loop closes
    assert np.array_equal(out[:2], Tcw0[:2]) and np.array_equal(out[~valid], Tcw0[~valid])
    n = int(valid.sum())
    err = lambda T: np.linalg.norm(
        (T[n - 1] @ np.linalg.inv(T[0]) @ np.linalg.inv(true[n - 1] @ np.linalg.inv(true[0]))
         )[:3, 3])
    if n_iters == 20:
        assert err(out) < 0.2 * err(Tcw0), (err(Tcw0), err(out))


@pytest.mark.parametrize("graph", ["se3", "sim3"])
def test_pose_graph_sums_run_through_segment_sum(graph, monkeypatch):
    """The gradient, the block diagonal and every CG matvec of both pose
    graphs go through `segment_sum`, all with the one plan of the edges'
    ends built per optimisation; the poses hold to the reference at the
    tolerance of the tests above (and of tests/test_torch_sim3_loop.py)."""
    calls = []
    inner = pg.segment_sum

    def recorder(vals, plan):
        calls.append(plan)
        return inner(vals, plan)

    monkeypatch.setattr(pg, "segment_sum", recorder)
    n_iters, cg_iters = 3, 64
    if graph == "se3":
        g_ref, _ = drifted_chain()
        ref = [np.asarray(ref_pg.optimize_pose_graph(g_ref, n_iters=n_iters))]
        out = [pg.optimize_pose_graph(convert.pose_graph_to_torch(g_ref),
                                      n_iters=n_iters).numpy()]
    else:
        from test_torch_sim3_loop import scale_drift_graph

        g_ref, g = scale_drift_graph()
        ref = [np.asarray(a) for a in ref_pg.optimize_pose_graph_sim3(g_ref, n_iters=n_iters)]
        out = [a.numpy() for a in pg.optimize_pose_graph_sim3(g, n_iters=n_iters)]
    for a, b in zip(ref, out):
        np.testing.assert_allclose(a, b, atol=POSE_TOL, rtol=0)
    assert len(calls) == n_iters * (2 + cg_iters)
    assert calls[0] is not None and all(p is calls[0] for p in calls)
