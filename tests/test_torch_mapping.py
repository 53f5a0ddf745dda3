"""Local-mapping parity: the covisibility structures, triangulation, the
Schur-complement BA, and each stage of `mapping_step` continued from a
reference map state, against the JAX package.

The stage tests chain: each stage starts from the reference's output of
the stage before (converted with `convert.map_to_torch`), so a
difference shows in the stage that makes it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lc_crf_slam_tpu.models import mapping as ref_mapping
from lc_crf_slam_tpu.models import mapstate as ref_ms
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.ops import schur as ref_schur
from lc_crf_slam_tpu.ops import triangulate as ref_tri
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch._ops import scatter_add, scatter_max, scatter_min
from lc_crf_slam_torch.models import mapping, mapstate
from lc_crf_slam_torch.ops import schur, triangulate

from test_schur_ba import make_problem
from torch_parity import CAM, CAM_REF, SLICE_CFG, assert_map_equal, render

RNG = np.random.default_rng(21)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("op", ["min", "add", "max"])
def test_drop_scatters_match_reference(op):
    """`scatter_min` / `scatter_add` / `scatter_max` against
    `.at[].min/add/max(mode="drop")`, exactly, with repeated and
    out-of-range indices."""
    arr = RNG.integers(0, 100, 50).astype(np.int32)
    idx = RNG.integers(-5, 60, 200).astype(np.int32)
    idx[idx < 0] = 77          # the reference never passes a negative index
    val = RNG.integers(-50, 150, 200).astype(np.int32)
    at = jnp.asarray(arr).at[jnp.asarray(idx)]
    ref = getattr(at, op)(jnp.asarray(val), mode="drop")
    out = {"min": scatter_min, "add": scatter_add, "max": scatter_max}[op](
        _t(arr), _t(idx), _t(val))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_inv3x3():
    M = RNG.normal(0, 1, (64, 3, 3)).astype(np.float32)
    M = M @ np.swapaxes(M, 1, 2) + np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(ref_schur.inv3x3(jnp.asarray(M))),
                               schur.inv3x3(_t(M)).numpy(), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- triangulation
def _two_views():
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    a = 0.08
    T2[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T2[:3, 3] = [-0.3, 0.02, 0.05]
    pw = np.stack([RNG.uniform(-2, 2, 200), RNG.uniform(-1.5, 1.5, 200),
                   RNG.uniform(2, 8, 200)], -1).astype(np.float32)

    def proj(T):
        pc = pw @ T[:3, :3].T + T[:3, 3]
        return np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                         CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1).astype(np.float32)

    uv1 = proj(T1) + RNG.normal(0, 0.5, (200, 2)).astype(np.float32)
    uv2 = proj(T2) + RNG.normal(0, 0.5, (200, 2)).astype(np.float32)
    uv2[:20] += 25.0                       # gross mismatches fail the checks
    return T1, T2, uv1, uv2


def test_triangulate_pairs_and_epipolar_gate():
    """Accept mask and epipolar gate exactly, points to 1e-4 (relative to
    their ~5 m depth: 2e-5)."""
    T1, T2, uv1, uv2 = _two_views()
    valid = RNG.random(200) < 0.9
    lvl = RNG.integers(0, 4, 200).astype(np.int32)
    args = (T1, T2, uv1, uv2, valid, lvl)
    ref = ref_tri.triangulate_pairs(CAM_REF, *map(jnp.asarray, args), 1.2)
    out = triangulate.triangulate_pairs(CAM, *map(_t, args), 1.2)
    np.testing.assert_array_equal(np.asarray(ref.ok), out.ok.numpy())
    ok = np.asarray(ref.ok)
    assert ok.sum() > 100
    np.testing.assert_allclose(np.asarray(ref.xyz)[ok], out.xyz.numpy()[ok], atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.parallax), out.parallax.numpy(), atol=1e-6)
    ref_g = np.asarray(ref_tri.epipolar_gate(CAM_REF, *map(jnp.asarray, (T1, T2, uv1, uv2))))
    out_g = triangulate.epipolar_gate(CAM, *map(_t, (T1, T2, uv1, uv2))).numpy()
    np.testing.assert_array_equal(ref_g, out_g)
    assert 0 < ref_g.sum() < ref_g.size


# -------------------------------------------------------------------- BA
@pytest.mark.parametrize("kw", [dict(pix_noise=0.3, mono_frac=0.3, seed=9),
                                dict(pix_noise=0.5, outlier_frac=0.1, seed=3)])
def test_solve_ba_matches_reference(kw):
    """The port's one assembly against the reference's generic path, on
    problems with one edge per (point, camera) pair, where the two
    assemble the same sums: poses to 1e-4, points to 1e-3 at the 99th
    percentile and 2e-2 at most (the reference's own bar between its two
    assemblies, from weakly constrained points), the pruned edge set
    exactly."""
    prob, _, _, nc, npts = make_problem(**kw)
    ref_cam, ref_p, ref_keep, _ = ref_schur.solve_ba_with_outlier_rounds(CAM_REF, prob)
    cam_o, p_o, keep, stats = schur.solve_ba_with_outlier_rounds(
        CAM, convert.ba_problem_to_torch(prob))
    np.testing.assert_allclose(np.asarray(ref_cam)[:nc], cam_o.numpy()[:nc], atol=1e-4)
    d = np.abs(np.asarray(ref_p)[:npts] - p_o.numpy()[:npts])
    assert np.percentile(d, 99) < 1e-3 and d.max() < 2e-2, (np.percentile(d, 99), d.max())
    np.testing.assert_array_equal(np.asarray(ref_keep), keep.numpy())


@pytest.mark.parametrize("kw,n_iters", [
    (dict(pix_noise=0.3, mono_frac=0.3, seed=9), 4),
    (dict(pix_noise=0.5, outlier_frac=0.1, seed=3), 2)])
def test_solve_ba_cg_matches_reference(kw, n_iters):
    """The matrix-free Schur PCG (global BA's solver) on a reference-built
    problem: cameras and points to 1e-3 (+ 1e-3 relative), the robust cost
    to 1e-3 relative (48 float32 CG iterations per LM step whose sums over
    edges run in another order), and the cost went down."""
    from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3   # make_problem's
    from lc_crf_slam_torch.geometry.camera import TUM3

    prob, _, _, nc, npts = make_problem(**kw)
    ref_cam, ref_p, ref_stats = ref_schur.solve_ba_cg(REF_TUM3, prob, n_iters=n_iters)
    tprob = convert.ba_problem_to_torch(prob)
    cam_o, p_o, stats = schur.solve_ba_cg(TUM3, tprob, n_iters=n_iters)
    np.testing.assert_allclose(np.asarray(ref_cam), cam_o.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(ref_p), p_o.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(float(ref_stats.cost), float(stats.cost), rtol=1e-3)
    assert int(ref_stats.n_edges) == int(stats.n_edges)
    assert not stats.edge_chi2.any()
    _, _, before = schur.solve_ba_cg(TUM3, tprob, n_iters=0)
    assert float(stats.cost) < 0.5 * float(before.cost)
    # fixed cameras did not move
    fixed = np.asarray(prob.cam_fixed)
    np.testing.assert_array_equal(np.asarray(prob.cam_Tcw)[fixed], cam_o.numpy()[fixed])


# ------------------------------------------------------- mapping stages
@pytest.fixture(scope="module")
def stages():
    """The reference with mapping and CRF on a QVGA billboard world, to
    the third keyframe's mapping pass; that pass's input state and the
    reference's state after each of its stages."""
    world = RefWorld(cam=CAM_REF, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line", billboard=True, bb_speed=0.04)
    slam = RefSystem(CAM_REF, SLICE_CFG, enable_mapping=True, enable_crf=True)
    captured = []
    run_mapping = slam._mapping

    def capture(cfg, cam, m, kf):
        captured.append((m, kf))
        return run_mapping(cfg, cam, m, kf)

    slam._mapping = capture
    k = 0
    while len(captured) < 3:
        gray, depth = render(world, k)
        slam.track_rgbd(gray, depth, k / 30.0)
        k += 1
    m0, kf = captured[-1]
    cfg, cam = SLICE_CFG, CAM_REF
    out = {"in": m0, "kf": kf}
    out["create"] = ref_mapping.create_new_points(cfg, cam, m0, kf)
    out["fuse"] = ref_mapping.fuse_duplicates(cfg, cam, out["create"], kf)
    out["refresh"] = ref_mapping.refresh_point_stats(cfg, cam, out["fuse"], kf)
    out["ba"] = ref_mapping.local_bundle_adjustment(cfg, cam, out["refresh"], kf)
    out["cull_points"] = ref_mapping.cull_points(cfg, out["ba"])
    out["cull_kfs"] = ref_mapping.cull_keyframes(cfg, out["cull_points"], kf)
    out["step"] = run_mapping(cfg, cam, m0, kf)
    return out


def _port(m):
    return convert.map_to_torch(m)


def test_incidence_and_covisibility(stages):
    m = stages["in"]
    ref_A = np.asarray(ref_ms.incidence_matrix(m))
    np.testing.assert_array_equal(ref_A, mapstate.incidence_matrix(_port(m)).numpy())
    ref_W = np.asarray(ref_ms.covisibility(m))
    np.testing.assert_array_equal(ref_W, mapstate.covisibility(_port(m)).numpy())
    assert int(np.asarray(m.n_kfs)) >= 3 and ref_W.max() > 15


def test_create_new_points(stages):
    """New points to 1e-3 relative: the closed-form midpoint solve divides
    by a determinant that low parallax makes small, which magnifies the
    f32 rounding of the ray products."""
    out = mapping.create_new_points(SLICE_CFG, CAM, _port(stages["in"]),
                                    torch.tensor(int(stages["kf"])))
    assert_map_equal(stages["create"], out, rtol=1e-3)
    assert int(np.asarray(stages["create"].p_alive).sum()) > int(
        np.asarray(stages["in"].p_alive).sum())


def test_fuse_duplicates(stages):
    out = mapping.fuse_duplicates(SLICE_CFG, CAM, _port(stages["create"]),
                                  torch.tensor(int(stages["kf"])))
    assert_map_equal(stages["fuse"], out)


def test_fuse_duplicates_loop_mode(stages):
    """SearchAndFuse's merge policy on the same state, with the evidence
    fields filled from a seed so that the cleaner-`p_dyn` rule decides some
    survivors: integer state exactly, the EMAs to 1e-6."""
    m = stages["create"]
    rng = np.random.default_rng(31)
    P = m.p_xyz.shape[0]
    fill = lambda hi: jnp.asarray(rng.uniform(0, hi, P).astype(np.float32))
    m = m._replace(p_dyn=fill(0.6), p_err_ema=fill(3.0), p_depth_err_ema=fill(0.1),
                   p_flow_err=fill(2.0),
                   p_last_seen=jnp.asarray(rng.integers(0, 40, P).astype(np.int32)),
                   p_visible=jnp.asarray(rng.integers(1, 30, P).astype(np.int32)))
    kf = stages["kf"]
    ref = ref_mapping.fuse_duplicates(SLICE_CFG, CAM_REF, m, kf, loop_mode=True)
    plain = ref_mapping.fuse_duplicates(SLICE_CFG, CAM_REF, m, kf)
    out = mapping.fuse_duplicates(SLICE_CFG, CAM, _port(m), torch.tensor(int(kf)),
                                  loop_mode=True)
    assert_map_equal(ref, out, float_tol=1e-6)
    merged = np.asarray(m.p_alive) & ~np.asarray(ref.p_alive)
    assert merged.sum() >= 5
    # the loop policy chose other survivors than the observation count would
    assert (np.asarray(ref.p_alive) != np.asarray(plain.p_alive)).any()
    assert (np.asarray(ref.p_visible) != np.asarray(m.p_visible)).any()


@pytest.mark.parametrize("what", ["observed_mask", "scrub_dead_obs"])
def test_observation_helpers(stages, what):
    """`observed_mask` (with -1 padding and a repeated keyframe) and
    `scrub_dead_obs` after the pass culled points: exact."""
    m = stages["step"]
    if what == "observed_mask":
        n = int(np.asarray(m.n_kfs))
        for ids in ([0, -1, n - 1, -1], [1, 1, -1], [-1, -1]):
            ref = np.asarray(ref_ms.observed_mask(m, jnp.asarray(ids, jnp.int32)))
            out = mapstate.observed_mask(_port(m), torch.tensor(ids)).numpy()
            np.testing.assert_array_equal(ref, out)
        assert ref.sum() == 0
    else:
        dead = jnp.asarray(np.random.default_rng(5).random(m.p_alive.shape) < 0.3)
        m = m._replace(p_alive=m.p_alive & ~dead)
        ref = ref_ms.scrub_dead_obs(m)
        assert_map_equal(ref, mapstate.scrub_dead_obs(_port(m)), float_tol=0.0)
        assert (np.asarray(ref.kf_obs) != np.asarray(m.kf_obs)).any()


def test_refresh_point_stats(stages):
    out = mapping.refresh_point_stats(SLICE_CFG, CAM, _port(stages["fuse"]),
                                      torch.tensor(int(stages["kf"])))
    assert_map_equal(stages["refresh"], out, float_tol=1e-5)


def test_local_bundle_adjustment(stages):
    """Against the reference's grid-path local BA (the window holds
    keyframes that observe a point twice, where the reference's own
    generic path differs from it by up to 0.18 m): poses and points to
    1e-4, the pruned observations and observation counts exactly."""
    out = mapping.local_bundle_adjustment(SLICE_CFG, CAM, _port(stages["refresh"]),
                                          torch.tensor(int(stages["kf"])))
    assert_map_equal(stages["ba"], out)
    moved = np.abs(np.asarray(stages["ba"].p_xyz) - np.asarray(stages["refresh"].p_xyz))
    assert moved.max() > 1e-4      # the BA did move something


def test_cull_points_and_keyframes(stages):
    kf = torch.tensor(int(stages["kf"]))
    assert_map_equal(stages["cull_points"], mapping.cull_points(SLICE_CFG, _port(stages["ba"])))
    assert_map_equal(stages["cull_kfs"],
                     mapping.cull_keyframes(SLICE_CFG, _port(stages["cull_points"]), kf))


def test_mapping_step(stages):
    """The whole pass from the same input (with the two reverse fuses):
    the stage errors compound, so floats to 1e-3 + 1e-3 relative (a new
    point's scale range inherits its triangulation's); integer state
    exactly."""
    out = mapping.mapping_step(SLICE_CFG, CAM, _port(stages["in"]),
                               torch.tensor(int(stages["kf"])))
    assert_map_equal(stages["step"], out, float_tol=1e-3, rtol=1e-3)


class _SumRecorder:
    """Stands in for a module's `segment_sum` and keeps, per call, the
    number of targets and the plan it was handed."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, vals, plan):
        self.calls.append((len(vals), plan))
        return self.fn(vals, plan)


@pytest.mark.parametrize("solver", ["solve_ba", "solve_ba_cg"])
def test_ba_sums_run_through_segment_sum(solver, monkeypatch):
    """Every edge sum of both solvers goes through `segment_sum` with a
    plan built once per solve (one per target space), and the result holds
    to the reference at the tolerances of the tests above."""
    from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
    from lc_crf_slam_torch.geometry.camera import TUM3

    rec = _SumRecorder(schur.segment_sum)
    monkeypatch.setattr(schur, "segment_sum", rec)
    prob, _, _, nc, npts = make_problem(pix_noise=0.3, mono_frac=0.3, seed=9)
    tprob = convert.ba_problem_to_torch(prob)
    if solver == "solve_ba":
        ref_cam, ref_p, _ = ref_schur.solve_ba(CAM_REF, prob, n_iters=4)
        cam_o, p_o, _ = schur.solve_ba(CAM, tprob, n_iters=4)
        np.testing.assert_allclose(np.asarray(ref_cam)[:nc], cam_o.numpy()[:nc], atol=1e-4)
        d = np.abs(np.asarray(ref_p)[:npts] - p_o.numpy()[:npts])
        assert np.percentile(d, 99) < 1e-3 and d.max() < 2e-2
        per_iter, n_plans = 5, 3
    else:
        ref_cam, ref_p, _ = ref_schur.solve_ba_cg(REF_TUM3, prob, n_iters=2)
        cam_o, p_o, _ = schur.solve_ba_cg(TUM3, tprob, n_iters=2)
        np.testing.assert_allclose(np.asarray(ref_cam), cam_o.numpy(), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(np.asarray(ref_p), p_o.numpy(), atol=1e-3, rtol=1e-3)
        per_iter, n_plans = 4 + 1 + 1 + 2 * 48 + 1, 2
    n_iters = 4 if solver == "solve_ba" else 2
    assert len(rec.calls) == per_iter * n_iters
    assert all(plan.idx.shape == (E,) for E, plan in rec.calls)
    assert len({id(plan) for _, plan in rec.calls}) == n_plans


@pytest.mark.parametrize("shape", [(50,), (50, 3)])
def test_scatter_set_last_write_wins(shape):
    """`scatter_set` with many writes to each row and out-of-range
    indices: the last write of each row wins, as `.at[].set(mode="drop")`
    does on the CPU, where the reference runs its tests (the port's rule on
    every device: tests/test_torch_kernels_cuda.py holds the card to it)."""
    from lc_crf_slam_torch._ops import scatter_set

    rng = np.random.default_rng(5)
    arr = rng.integers(0, 100, shape).astype(np.int32)
    idx = rng.integers(0, 60, 300).astype(np.int32)
    val = rng.integers(-50, 150, (300,) + shape[1:]).astype(np.int32)
    ref = jnp.asarray(arr).at[jnp.asarray(idx)].set(jnp.asarray(val), mode="drop")
    out = scatter_set(_t(arr), _t(idx), _t(val))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    expect = arr.copy()
    for i, v in zip(idx, val):
        if i < shape[0]:
            expect[i] = v
    np.testing.assert_array_equal(expect, out.numpy())
