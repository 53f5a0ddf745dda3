"""The Sim(3) algebra, the Horn RANSAC and OptimizeSim3 of the port against
the JAX reference: the same numpy inputs from a seed through both.

Tolerances (float32): the algebra 1e-5; `horn_ransac` fed the reference's
draws must find the same inliers, R and t to 1e-4 (3-point hypotheses go
through a rank-2 covariance); `optimize_sim3` the same inliers, the
transform to 1e-4 (its Jacobian is written out where the reference
differentiates forward)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.geometry import se3 as ref_se3
from lc_crf_slam_tpu.geometry import sim3 as ref_sim3
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.models.sim3opt import optimize_sim3 as ref_optimize_sim3
from lc_crf_slam_tpu.ops.ransac import horn_ransac as ref_horn_ransac
from lc_crf_slam_torch.geometry import sim3
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.models.sim3opt import optimize_sim3
from lc_crf_slam_torch.ops.ransac import horn_ransac, multinomial_sampler

from torch_parity import reference_horn_sampler

ATOL = 1e-5
# rotation angles and log-scales on both sides of the Taylor cutoffs
# (theta 5e-2, sigma 2e-2)
ANGLES = [0.0, 1e-4, 0.049, 0.051, 0.4, 1.5, 2.5, 0.3, 0.01]
SIGMAS = [0.0, 1e-3, 0.019, 0.021, -0.3, 0.5, 0.0, 0.0, 0.2]


def _twists(seed=0):
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(len(ANGLES), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return np.concatenate([rng.normal(0, 0.5, (len(ANGLES), 3)),
                           axes * np.asarray(ANGLES)[:, None],
                           np.asarray(SIGMAS)[:, None]], axis=1).astype(np.float32)


def _j(S):
    return tuple(jnp.asarray(a) for a in S)


def _t(S):
    return tuple(torch.tensor(np.asarray(a)) for a in S)


def _close(ref, out, atol=ATOL):
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


def test_exp_sim3_matches_reference():
    xi = _twists()
    _close(ref_sim3.exp_sim3(jnp.asarray(xi)), sim3.exp_sim3(torch.tensor(xi)))
    _close(ref_sim3._sim3_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])),
           sim3._sim3_W(torch.tensor(xi[:, 3:6]), torch.tensor(xi[:, 6])))


def test_log_sim3_matches_reference_and_inverts_exp():
    xi = _twists(1)
    S = ref_sim3.exp_sim3(jnp.asarray(xi))
    out = sim3.log_sim3(_t(S))
    _close(ref_sim3.log_sim3(S), out, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), xi, atol=2e-5)


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "se3"])
def test_sim3_algebra(op):
    A = ref_sim3.exp_sim3(jnp.asarray(_twists(2)))
    B = ref_sim3.exp_sim3(jnp.asarray(_twists(3)))
    p = np.random.default_rng(4).normal(0, 2, (len(ANGLES), 3)).astype(np.float32)
    if op == "compose":
        _close(ref_sim3.sim3_compose(A, B), sim3.sim3_compose(_t(A), _t(B)))
        # one element against a batch, as verify_loop composes them
        A0 = tuple(a[4] for a in A)
        _close(ref_sim3.sim3_compose(A0, B), sim3.sim3_compose(_t(A0), _t(B)))
    elif op == "inverse":
        out = sim3.sim3_inverse(_t(A))
        _close(ref_sim3.sim3_inverse(A), out)
        s, R, t = sim3.sim3_compose(_t(A), out)       # round trip: the identity
        si, Ri, ti = sim3.sim3_identity()
        assert torch.allclose(s, si.expand_as(s), atol=ATOL)
        assert torch.allclose(R, Ri.expand_as(R), atol=ATOL)
        assert torch.allclose(t, ti.expand_as(t), atol=ATOL)
    elif op == "apply":
        _close(ref_sim3.sim3_apply(A, jnp.asarray(p)),
               sim3.sim3_apply(_t(A), torch.tensor(p)))
    else:
        T = np.asarray(ref_se3.exp_se3(jnp.asarray(_twists(5)[:, :6])))
        _close(ref_sim3.sim3_from_se3(jnp.asarray(T)), sim3.sim3_from_se3(torch.tensor(T)))
        _close(ref_sim3.se3_from_sim3(A), sim3.se3_from_sim3(_t(A)))
        _close(tuple(ref_sim3.sim3_identity()), tuple(sim3.sim3_identity()))


def _correspondences(seed, n=300, n_out=90, scale=1.0):
    """src -> dst by a known similarity with 5 mm noise; `n_out` gross
    outliers and 40 invalid rows."""
    rng = np.random.default_rng(seed)
    src = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2, 6, n)], -1).astype(np.float32)
    T = np.asarray(ref_se3.exp_se3(jnp.asarray([0.2, -0.1, 0.15, 0.03, -0.05, 0.02],
                                               jnp.float32)))
    dst = scale * src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.005, src.shape)
    dst[:n_out] += rng.normal(0, 1.0, (n_out, 3))
    valid = np.ones(n, bool)
    valid[-40:] = False
    return src, dst.astype(np.float32), valid, T


@pytest.mark.parametrize("fix_scale,scale", [(True, 1.0), (False, 1.15)])
def test_horn_ransac_with_reference_draws(fix_scale, scale):
    src, dst, valid, T = _correspondences(6, scale=scale)
    key = jax.random.PRNGKey(3)
    ref = ref_horn_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key,
                          n_hypotheses=256, fix_scale=fix_scale)
    out = horn_ransac(torch.tensor(src), torch.tensor(dst), torch.tensor(valid),
                      reference_horn_sampler(key), n_hypotheses=256,
                      fix_scale=fix_scale)
    assert np.array_equal(np.asarray(ref.inliers), out.inliers.numpy())
    assert int(ref.n_inliers) == int(out.n_inliers) >= 150
    _close((ref.s, ref.R, ref.t), (out.s, out.R, out.t), atol=1e-4)
    np.testing.assert_allclose(out.R.numpy(), T[:3, :3], atol=5e-3)
    assert abs(float(out.s) - scale) < 5e-3


def test_horn_ransac_own_draws():
    """The pipeline's sampler: seeded, repeatable, and good enough to find
    the transform; with no valid row it still returns finite values."""
    src, dst, valid, T = _correspondences(7)
    gen = torch.Generator().manual_seed(5)
    args = (torch.tensor(src), torch.tensor(dst), torch.tensor(valid))
    a = horn_ransac(*args, multinomial_sampler(gen))
    gen.manual_seed(5)
    b = horn_ransac(*args, multinomial_sampler(gen))
    assert torch.equal(a.inliers, b.inliers) and torch.equal(a.R, b.R)
    assert int(a.n_inliers) >= 150
    np.testing.assert_allclose(a.t.numpy(), T[:3, 3], atol=2e-2)
    none = horn_ransac(args[0], args[1], torch.zeros(len(src), dtype=torch.bool),
                       multinomial_sampler(gen))
    assert int(none.n_inliers) == 0 and bool(torch.isfinite(none.R).all())


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_matches_reference(fix_scale):
    """Two cameras see one cloud; S12 starts 3 cm / 1 degree (and 3% in
    scale) off; 30 of 200 pairs are mismatched and 20 invalid."""
    rng = np.random.default_rng(8)
    n = 200
    pc1 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 5, n)], -1).astype(np.float32)
    T12 = np.asarray(ref_se3.exp_se3(jnp.asarray([0.3, 0.05, -0.1, 0.02, 0.1, -0.03],
                                                 jnp.float32)))
    T21 = np.linalg.inv(T12)
    pc2 = (pc1 @ T21[:3, :3].T + T21[:3, 3]).astype(np.float32)

    def proj(pc):
        return np.stack([REF_TUM3.fx * pc[:, 0] / pc[:, 2] + REF_TUM3.cx,
                         REF_TUM3.fy * pc[:, 1] / pc[:, 2] + REF_TUM3.cy], -1)

    uv1 = (proj(pc1) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(pc2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2[:30] += rng.normal(0, 25, (30, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-20:] = False
    inv_sigma2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    off = np.asarray(ref_se3.exp_se3(jnp.asarray([0.03, -0.02, 0.01, 0.01, -0.015, 0.005],
                                                 jnp.float32)))
    T0 = off @ T12
    s0 = np.float32(1.0 if fix_scale else 1.03)
    S0 = (s0, T0[:3, :3].astype(np.float32), T0[:3, 3].astype(np.float32))
    arrs = (pc1, pc2, uv1, uv2, valid, inv_sigma2)
    ref = ref_optimize_sim3(REF_TUM3, _j(S0), *(jnp.asarray(a) for a in arrs),
                            fix_scale=fix_scale)
    out = optimize_sim3(TUM3, _t(S0), *(torch.tensor(a) for a in arrs),
                        fix_scale=fix_scale)
    assert np.array_equal(np.asarray(ref.inliers), out.inliers.numpy())
    assert int(ref.n_inliers) == int(out.n_inliers) >= 140
    _close((ref.s, ref.R, ref.t), (out.s, out.R, out.t), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), T12[:3, 3], atol=1e-2)
    if fix_scale:
        assert float(out.s) == 1.0
