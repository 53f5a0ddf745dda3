"""CRF-chain parity: pyramidal LK, the CRF labeler, the forward-flow
evidence EMA, the backward-flow spawn gate and keyframe insertion behind
it, against the JAX package. Pipeline states come from the reference run
on a QVGA billboard world (a rigid mover crossing a static scene)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lc_crf_slam_tpu.models import crf as ref_crf
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.ops import lk_flow as ref_lk
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.models import crf, system, tracking
from lc_crf_slam_torch.ops import lk_flow

from torch_parity import CAM, CAM_REF, SLICE_CFG, render

LK_PX = 1e-2          # tracked positions
RNG = np.random.default_rng(31)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _textured(H=160, W=200):
    """Smooth random texture: a 5x5 box blur of uniform noise, applied
    twice."""
    img = RNG.random((H + 8, W + 8)).astype(np.float32) * 200
    for _ in range(2):
        img = sum(img[i:i + img.shape[0] - 4, j:j + img.shape[1] - 4]
                  for i in range(5) for j in range(5)) / 25.0
    return img[:H, :W].astype(np.float32)


# -------------------------------------------------------------------- LK
def test_pyramid2_matches_reference():
    img = _textured()
    ref = ref_lk._pyramid2(jnp.asarray(img), 3)
    out = lk_flow._pyramid2(_t(img), 3)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3)


@pytest.mark.parametrize("shift", [(3.4, -2.2), (11.0, 7.5)])
def test_lk_track_matches_reference(shift):
    """Positions to 1e-2 px, errors to 1e-2 graylevels, the ok mask
    exactly (a keypoint on the border of the ok gate may flip; none is
    within 1e-2 of it here)."""
    img = _textured()
    dy, dx = shift[1], shift[0]
    # a shifted copy by bilinear resampling of the smooth texture
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]].astype(np.float32)
    sy, sx = np.clip(yy - dy, 0, img.shape[0] - 1.001), np.clip(xx - dx, 0, img.shape[1] - 1.001)
    y0, x0 = np.floor(sy).astype(int), np.floor(sx).astype(int)
    fy, fx = sy - y0, sx - x0
    img2 = ((1 - fy) * (1 - fx) * img[y0, x0] + (1 - fy) * fx * img[y0, x0 + 1]
            + fy * (1 - fx) * img[y0 + 1, x0] + fy * fx * img[y0 + 1, x0 + 1])
    img2 = img2.astype(np.float32)
    uv = RNG.uniform(5, 190, (96, 2)).astype(np.float32)
    uv[:, 1] = np.clip(uv[:, 1], 5, 150)
    valid = RNG.random(96) < 0.9
    ref = ref_lk.lk_track(jnp.asarray(img), jnp.asarray(img2), jnp.asarray(uv),
                          jnp.asarray(valid))
    out = lk_flow.lk_track(_t(img), _t(img2), _t(uv), _t(valid))
    np.testing.assert_allclose(np.asarray(ref.uv_next), out.uv_next.numpy(), atol=LK_PX)
    np.testing.assert_allclose(np.asarray(ref.err), out.err.numpy(), atol=1e-2)
    np.testing.assert_array_equal(np.asarray(ref.ok), out.ok.numpy())
    ok = out.ok.numpy()
    assert ok.sum() > 40
    if max(map(abs, shift)) < 5:        # inside the capture range: the truth
        flow = out.uv_next.numpy()[ok] - uv[ok]
        assert np.median(np.abs(flow - np.asarray(shift, np.float32))) < 0.1


# ------------------------------------------------------------ CRF parts
def test_knn_graph_and_mean_field():
    """Neighbour indices exactly (ties to the lower index, as lax.top_k),
    weights to 1e-6, q(dynamic) to 1e-5."""
    N = 300
    xyz = RNG.normal(0, 1.0, (N, 3)).astype(np.float32)
    xyz[:20] = xyz[20:40]                      # exact duplicates: tied distances
    ok = RNG.random(N) < 0.8
    cfg = SLICE_CFG
    nbr_r, w_r = ref_crf.knn_graph(cfg, jnp.asarray(xyz), jnp.asarray(ok))
    nbr, w = crf.knn_graph(cfg, _t(xyz), _t(ok))
    np.testing.assert_array_equal(np.asarray(nbr_r)[ok], nbr.numpy()[ok])
    np.testing.assert_allclose(np.asarray(w_r), w.numpy(), atol=1e-6)
    u_s = RNG.uniform(-1, 6, N).astype(np.float32)
    u_d = np.full(N, 1.5, np.float32)
    q_r = ref_crf.mean_field(cfg, jnp.asarray(u_s), jnp.asarray(u_d), nbr_r, w_r,
                             jnp.asarray(ok))
    q = crf.mean_field(cfg, _t(u_s), _t(u_d), nbr, w, _t(ok))
    np.testing.assert_allclose(np.asarray(q_r), q.numpy(), atol=1e-5)


# ------------------------------------------------------ pipeline states
@pytest.fixture(scope="module")
def run():
    """The reference with mapping and CRF on the QVGA billboard world for
    9 frames, recording the inputs and outputs of its spawn gate,
    keyframe insertion, flow evidence and CRF step."""
    world = RefWorld(cam=CAM_REF, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                     trajectory="line", billboard=True, bb_speed=0.04)
    slam = RefSystem(CAM_REF, SLICE_CFG, enable_mapping=True, enable_crf=True)
    log = {}

    def record(name):
        fn = getattr(slam, name)

        def wrapped(*args):
            out = fn(*args)
            log.setdefault(name, []).append((args, out))
            return out
        setattr(slam, name, wrapped)

    for name in ("_spawn_flow_dyn", "_insert_kf", "_flow_evidence", "_crf"):
        record(name)
    for k in range(9):
        gray, depth = render(world, k)
        slam.track_rgbd(gray, depth, k / 30.0)
    return log


def test_flow_evidence(run):
    """p_flow_err to 1e-3 px (an EMA of LK residuals, LK to 1e-2 px scaled
    by 1 - flow_decay)."""
    (cfg, cam, m, g0, g1, uv, obs, valid, Tcw), m_ref = run["_flow_evidence"][-1]
    out = system.flow_evidence(SLICE_CFG, CAM, convert.map_to_torch(m), _t(g0), _t(g1),
                               _t(uv), _t(obs), _t(valid), _t(Tcw))
    ref = np.asarray(m_ref.p_flow_err)
    np.testing.assert_allclose(ref, out.p_flow_err.numpy(), atol=1e-3)
    assert (ref != np.asarray(m.p_flow_err)).sum() > 50


def test_spawn_flow_dyn_and_insert_keyframe(run):
    """The spawn gate's mask exactly; keyframe insertion behind it (with
    the condemned -2 features) array by array: integer state exactly,
    floats to 1e-6 (new points are depth unprojections, 1 ulp apart)."""
    assert run["_spawn_flow_dyn"], "no keyframe with a spawn gate"
    (cfg, cam, g_cur, g_prev, uv, depth, valid, Tcw, Tcw_prev), dyn_ref = \
        run["_spawn_flow_dyn"][-1]
    dyn = system.spawn_flow_dyn(SLICE_CFG, CAM, _t(g_cur), _t(g_prev), _t(uv), _t(depth),
                                _t(valid), _t(Tcw), _t(Tcw_prev))
    np.testing.assert_array_equal(np.asarray(dyn_ref), dyn.numpy())
    assert np.asarray(dyn_ref).sum() > 0
    args, (m_ref, ts_ref) = run["_insert_kf"][-1]
    cfg, cam, m, ts, frame, obs, t, near_map, flow_dyn = args
    m_out, ts_out = tracking.insert_keyframe(
        SLICE_CFG, CAM, convert.map_to_torch(m), convert.track_to_torch(ts),
        convert.frame_to_torch(frame), _t(obs), _t(t), _t(near_map), _t(flow_dyn))
    got = convert.to_numpy(m_out)
    for f in m_ref._fields:
        if got[f].dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(getattr(m_ref, f)), got[f], atol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(np.asarray(getattr(m_ref, f)), got[f], err_msg=f)
    assert (np.asarray(m_ref.kf_obs) == -2).any()
    for f in ("ref_kf", "ref_matches", "n_since_kf", "last_obs"):
        np.testing.assert_array_equal(np.asarray(getattr(ts_ref, f)),
                                      getattr(ts_out, f).numpy(), err_msg=f)


def test_crf_step(run):
    """Track selection and labels: n_tracks and n_dynamic equal, p_dyn to
    1e-5, the unaries' noise floors to 1e-6."""
    (cfg, m, frame_idx), (m_ref, info_ref) = run["_crf"][-1]
    mt = convert.map_to_torch(m)
    for a, b in zip(ref_crf.noise_floors(SLICE_CFG, m), crf.noise_floors(SLICE_CFG, mt)):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    out, info = crf.crf_step(SLICE_CFG, mt, _t(frame_idx))
    assert int(info_ref.n_tracks) == int(info.n_tracks) > 100
    assert int(info_ref.n_dynamic) == int(info.n_dynamic)
    np.testing.assert_allclose(float(info_ref.mean_q), float(info.mean_q), atol=1e-6)
    np.testing.assert_allclose(np.asarray(m_ref.p_dyn), out.p_dyn.numpy(), atol=1e-5)
