"""The monocular sensor of the port against the JAX reference: the
two-view initialisation (`models/initializer.py`) on the worlds of
tests/test_triangulation_mono.py with the reference's draws, its pieces
(the Sampson error, the reference's midpoint median), and
`track_observations_mono` end to end on the mono loop world of
tests/test_mono_sim3_loop_e2e.py.

Tolerances: `accepted` and `n_good` exactly, `Tcw2` to 1e-4 in every
entry, the triangulated points to 1e-3 relative (the port's null vector
comes from a float64 `eigh` of the normal matrix and its 3×3
decompositions from a Jacobi eigensolver, the reference's from float32
SVDs). End to end (13
frames in tier-1, mapping on): the initialisation on the same frame, the
same keyframes and map points, poses to 1e-3 in the initialisation's
scale. `slow`: 30 frames of that world, the
rendered 640×480 monocular world, and the mono loop world with its
injected scale drift, where the port must give the reference's
`loop_log` and keyframes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import MapConfig
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3, project_points
from lc_crf_slam_tpu.geometry.se3 import exp_se3
from lc_crf_slam_tpu.models import initializer as ref_init
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.models import initializer as init
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import (CAM, CAM_REF, assert_poses_close, reference_mono_sampler,
                          use_reference_draws)


def two_views(rng, n, twist, noise):
    """tests/test_triangulation_mono.py's worlds: n points in front of the
    first camera (at I) seen from exp(twist), pixel noise `noise`."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2.5, 6, n)], -1).astype(np.float32)
    T2 = np.asarray(exp_se3(jnp.asarray(twist, jnp.float32)))
    uvs = []
    for T in (np.eye(4, dtype=np.float32), T2):
        uv, _ = project_points(REF_TUM3, jnp.asarray(pts @ T[:3, :3].T + T[:3, 3]))
        uvs.append((np.asarray(uv) + rng.normal(0, noise, (n, 2))).astype(np.float32))
    return uvs


WORLDS = {
    # test_recovers_relative_pose_up_to_scale (:65): 0.4 m baseline, 0.3 px noise
    "translation": (300, [0.4, 0.02, 0.01, 0.01, -0.05, 0.005], 0.3, 0),
    # test_rejects_pure_rotation (:90): no translation, no noise
    "rotation": (200, [0, 0, 0, 0.02, -0.04, 0.01], 0.0, 1),
}


@pytest.mark.parametrize("world", list(WORLDS))
def test_initialize_mono_matches_reference(world):
    n, twist, noise, key = WORLDS[world]
    uv1, uv2 = two_views(np.random.default_rng(17), n, twist, noise)
    valid = np.ones(n, bool)
    valid[::7] = False                      # masked matches draw nothing
    key = jax.random.PRNGKey(key)
    ref = ref_init.initialize_mono(REF_TUM3, jnp.asarray(uv1), jnp.asarray(uv2),
                                   jnp.asarray(valid), key)
    out = init.initialize_mono(TUM3, torch.from_numpy(uv1), torch.from_numpy(uv2),
                               torch.from_numpy(valid), reference_mono_sampler(key))
    ref = convert.mono_init_to_torch(ref)
    assert bool(ref.accepted) == bool(out.accepted) == (world == "translation")
    assert int(ref.n_good) == int(out.n_good)
    ok = ref.ok
    assert torch.equal(ok, out.ok)
    if world == "translation":
        torch.testing.assert_close(out.Tcw2, ref.Tcw2, atol=1e-4, rtol=0)
        xyz = ref.xyz[ok]
        torch.testing.assert_close(out.xyz[ok], xyz, rtol=1e-3,
                                   atol=1e-3 * float(xyz.abs().max()))


def test_sampson_error_matches_reference():
    rng = np.random.default_rng(3)
    E = rng.normal(size=(5, 3, 3)).astype(np.float32)
    x1, x2 = (rng.normal(0, 0.5, (40, 2)).astype(np.float32) for _ in range(2))
    ref = jax.vmap(lambda e: ref_init._sampson_error(e, jnp.asarray(x1), jnp.asarray(x2)))(
        jnp.asarray(E))
    out = init._sampson_error(torch.from_numpy(E), torch.from_numpy(x1),
                              torch.from_numpy(x2))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-7)


def test_eight_point_is_an_essential_matrix():
    """The projected E of eight exact correspondences: two equal singular
    values and a zero one, epipolar residuals ~0, and equal up to sign to
    the reference's."""
    uv1, uv2 = two_views(np.random.default_rng(5), 8, [0.3, 0.05, 0.0, 0.02, 0.1, 0.0], 0.0)
    x1 = init._normalize(TUM3, torch.from_numpy(uv1))
    x2 = init._normalize(TUM3, torch.from_numpy(uv2))
    E = init._eight_point(x1, x2)
    S = np.linalg.svd(E.numpy().astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(S, [S[0], S[0], 0.0], atol=1e-5)
    ref = np.asarray(ref_init._eight_point(jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy())))
    sign = np.sign(np.sum(ref * E.numpy()))
    np.testing.assert_allclose(ref, sign * E.numpy(), atol=1e-4)


@pytest.mark.parametrize("n_ok", [0, 1, 6, 7])
def test_midpoint_median_matches_nanmedian(n_ok):
    """`jnp.nanmedian` averages the two middle values of an even count."""
    x = np.random.default_rng(n_ok).uniform(1, 5, 12).astype(np.float32)
    ok = np.zeros(12, bool)
    ok[np.random.default_rng(n_ok + 1).permutation(12)[:n_ok]] = True
    ref = float(jnp.nanmedian(jnp.where(jnp.asarray(ok), jnp.asarray(x), jnp.nan)))
    out = float(init._midpoint_median(torch.from_numpy(x), torch.from_numpy(ok)))
    if n_ok == 0:
        assert np.isnan(ref) and np.isinf(out)   # both then fall back to 1
    else:
        assert ref == out


def _mono_loop_run(n_frames, inject=False, cfg=None, mapping=True):
    """Both packages' `track_observations_mono` over the first `n_frames`
    of the mono loop world (CRF off, the reference test's configuration),
    the port with the reference's draws; `inject` rescales the recent
    branch of both at the reference test's frame."""
    from test_mono_sim3_loop_e2e import (GAMMA, INJECT_FRAME, _inject_scale_drift,
                                         make_config, make_world)
    world = make_world()
    cfg = cfg or make_config().replace(map=MapConfig(max_points=4096, max_keyframes=32))
    ref = RefSystem(CAM_REF, cfg, enable_crf=False, enable_mapping=mapping)
    port = SLAMSystem(CAM, cfg, enable_crf=False, enable_mapping=mapping, device="cpu")
    use_reference_draws(port)
    injected = False
    for k in range(n_frames):
        f = world.frame(k)
        ref.track_observations_mono(f.uv, f.desc, f.timestamp)
        port.track_observations_mono(f.uv, f.desc, f.timestamp)
        if inject and not injected and ref.initialized and k >= INJECT_FRAME:
            _inject_scale_drift(ref, GAMMA)
            _inject_port_scale_drift(port, GAMMA)
            injected = True
    return ref, port


def _inject_port_scale_drift(port, gamma):
    """The reference test's `_inject_scale_drift` on a port system: the
    same numpy arithmetic on the port's state."""
    from types import SimpleNamespace
    from test_mono_sim3_loop_e2e import _inject_scale_drift

    m = port.map
    shadow = SimpleNamespace(map=m._replace(**{f: jnp.asarray(getattr(m, f).numpy())
                                               for f in ("p_xyz", "kf_Tcw", "p_first_kf",
                                                         "kf_alive", "p_min_dist",
                                                         "p_max_dist", "n_kfs")}),
                             ts=port.ts._replace(Tcw=jnp.asarray(port.ts.Tcw.numpy())))
    _inject_scale_drift(shadow, gamma)
    port.map = m._replace(**{f: torch.from_numpy(np.array(getattr(shadow.map, f)))
                             for f in ("p_xyz", "kf_Tcw", "p_min_dist", "p_max_dist")})
    port.ts = port.ts._replace(Tcw=torch.from_numpy(np.array(shadow.ts.Tcw)),
                               vel=torch.eye(4))


def _compare_mono(ref, port):
    events = lambda s: [e.get("event", e.get("status")) for e in s.stats]
    assert events(ref) == events(port)
    assert "mono_init" in events(port)
    assert ref.cfg.sensor == port.cfg.sensor == "monocular"
    ref.flush_stats()
    port.flush_stats()
    assert ref.kf_log == port.kf_log
    assert int(ref.map.n_points) == int(port.map.n_points)
    # poses from the initialisation on, in its scale (unit median depth)
    keep = np.asarray([int(r) >= 0 for _, _, r in ref.trajectory])
    assert keep.tolist() == [int(r) >= 0 for _, _, r in port.trajectory]
    _, pr = ref.get_trajectory()
    _, pp = port.get_trajectory()
    assert_poses_close(pr, pp, frames=keep)


def test_track_observations_mono_matches_reference():
    """13 frames with mapping on: the reference frame, a failed attempt,
    the initialisation on frame 2, then tracking through two keyframes,
    each mapped by triangulation only (frames 7 and 12), and onto the
    points the first one made. The slow run takes the first 30 frames."""
    ref, port = _mono_loop_run(13)
    _compare_mono(ref, port)
    assert len(port.kf_log) >= 2 and port.n_mapping_steps == len(port.kf_log)


@pytest.mark.slow
def test_track_observations_mono_30_frames_matches_reference():
    ref, port = _mono_loop_run(30)
    _compare_mono(ref, port)


@pytest.mark.slow
def test_mono_loop_world_with_injected_drift_matches_reference():
    """The reference's red gate (tests/test_mono_sim3_loop_e2e.py,
    `loop_log == []` at the time of writing): the whole 140-frame run with
    the scale drift injected into both. The port must give the reference's
    `loop_log` and keyframes, whatever they are, and finite poses."""
    from test_mono_sim3_loop_e2e import N, make_config

    ref, port = _mono_loop_run(N, inject=True, cfg=make_config())
    ref.flush_stats()
    port.flush_stats()
    assert [(e["kf"], e["cand"]) for e in ref.loop_log] == \
        [(e["kf"], e["cand"]) for e in port.loop_log]
    assert ref.kf_log == port.kf_log
    _, pp = port.get_trajectory()
    assert np.all(np.isfinite(pp))


@pytest.mark.slow
def test_track_monocular_rendered_world(monkeypatch):
    """tests/test_mono_stereo_e2e.py's rendered monocular world at 640×480
    (16 frames). The port's own front-end passes the reference test's
    checks; its descriptors differ from the reference's in a few bits
    (tests/test_torch_frontend.py), which moves the initialisation's
    matches and so its frame. Fed the reference's frames instead, the
    port initialises on the reference's frame and makes its keyframes."""
    from lc_crf_slam_tpu.config import SLAMConfig
    from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
    from lc_crf_slam_torch.models import system as port_system

    world = RefWorld(cam=REF_TUM3, n_frames=30, n_static=700, n_dynamic=0, seed=19,
                     trajectory="line", pixel_noise=0.0, depth_noise=0.0)
    images = [world.frame(k, render=True) for k in range(16)]
    events = lambda s: [e.get("event", "track") for e in s.stats]
    ref = RefSystem(REF_TUM3, SLAMConfig())
    own = SLAMSystem(TUM3, SLAMConfig(), device="cpu")
    for f in images:
        ref.track_monocular(f.image, f.timestamp)
        own.track_monocular(f.image, f.timestamp)
    for s in (ref, own):
        assert "mono_init" in events(s) and s.initialized
        assert int(s.map.n_points) > 60
    assert np.all(np.isfinite(own.ts.Tcw.numpy()))

    def reference_frame(cam, cfg, gray, depth):
        g = jnp.asarray(gray.numpy())
        return convert.frame_to_torch(ref._build_frame(REF_TUM3, ref.cfg, g,
                                                       jnp.zeros_like(g)))

    monkeypatch.setattr(port_system, "build_frame", reference_frame)
    port = SLAMSystem(TUM3, SLAMConfig(), device="cpu")
    use_reference_draws(port)
    for f in images:
        port.track_monocular(f.image, f.timestamp)
    assert events(ref) == events(port)
    ref.flush_stats()
    port.flush_stats()
    assert ref.kf_log == port.kf_log
