"""Port geometry (lc_crf_slam_torch/geometry) against the JAX reference.

Same inputs from a numpy seed through both; tolerance atol 1e-5 in
float32 (a few ulps of O(1) rotation entries and sub-metre translations).
Angles straddle the 5e-2 small-angle Taylor cutoff on both sides."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lc_crf_slam_tpu import config as ref_config
from lc_crf_slam_tpu.geometry import align as ref_align
from lc_crf_slam_tpu.geometry import camera as ref_camera
from lc_crf_slam_tpu.geometry import se3 as ref_se3
from lc_crf_slam_torch import config
from lc_crf_slam_torch.geometry import align, camera, se3

import torch_parity  # noqa: F401  (thread count)

ATOL = 1e-5
ANGLES = [0.0, 1e-5, 1e-3, 0.049, 0.0501, 0.3, 1.5, 3.0]


def _twists(seed=0):
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(len(ANGLES), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w = axes * np.asarray(ANGLES)[:, None]
    ups = rng.normal(0, 0.5, (len(ANGLES), 3))
    return np.concatenate([ups, w], axis=1).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("fn", ["exp_so3", "hat_so3"])
def test_so3_maps(fn):
    w = _twists()[:, 3:]
    _close(getattr(ref_se3, fn)(jnp.asarray(w)), getattr(se3, fn)(torch.tensor(w)))


def test_exp_se3_both_sides_of_taylor_cutoff():
    xi = _twists()
    _close(ref_se3.exp_se3(jnp.asarray(xi)), se3.exp_se3(torch.tensor(xi)))


def test_log_so3_roundtrip():
    R = np.asarray(ref_se3.exp_so3(jnp.asarray(_twists(1)[:, 3:])))
    _close(ref_se3.log_so3(jnp.asarray(R)), se3.log_so3(torch.tensor(R)))


def test_log_se3_both_sides_of_taylor_cutoff():
    """Against the reference, and as the inverse of exp_se3 (below pi)."""
    xi = _twists(7)
    T = np.asarray(ref_se3.exp_se3(jnp.asarray(xi)))
    out = se3.log_se3(torch.tensor(T))
    _close(ref_se3.log_se3(jnp.asarray(T)), out)
    np.testing.assert_allclose(out.numpy(), xi, atol=2e-5)


def test_inverse_and_orthonormalize():
    T = np.asarray(ref_se3.exp_se3(jnp.asarray(_twists(2))))
    rng = np.random.default_rng(3)
    T_noisy = T.copy()
    T_noisy[:, :3, :3] += rng.normal(0, 1e-3, (len(T), 3, 3)).astype(np.float32)
    _close(ref_se3.se3_inverse(jnp.asarray(T)), se3.se3_inverse(torch.tensor(T)))
    _close(ref_se3.orthonormalize_se3(jnp.asarray(T_noisy)),
           se3.orthonormalize_se3(torch.tensor(T_noisy)))


def test_rotmat_to_quat():
    R = np.asarray(ref_se3.exp_so3(jnp.asarray(_twists(4)[:, 3:])))
    _close(ref_se3.rotmat_to_quat(jnp.asarray(R)), se3.rotmat_to_quat(torch.tensor(R)))


@pytest.mark.parametrize("n_pts", [3, 50])
def test_umeyama_batched(n_pts):
    """Batched as pose_consensus calls it: (hypotheses, 3 points, 3)."""
    rng = np.random.default_rng(5)
    T = np.asarray(ref_se3.exp_se3(jnp.asarray(_twists(6))))
    src = rng.normal(0, 1, (len(T), n_pts, 3)).astype(np.float32)
    dst = (np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
           + rng.normal(0, 1e-3, src.shape)).astype(np.float32)
    ref = ref_align.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst))
    out = align.umeyama_alignment(torch.tensor(src), torch.tensor(dst))
    for a, b in zip(ref, out):
        _close(a, b, atol=1e-4 if n_pts == 3 else ATOL)


@pytest.mark.parametrize("n_pts,with_scale", [(3, False), (3, True), (60, False),
                                              (60, True)])
def test_umeyama_weighted_with_scale(n_pts, with_scale):
    """As horn_ransac calls it: a batch of (H, 3, 3) minimal sets without
    weights (a rank-2 covariance: the reflection fix decides the third
    axis), and one weighted refit; rigid and with the scale solved. A
    similarity of scale 1.2 generates the data, so the rigid fit is a
    compromise and the scaled one recovers 1.2."""
    rng = np.random.default_rng(9)
    T = np.asarray(ref_se3.exp_se3(jnp.asarray(_twists(10))))
    src = rng.normal(0, 1, (len(T), n_pts, 3)).astype(np.float32)
    dst = (1.2 * np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
           + rng.normal(0, 1e-3, src.shape)).astype(np.float32)
    w = None if n_pts == 3 else rng.integers(0, 2, src.shape[:2]).astype(np.float32)
    ref = ref_align.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst),
                                      w=None if w is None else jnp.asarray(w),
                                      with_scale=with_scale)
    out = align.umeyama_alignment(torch.tensor(src), torch.tensor(dst),
                                  w=None if w is None else torch.tensor(w),
                                  with_scale=with_scale)
    for a, b in zip(ref, out):
        _close(a, b, atol=1e-4 if n_pts == 3 else ATOL)
    if with_scale:
        np.testing.assert_allclose(out[0].numpy(), 1.2, atol=2e-3)
    else:
        assert torch.equal(out[0], torch.ones(len(T)))


def test_pinhole_and_config_match_reference():
    assert camera.Pinhole._fields == ref_camera.Pinhole._fields
    assert camera.TUM3 == tuple(ref_camera.TUM3)
    assert dataclasses.asdict(config.SLAMConfig()) == dataclasses.asdict(
        ref_config.SLAMConfig())


@pytest.mark.parametrize("preset", ["TUM1", "TUM2", "TUM3"])
def test_intrinsic_matrix_matches_reference(preset):
    """K as float32, exactly the reference's, on the device asked for."""
    ref = np.asarray(getattr(ref_camera, preset).intrinsic_matrix())
    out = getattr(camera, preset).intrinsic_matrix()
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref.dtype == np.float32
    assert torch.equal(getattr(camera, preset).intrinsic_matrix(device="cpu"), out)


@pytest.mark.parametrize("preset", ["TUM1", "TUM2"])
def test_undistort_pixels_matches_reference(preset):
    """The presets with distortion terms equal the reference's; the 8
    fixed-point iterations agree to 1e-4 px over the whole image, and
    distorting the result lands back on the pixel (to 0.05 px: 8
    iterations converge that far at the corners of TUM1)."""
    cam_ref, cam = getattr(ref_camera, preset), getattr(camera, preset)
    assert cam == tuple(cam_ref) and cam.has_distortion
    rng = np.random.default_rng(4)
    uv = (rng.random((500, 2)) * [cam.width, cam.height]).astype(np.float32)
    ref = np.asarray(ref_camera.undistort_pixels(cam_ref, jnp.asarray(uv)))
    out = camera.undistort_pixels(cam, torch.from_numpy(uv))
    np.testing.assert_allclose(ref, out.numpy(), atol=1e-4, rtol=0)
    xy = torch.stack([(out[:, 0] - cam.cx) / cam.fx, (out[:, 1] - cam.cy) / cam.fy], -1)
    xy_ref = jnp.asarray(xy.numpy())
    np.testing.assert_allclose(np.asarray(ref_camera.distort_normalized(cam_ref, xy_ref)),
                               camera.distort_normalized(cam, xy).numpy(), atol=1e-6)
    back = camera.distort_normalized(cam, xy) * torch.tensor([cam.fx, cam.fy]) + \
        torch.tensor([cam.cx, cam.cy])
    assert float((back - torch.from_numpy(uv)).abs().max()) < 0.05
    assert torch.equal(camera.undistort_pixels(camera.TUM3, torch.from_numpy(uv)),
                       torch.from_numpy(uv))


def _helper_case(name):
    """(reference result, port result) of one public helper on the same
    numpy inputs."""
    import lc_crf_slam_tpu.geometry as ref_geometry
    import lc_crf_slam_torch.geometry as geometry

    rng = np.random.default_rng(len(name))
    T = np.array(ref_se3.exp_se3(jnp.asarray(_twists(1))))
    p = rng.normal(0, 1, (len(T), 3)).astype(np.float32)
    pc = np.concatenate([rng.uniform(-1, 1, (64, 2)), rng.uniform(0.5, 5, (64, 1))],
                        -1).astype(np.float32)
    pc[0, 2] = 0.0                                        # the z guard
    cam_r, cam_t = ref_camera.TUM3, camera.TUM3
    if name == "vee_so3":
        W = np.array(ref_se3.hat_so3(jnp.asarray(p)))
        return ref_se3.vee_so3(jnp.asarray(W)), se3.vee_so3(torch.from_numpy(W))
    if name == "se3_compose":
        return (ref_se3.se3_compose(jnp.asarray(T), jnp.asarray(T[::-1])),
                se3.se3_compose(torch.from_numpy(T), torch.from_numpy(T[::-1].copy())))
    if name == "se3_apply":
        return (ref_se3.se3_apply(jnp.asarray(T), jnp.asarray(p)),
                se3.se3_apply(torch.from_numpy(T), torch.from_numpy(p)))
    if name in ("project_points", "project_stereo"):
        ref = getattr(ref_camera, name)(cam_r, jnp.asarray(pc))
        out = getattr(camera, name)(cam_t, torch.from_numpy(pc))
        return np.concatenate([np.asarray(ref[0]).ravel(), np.asarray(ref[1])]), \
            torch.cat([out[0].reshape(-1), out[1]])
    if name == "unproject_depth":
        uv, z = pc[:, :2] * 300 + 320, pc[:, 2]
        return (ref_camera.unproject_depth(cam_r, jnp.asarray(uv), jnp.asarray(z)),
                camera.unproject_depth(cam_t, torch.from_numpy(uv), torch.from_numpy(z)))
    if name == "in_image":
        uv = (rng.uniform(-20, 700, (256, 2))).astype(np.float32)
        return (ref_camera.in_image(cam_r, jnp.asarray(uv), 4.0),
                camera.in_image(cam_t, torch.from_numpy(uv), 4.0))
    if name.startswith("horn_sim3"):
        fix = name.endswith("fixed")
        dst = (1.0 if fix else 1.3) * p @ T[2, :3, :3].T + T[2, :3, 3] \
            + rng.normal(0, 1e-3, p.shape).astype(np.float32)
        ref = ref_align.horn_sim3(jnp.asarray(p), jnp.asarray(dst), fix_scale=fix)
        out = align.horn_sim3(torch.from_numpy(p), torch.from_numpy(dst), fix_scale=fix)
        flat = lambda st: np.concatenate([np.asarray(x).ravel() for x in st])  # noqa: E731
        return flat(ref), torch.from_numpy(flat([x.numpy() for x in out]))
    if name == "alignment_residuals":
        s = np.float32(1.2)
        R, t = T[3, :3, :3], T[3, :3, 3]
        args = (p, p[::-1].copy(), np.asarray(s), R, t)
        return (ref_align.alignment_residuals(*map(jnp.asarray, args)),
                align.alignment_residuals(*map(torch.from_numpy, args)))
    assert name == "exports"
    assert geometry.__all__ == ref_geometry.__all__
    assert all(hasattr(geometry, n) for n in geometry.__all__)
    return np.zeros(1), torch.zeros(1)


@pytest.mark.parametrize("name", ["vee_so3", "se3_compose", "se3_apply", "project_points",
                                  "project_stereo", "unproject_depth", "in_image",
                                  "horn_sim3_fixed", "horn_sim3_scaled",
                                  "alignment_residuals", "exports"])
def test_public_helpers_match_reference(name):
    """The reference's public geometry helpers and `geometry/__init__`'s
    exports in the port: booleans exactly, floats to 1e-5 (the alignment's
    Jacobi polar factor against the SVD: 1e-4; a projection also to 1e-6
    relative, for the point at z = 0 projected through the 1e-9 guard)."""
    ref, out = _helper_case(name)
    ref = np.asarray(ref)
    if ref.dtype == bool:
        np.testing.assert_array_equal(ref, out.numpy())
        assert 0 < ref.sum() < ref.size
    else:
        np.testing.assert_allclose(ref, out.numpy(), rtol=1e-6 if "project" in name else 0,
                                   atol=1e-4 if name.startswith("horn") else ATOL)
