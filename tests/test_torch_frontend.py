"""Front-end parity: pyramid, blur, keypoint selection, the BRIEF
constants, and build_frame on a rendered QVGA frame."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.models.frame import build_frame as ref_build_frame
from lc_crf_slam_tpu.ops import orb as ref_orb
from lc_crf_slam_tpu.ops import pyramid as ref_pyramid
from lc_crf_slam_tpu.ops.select import select_keypoints as ref_select
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch._ops import popcount32, u32_to_i32
from lc_crf_slam_torch.models.frame import build_frame
from lc_crf_slam_torch.ops import orb, pyramid
from lc_crf_slam_torch.ops.select import select_keypoints

from torch_parity import CAM, CAM_REF, SLICE_CFG, render

RNG = np.random.default_rng(3)
IMG = (RNG.random((240, 320)) * 255).astype(np.float32)


def test_pyramid_shapes_and_quotas():
    assert pyramid.pyramid_shapes(480, 640, 8, 1.2) == ref_pyramid.pyramid_shapes(
        480, 640, 8, 1.2)
    assert pyramid.features_per_level(1024, 8, 1.2) == ref_pyramid.features_per_level(
        1024, 8, 1.2)


def test_build_pyramid():
    """Same separable antialiased weights as jax.image.resize (to one ulp);
    the chained levels agree to 1e-3 graylevels (F.interpolate without
    antialias would differ by ~70)."""
    ref = ref_pyramid.build_pyramid(jnp.asarray(IMG), 8, 1.2)
    out = pyramid.build_pyramid(torch.from_numpy(IMG), 8, 1.2)
    for a, b in zip(ref, out):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3, rtol=0)


def test_gaussian_blur_exact():
    ref = ref_pyramid.gaussian_blur(jnp.asarray(IMG), 7, 2.0)
    np.testing.assert_array_equal(np.asarray(ref),
                                  pyramid.gaussian_blur(torch.from_numpy(IMG)).numpy())


@pytest.mark.parametrize("k", [40, 400])
def test_select_keypoints_exact(k):
    """Identical score maps with many ties (integer scores, empty cells
    falling back to the low map): identical uv, scores and validity."""
    hi = np.where(RNG.random((130, 170)) < 0.02,
                  RNG.integers(1, 4, (130, 170)), 0).astype(np.float32)
    lo = np.where(RNG.random((130, 170)) < 0.05,
                  RNG.integers(1, 4, (130, 170)), 0).astype(np.float32)
    ref = ref_select(jnp.asarray(hi), jnp.asarray(lo), k)
    out = select_keypoints(torch.from_numpy(hi), torch.from_numpy(lo), k)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_brief_constants_equal():
    np.testing.assert_array_equal(orb.brief_pattern(), ref_orb.brief_pattern())
    np.testing.assert_array_equal(orb._brief_bin_matrix(), ref_orb._brief_bin_matrix())


def test_pack_unpack_bits():
    bits = RNG.random((17, 256)) < 0.5
    ref = np.asarray(ref_orb.pack_bits(jnp.asarray(bits)))
    out = orb.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(u32_to_i32(ref), out.numpy())
    np.testing.assert_array_equal(orb.unpack_bits(out).numpy(), bits)


@pytest.fixture(scope="module")
def qvga_frames():
    world = RefWorld(cam=CAM_REF, n_frames=6, n_static=500, n_dynamic=0, seed=5)
    gray, depth = render(world, 2)
    ref = jax.jit(ref_build_frame, static_argnums=(0, 1))(
        CAM_REF, SLICE_CFG, jnp.asarray(gray), jnp.asarray(depth))
    out = build_frame(CAM, SLICE_CFG, torch.from_numpy(gray), torch.from_numpy(depth))
    return ref, out


def test_build_frame_keypoints_exact(qvga_frames):
    """Same keypoints at every level (uv, level, validity, depth)."""
    ref, out = qvga_frames
    for f in ("uv", "level", "valid", "depth"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(out, f).numpy(), err_msg=f)
    assert int(out.valid.sum()) > 300


def test_build_frame_angles_and_descriptors(qvga_frames):
    """Angles to 1e-3 rad (the moment sums run in another order); the
    descriptor bits threshold a 1521-term dot product at 0.1, so a bit
    may flip where the sample difference sits at that threshold: at
    least 99% of descriptors identical, none more than 8 bits apart
    (the matcher's TH_LOW is 50)."""
    ref, out = qvga_frames
    v = out.valid.numpy()
    np.testing.assert_allclose(np.asarray(ref.angle)[v], out.angle.numpy()[v], atol=1e-3)
    ref_desc = torch.from_numpy(u32_to_i32(np.asarray(ref.desc)))
    ham = popcount32(ref_desc ^ out.desc).sum(-1).numpy()[v]
    assert ham.max() <= 8, ham.max()
    assert np.mean(ham == 0) >= 0.99
