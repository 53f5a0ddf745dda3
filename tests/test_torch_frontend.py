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
from lc_crf_slam_tpu.ops import select as ref_select_mod
from lc_crf_slam_tpu.ops.select import select_keypoints as ref_select
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch._ops import popcount32, u32_to_i32
from lc_crf_slam_torch.models import frame as frame_mod
from lc_crf_slam_torch.models.frame import build_frame, build_frames
from lc_crf_slam_torch.ops import orb, pyramid
from lc_crf_slam_torch.ops.fast_kernel import fast_cell_best, fast_score_dual_nms
from lc_crf_slam_torch.ops.select import cell_best, select_from_cells, select_keypoints

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


def ref_cell_best(hi, lo, cell, margin):
    """The reference's masked `_cell_reduce` + low-threshold fallback
    (lc_crf_slam_tpu/ops/select.py:50-62), before its top-k."""
    hi, lo = jnp.asarray(hi), jnp.asarray(lo)
    H, W = hi.shape
    ys, xs = jnp.mgrid[0:H, 0:W]
    inb = (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)
    b_hi, y_hi, x_hi = ref_select_mod._cell_reduce(jnp.where(inb, hi, 0.0), cell)
    b_lo, y_lo, x_lo = ref_select_mod._cell_reduce(jnp.where(inb, lo, 0.0), cell)
    use_lo = b_hi <= 0.0
    return (jnp.where(use_lo, b_lo, b_hi), jnp.where(use_lo, y_lo, y_hi),
            jnp.where(use_lo, x_lo, x_hi))


def assert_cell_best_equal(hi, lo, cell=16, margin=19):
    ref = ref_cell_best(hi, lo, cell, margin)
    out = cell_best(torch.from_numpy(hi), torch.from_numpy(lo), cell, margin)
    H, W = hi.shape
    assert out[0].shape == (-(-H // cell) * -(-W // cell),)
    for name, a, b in zip(("best", "y", "x"), ref, out):
        assert b.dtype == (torch.float32 if name == "best" else torch.int32)
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    return out


def sparse_scores(shape, density, rng, top=4):
    """Integer scores (many ties inside a cell) on a sparse support."""
    return np.where(rng.random(shape) < density,
                    rng.integers(1, top, shape), 0).astype(np.float32)


# the 8 level shapes of a QVGA pyramid: ragged last rows and columns of
# cells at every level but the first
@pytest.mark.parametrize("shape", pyramid.pyramid_shapes(240, 320, 8, 1.2))
def test_cell_best_exact_on_level_shapes(shape):
    """Exact (best, y, x) per cell: ties inside a cell go to the first
    position in the cell's row-major order, empty cells fall back to the
    low map, and cells that are empty in both give their origin."""
    rng = np.random.default_rng(shape[0])
    hi = sparse_scores(shape, 0.01, rng)
    lo = np.maximum(hi, sparse_scores(shape, 0.03, rng))
    best, y, x = assert_cell_best_equal(hi, lo)
    nx = -(-shape[1] // 16)
    cells = torch.arange(best.shape[0])
    empty = best == 0
    assert empty.any() and (~empty).any()
    assert torch.equal(y[empty], (cells[empty] // nx * 16).to(torch.int32))
    assert torch.equal(x[empty], (cells[empty] % nx * 16).to(torch.int32))


@pytest.mark.parametrize("case", ["all_zero", "constant", "margin_0", "margin_wide",
                                  "cell_8", "hi_only_in_margin"])
def test_cell_best_corner_cases(case):
    rng = np.random.default_rng(11)
    shape, cell, margin = (70, 101), 16, 19
    hi = sparse_scores(shape, 0.02, rng)
    lo = sparse_scores(shape, 0.06, rng)
    if case == "all_zero":
        hi, lo = np.zeros_like(hi), np.zeros_like(lo)
    elif case == "constant":      # every in-margin position ties
        hi, lo = np.full_like(hi, 2.0), np.full_like(lo, 2.0)
    elif case == "margin_0":
        margin = 0
    elif case == "margin_wide":   # 2 * margin >= H: nothing is inside
        margin = 35
    elif case == "cell_8":
        cell = 8
    elif case == "hi_only_in_margin":   # masked high scores must not block the fallback
        hi = np.zeros_like(hi)
        hi[:19] = 3.0
    best, _, _ = assert_cell_best_equal(hi, lo, cell, margin)
    if case in ("all_zero", "margin_wide"):
        assert not best.any()


def test_select_from_cells_batched_equals_per_row():
    rng = np.random.default_rng(5)
    best = torch.from_numpy(sparse_scores((3, 40), 0.5, rng))
    y = torch.from_numpy(rng.integers(0, 99, (3, 40)).astype(np.int32))
    x = torch.from_numpy(rng.integers(0, 99, (3, 40)).astype(np.int32))
    for k in (7, 64):             # 64 > 40 cells: padded slots
        batched = select_from_cells(best, y, x, k)
        for b in range(3):
            for a, c in zip(select_from_cells(best[b], y[b], x[b], k), batched):
                assert a.shape[0] == k and torch.equal(a, c[b])


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


@pytest.fixture(scope="module")
def qvga_batch():
    world = RefWorld(cam=CAM_REF, n_frames=6, n_static=500, n_dynamic=0, seed=5)
    imgs = [render(world, k) for k in (2, 3, 5)]
    return (torch.from_numpy(np.stack([g for g, _ in imgs])),
            torch.from_numpy(np.stack([d for _, d in imgs])))


def test_build_pyramid_batch_equals_per_frame(qvga_batch):
    """The batch rides a leading dimension of the two resize products:
    every level of every frame is bitwise what build_pyramid gives."""
    grays, _ = qvga_batch
    pyr = pyramid.build_pyramid_batch(grays, 8, 1.2)
    assert pyr.flat.is_contiguous() and pyr.flat.shape[0] == 3
    for b in range(3):
        for l, lvl in enumerate(pyramid.build_pyramid(grays[b], 8, 1.2)):
            assert torch.equal(pyr.level(l)[b], lvl), (b, l)
            assert pyr.level(l)[b].is_contiguous()


def test_build_frames_equals_build_frame(qvga_batch):
    """Exact: the batched front-end gives each frame what build_frame
    gives it alone."""
    grays, depths = qvga_batch
    frames = build_frames(CAM, SLICE_CFG, grays, depths)
    assert len(frames) == 3
    for b, fr in enumerate(frames):
        one = build_frame(CAM, SLICE_CFG, grays[b], depths[b])
        for f in fr._fields:
            assert torch.equal(getattr(fr, f), getattr(one, f)), (b, f)
        assert int(fr.valid.sum()) > 300


def test_fused_cells_equal_selection_from_score_maps(qvga_batch):
    """The plain version of the fused kernel (what the CPU runs) against
    the two-step path it replaces: score maps, then select_keypoints."""
    grays, _ = qvga_batch
    orb = SLICE_CFG.orb
    pyr = pyramid.build_pyramid_batch(grays[:1], orb.n_levels, orb.scale_factor)
    cells = fast_cell_best(pyr, float(orb.ini_th_fast), float(orb.min_th_fast),
                           orb.cell_size, orb.edge_margin)
    quotas = pyramid.features_per_level(orb.max_keypoints, orb.n_levels, orb.scale_factor)
    levels = pyramid.build_pyramid(grays[0], orb.n_levels, orb.scale_factor)
    for l, img in enumerate(levels):
        hi, lo = fast_score_dual_nms(img, float(orb.ini_th_fast), float(orb.min_th_fast))
        ref = select_keypoints(hi, lo, quotas[l], orb.cell_size, orb.edge_margin)
        out = select_from_cells(*(t[0] for t in cells[l]), quotas[l])
        for a, b in zip(ref, out):
            assert torch.equal(a, b), l


def _direct(cfg):
    import dataclasses

    return cfg.replace(orb=dataclasses.replace(cfg.orb, descriptor_variant="direct"))


def test_direct_descriptors_match_reference(qvga_frames):
    """The "direct" variant on the reference's level-0 image and keypoints
    of the QVGA frame: angles to 1e-3 rad (the moment sums run in another
    order); fed the reference's angles, the descriptors are bitwise the
    reference's; with their own angles at least 99% are identical and none
    is more than 2 bits apart (a rotated sample lands on the other side of
    a pixel's rounding edge)."""
    ref, _ = qvga_frames
    gray = jnp.asarray(render(RefWorld(cam=CAM_REF, n_frames=6, n_static=500,
                                       n_dynamic=0, seed=5), 2)[0])
    at0 = np.asarray(ref.valid) & (np.asarray(ref.level) == 0)
    uv = np.asarray(ref.uv)[at0].astype(np.int32)
    a_ref = np.asarray(ref_orb.ic_angles(gray, jnp.asarray(uv)))
    d_ref = u32_to_i32(np.asarray(ref_orb.brief_descriptors_direct(
        ref_pyramid.gaussian_blur(gray, 7, 2.0), jnp.asarray(uv), jnp.asarray(a_ref))))
    img, uv_t = torch.from_numpy(np.asarray(gray)), torch.from_numpy(uv)
    angles = orb.ic_angles(img, uv_t)
    np.testing.assert_allclose(angles.numpy(), a_ref, atol=1e-3)
    blurred = pyramid.gaussian_blur(img, 7, 2.0)
    np.testing.assert_array_equal(
        orb.brief_descriptors_direct(blurred, uv_t, torch.from_numpy(a_ref)).numpy(), d_ref)
    _, desc = frame_mod.orient_and_describe(_direct(SLICE_CFG), img, uv_t)
    ham = popcount32(torch.from_numpy(d_ref) ^ desc).sum(-1).numpy()
    assert len(ham) > 200 and np.mean(ham == 0) >= 0.99 and ham.max() <= 2, (
        len(ham), np.mean(ham == 0), ham.max())


def test_matmul_variant_agreement_with_direct():
    """The reference's bit-agreement golden (tests/test_frontend.py,
    `test_matmul_variant_agreement_with_direct`) on the port's two
    variants, at the reference's bar: median cross-variant Hamming under
    TH_LOW - 20, the worst under TH_LOW."""
    from lc_crf_slam_torch.config import SLAMConfig

    cfg = SLAMConfig()
    rng = np.random.default_rng(9)
    img = pyramid.gaussian_blur(torch.from_numpy(
        (rng.random((160, 160)) * 255).astype(np.float32)), 5, 1.2)
    uv = torch.from_numpy(np.stack([rng.integers(50, 110, 32),
                                    rng.integers(50, 110, 32)], -1).astype(np.int32))
    _, d_dir = frame_mod.orient_and_describe(_direct(cfg), img, uv)
    _, d_mm = frame_mod.orient_and_describe(cfg, img, uv)
    cross = popcount32(d_dir ^ d_mm).sum(-1).numpy()
    assert np.median(cross) < cfg.matcher.th_low - 20, np.median(cross)
    assert cross.max() < cfg.matcher.th_low, cross.max()


@pytest.mark.parametrize("name", ["fast_score_map", "level_scales"])
def test_frontend_helpers_match_reference(name):
    """`ops/fast.fast_score_map` (the score before NMS; 1e-3 graylevels: the
    port adds the 16 margins in circle order, the reference with a sum)
    and `ops/pyramid.level_scales` (exactly)."""
    from lc_crf_slam_tpu.ops import fast as ref_fast
    from lc_crf_slam_torch.ops import fast

    if name == "fast_score_map":
        ref = np.asarray(ref_fast.fast_score_map(jnp.asarray(IMG), 20.0))
        out = fast.fast_score_map(torch.from_numpy(IMG), 20.0).numpy()
        np.testing.assert_allclose(ref, out, atol=1e-3, rtol=0)
        assert (ref > 0).sum() > 100
        np.testing.assert_array_equal(ref > 0, out > 0)
    else:
        ref = np.asarray(ref_pyramid.level_scales(8, 1.2))
        out = pyramid.level_scales(8, 1.2)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(ref, out.numpy())


def test_pan_world_descriptor_flips_come_from_the_angle():
    """The first output that differs between the packages on equal inputs
    in the per-frame run of the QVGA pan world (tests/test_torch_loop_close.py::
    test_pan_loop_closes_as_reference_per_frame): `build_frame` on frame
    0. Keypoints agree exactly and level 0 bitwise; the intensity-centroid
    angle, an atan2 of two cancelling 961-term float32 moment sums taken in
    another order, differs by ~1e-5 rad, and where that moves a steered
    BRIEF sample across a comparison one descriptor bit flips (2 of 669
    keypoints). Fed the reference's level image and angle, the port's
    descriptor is bitwise the reference's at every such keypoint."""
    from lc_crf_slam_tpu.config import SLAMConfig

    cfg, orb_cfg = SLAMConfig(), SLAMConfig().orb
    world = RefWorld(cam=CAM_REF, n_frames=130, n_static=900, n_dynamic=0, seed=5,
                     trajectory="pan", wall=True, pan_leadin=0.1, pan_turns=1.2,
                     pan_translation=0.25, render_depth_noise=0.015)
    gray, depth = render(world, 0)
    ref = jax.jit(ref_build_frame, static_argnums=(0, 1))(
        CAM_REF, cfg, jnp.asarray(gray), jnp.asarray(depth))
    out = build_frame(CAM, cfg, torch.from_numpy(gray), torch.from_numpy(depth))
    np.testing.assert_array_equal(np.asarray(ref.uv), out.uv.numpy())
    levels = ref_pyramid.build_pyramid(jnp.asarray(gray), orb_cfg.n_levels,
                                       orb_cfg.scale_factor)
    v = out.valid.numpy()
    np.testing.assert_allclose(np.asarray(ref.angle)[v], out.angle.numpy()[v], atol=1e-4)
    ref_desc = u32_to_i32(np.asarray(ref.desc))
    ham = popcount32(torch.from_numpy(ref_desc) ^ out.desc).sum(-1).numpy()
    flipped = np.nonzero(ham)[0]
    print(len(flipped), "of", int(v.sum()), "descriptors differ, by", ham[flipped], "bits")
    assert 0 < len(flipped) <= 0.01 * v.sum() and ham.max() == 1, ham[flipped]
    for i in flipped:
        lvl = int(out.level[i])
        img = torch.from_numpy(np.asarray(levels[lvl]))
        uv_l = torch.from_numpy(np.round(np.asarray(ref.uv)[i] / orb_cfg.scale_factor**lvl))
        patch = orb._gather_patches(img, uv_l.long()[None], orb.PATCH_MARGIN + 3)
        desc = orb.brief_descriptors_matmul(patch, torch.from_numpy(np.asarray(ref.angle)[i:i + 1]))
        np.testing.assert_array_equal(desc.numpy()[0], ref_desc[i])
