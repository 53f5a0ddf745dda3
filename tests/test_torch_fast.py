"""FAST+NMS: the port's plain version against the reference and the
wrapper's device routing. The CUDA kernel itself is tested on the card
by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lc_crf_slam_tpu.ops.fast import fast_score_dual as ref_fast_score_dual
from lc_crf_slam_tpu.ops.pallas_fast import fast_score_dual_pallas
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch.ops import fast_kernel
from lc_crf_slam_torch.ops.fast import fast_score_dual

from torch_parity import CAM_REF, render


def _images():
    rng = np.random.default_rng(21)
    world = RefWorld(cam=CAM_REF, n_frames=2, n_static=200, n_dynamic=0)
    return {
        "random": (rng.random((96, 130)) * 255).astype(np.float32),
        "plateau": (np.round(rng.random((61, 77)) * 3) * 70).astype(np.float32),
        "rendered": render(world, 0)[0],
    }


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_plain_equals_reference_fast(name):
    """Same accumulation order, no contraction: bitwise equal."""
    img = IMAGES[name]
    ref = ref_fast_score_dual(jnp.asarray(img), 20, 7)
    out = fast_score_dual(torch.from_numpy(img), 20.0, 7.0)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["random", "rendered"])
def test_plain_vs_pallas_interpret(name):
    """The Pallas kernel edge-pads where fast.py rolls, so the two agree
    away from a 5-px border, at the tolerance of
    tests/test_pallas_kernels.py (atol 1e-2)."""
    img = IMAGES[name]
    ref = fast_score_dual_pallas(jnp.asarray(img), 20.0, 7.0, interpret=True)
    out = fast_score_dual(torch.from_numpy(img), 20.0, 7.0)
    s = np.s_[5:-5, 5:-5]
    for a, b in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a)[s], b.numpy()[s], atol=1e-2)


def test_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    img = torch.from_numpy(IMAGES["random"])
    before = fast_kernel.launches
    hi, lo = fast_kernel.fast_score_dual_nms(img, 20.0, 7.0)
    ph, pl = fast_score_dual(img, 20.0, 7.0)
    assert torch.equal(hi, ph) and torch.equal(lo, pl)
    assert fast_kernel.launches == before


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain path; anything else raises (a CUDA
    tensor goes to the kernel or raises, never to the plain path)."""
    meta = torch.empty((32, 32), device="meta")
    with pytest.raises(ValueError):
        fast_kernel.fast_score_dual_nms(meta, 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_score_dual_cuda(torch.from_numpy(IMAGES["random"]), 20.0, 7.0)


def test_fused_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    from lc_crf_slam_torch.ops.pyramid import build_pyramid_batch

    pyr = build_pyramid_batch(torch.from_numpy(IMAGES["random"])[None], 3, 1.2)
    before = (fast_kernel.cell_launches, fast_kernel.launches)
    out = fast_kernel.fast_cell_best(pyr, 20.0, 7.0)
    ref = fast_kernel.fast_cell_best_plain(pyr, 20.0, 7.0)
    assert len(out) == 3
    for o, r in zip(out, ref):
        assert all(torch.equal(a, b) for a, b in zip(o, r))
        assert o[0].shape[0] == 1 and o[0].dtype == torch.float32
        assert o[1].dtype == o[2].dtype == torch.int32
    assert (fast_kernel.cell_launches, fast_kernel.launches) == before


def test_fused_wrapper_refuses_other_devices():
    """As the map kernel's wrapper: only a CPU buffer takes the plain
    path, and the kernel entry refuses a CPU buffer."""
    from lc_crf_slam_torch.ops.pyramid import PyramidBatch, build_pyramid_batch

    meta = PyramidBatch(torch.empty((1, 32 * 32), device="meta"), ((32, 32),))
    with pytest.raises(ValueError):
        fast_kernel.fast_cell_best(meta, 20.0, 7.0)
    pyr = build_pyramid_batch(torch.from_numpy(IMAGES["random"])[None], 2, 1.2)
    with pytest.raises(ValueError):
        fast_kernel.fast_cell_best_cuda(pyr, 20.0, 7.0)


def test_batched_map_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    """The map kernel's batched entry on a CPU buffer: the plain version,
    each level of each frame `fast_score_dual`'s maps at its place in the
    pyramid buffer's layout; no launch counted; other devices refused."""
    from lc_crf_slam_torch.ops.pyramid import PyramidBatch, build_pyramid_batch

    imgs = torch.from_numpy(np.stack([IMAGES["random"], IMAGES["random"][::-1].copy()]))
    pyr = build_pyramid_batch(imgs, 3, 1.2)
    before = (fast_kernel.launches, fast_kernel.cell_launches)
    hi, lo = fast_kernel.fast_nms_dual(pyr, 20.0, 7.0)
    assert (fast_kernel.launches, fast_kernel.cell_launches) == before
    assert hi.shape == lo.shape == pyr.flat.shape
    for l, (h, w) in enumerate(pyr.shapes):
        off = pyr.offsets[l]
        for b in range(2):
            ph, pl = fast_score_dual(pyr.level(l)[b], 20.0, 7.0)
            assert torch.equal(hi[b, off: off + h * w].view(h, w), ph)
            assert torch.equal(lo[b, off: off + h * w].view(h, w), pl)
    meta = PyramidBatch(torch.empty((1, 32 * 32), device="meta"), ((32, 32),))
    with pytest.raises(ValueError):
        fast_kernel.fast_nms_dual(meta, 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_nms_dual_cuda(pyr, 20.0, 7.0)
