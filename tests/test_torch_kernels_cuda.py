"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skips without a CUDA device (a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it runs on the
machine with the card, where jax is not installed; tests/conftest.py
imports jax, so run it there without the conftest:

    python3 -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from lc_crf_slam_torch.ops import fast_kernel
from lc_crf_slam_torch.ops.fast import fast_score_dual


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (134, 179), (200, 300), (7, 7)])
@pytest.mark.parametrize("kind", ["random", "plateau"])
def test_fast_kernel_bitwise_equals_plain(cuda, shape, kind):
    """Same accumulation order, no multiply to contract: bitwise equal,
    including NMS ties on plateau images and ragged tiles."""
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape) * 255 if kind == "random" else np.round(rng.random(shape) * 3) * 70
    img = torch.tensor(a.astype(np.float32), device=cuda)
    before = fast_kernel.launches
    hi, lo = fast_kernel.fast_score_dual_nms(img, 20.0, 7.0)
    torch.cuda.synchronize()
    assert fast_kernel.launches == before + 1
    ph, pl = fast_score_dual(img, 20.0, 7.0)
    assert torch.equal(hi, ph) and torch.equal(lo, pl)


@pytest.mark.cuda
def test_fast_kernel_refuses_bad_input(cuda):
    img = torch.zeros((32, 32), device=cuda)
    with pytest.raises(ValueError):
        fast_kernel.fast_score_dual_cuda(img.double(), 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_score_dual_cuda(img.t()[:, :16], 20.0, 7.0)


def _pyramid_batch(imgs, n_levels=8):
    from lc_crf_slam_torch.ops.pyramid import build_pyramid_batch

    return build_pyramid_batch(imgs, n_levels, 1.2)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 15])
@pytest.mark.parametrize("shape", [(480, 640), (134, 179), (200, 300), (7, 7)])
@pytest.mark.parametrize("kind", ["random", "plateau"])
def test_batched_map_kernel_bitwise_equals_plain(cuda, batch, shape, kind):
    """Every level of every frame in one launch, both maps laid out as the
    pyramid buffer: bitwise the plain version's, level by level (ragged
    tiles, NMS ties on plateaus, levels smaller than the 3-px border)."""
    rng = np.random.default_rng(sum(shape) + batch)
    a = rng.random((batch,) + shape)
    a = a * 255 if kind == "random" else np.round(a * 3) * 70
    pyr = _pyramid_batch(torch.tensor(a.astype(np.float32), device=cuda))
    before = (fast_kernel.launches, fast_kernel.cell_launches)
    hi, lo = fast_kernel.fast_nms_dual(pyr, 20.0, 7.0)
    torch.cuda.synchronize()
    assert (fast_kernel.launches, fast_kernel.cell_launches) == (before[0] + 1, before[1])
    ph, pl = fast_kernel.fast_nms_dual_plain(pyr, 20.0, 7.0)
    assert hi.shape == lo.shape == pyr.flat.shape
    assert torch.equal(hi, ph) and torch.equal(lo, pl)


@pytest.mark.cuda
def test_batched_map_kernel_refuses_bad_input(cuda):
    """More than 16 levels, more than 65535 frames, a type other than
    float32 and th_hi < th_lo each raise before a launch."""
    from lc_crf_slam_torch.ops.pyramid import PyramidBatch

    pyr = _pyramid_batch(torch.zeros((2, 64, 96), device=cuda), n_levels=3)
    levels17 = PyramidBatch(torch.zeros((1, 17 * 49), device=cuda), ((7, 7),) * 17)
    frames = PyramidBatch(torch.zeros((65536, 49), device=cuda), ((7, 7),))
    before = fast_kernel.launches
    for bad, th in ((levels17, (20.0, 7.0)), (frames, (20.0, 7.0)),
                    (pyr._replace(flat=pyr.flat.double()), (20.0, 7.0)),
                    (pyr._replace(flat=pyr.flat.half()), (20.0, 7.0)),
                    (pyr, (7.0, 20.0)), (pyr._replace(flat=pyr.flat[:, :-1]), (20.0, 7.0))):
        with pytest.raises(ValueError):
            fast_kernel.fast_nms_dual_cuda(bad, *th)
    assert fast_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,batch", [((480, 640), 1), ((480, 640), 3),
                                         ((240, 320), 15), ((131, 77), 2)])
@pytest.mark.parametrize("kind", ["random", "plateau"])
@pytest.mark.parametrize("margin", [19, 0])
def test_fused_cell_kernel_equals_plain(cuda, shape, batch, kind, margin):
    """One launch for all levels of all frames: `best` bitwise, `y` and
    `x` exact, including ties inside a cell (plateau images), all-zero
    cells (the margin band) and ragged last rows and columns of cells."""
    rng = np.random.default_rng(sum(shape) + batch)
    a = rng.random((batch,) + shape)
    a = a * 255 if kind == "random" else np.round(a * 3) * 70
    pyr = _pyramid_batch(torch.tensor(a.astype(np.float32), device=cuda))
    before = (fast_kernel.cell_launches, fast_kernel.launches)
    out = fast_kernel.fast_cell_best(pyr, 20.0, 7.0, 16, margin)
    torch.cuda.synchronize()
    assert (fast_kernel.cell_launches, fast_kernel.launches) == (before[0] + 1, before[1])
    ref = fast_kernel.fast_cell_best_plain(pyr, 20.0, 7.0, 16, margin)
    assert len(out) == len(ref) == 8
    for l, (o, r) in enumerate(zip(out, ref)):
        for name, x, y in zip(("best", "y", "x"), o, r):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y), (l, name)
    assert any(float(o[0].max()) > 0 for o in out)


@pytest.mark.cuda
def test_fused_cell_kernel_refuses_bad_input(cuda):
    pyr = _pyramid_batch(torch.zeros((2, 64, 96), device=cuda), n_levels=3)
    with pytest.raises(ValueError):
        fast_kernel.fast_cell_best_cuda(pyr, 20.0, 7.0, cell=8)
    with pytest.raises(ValueError):
        fast_kernel.fast_cell_best_cuda(pyr, 7.0, 20.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_cell_best_cuda(pyr._replace(flat=pyr.flat.double()), 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_cell_best_cuda(pyr._replace(flat=pyr.flat[:, :-1]), 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_cell_best_cuda(pyr._replace(flat=pyr.flat.cpu()), 20.0, 7.0)


def _same_as_plain(out, ref):
    """Bitwise equal, NaN where the plain version has one (the card's NaN
    bits may differ from the CPU's)."""
    from test_torch_segment_sum import bitwise

    out = out.cpu()
    nan = torch.isnan(ref)
    return torch.equal(torch.isnan(out), nan) and bitwise(
        torch.where(nan, 0.0, out).to(ref.dtype), torch.where(nan, 0.0, ref).to(ref.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hcc_6x6", "g_p_3", "w_6x3_pairs", "sim3_7x7_f64",
                                  "empty", "one_target"])
def test_segment_sum_kernel_equals_plain(cuda, case):
    """The fixed-order segment sum on the card against `index_add_` on CPU
    copies of the same inputs: bitwise (NaN where the plain version has
    one), once with a fresh plan and once with a reused one."""
    from lc_crf_slam_torch.ops import segment_sum as ss
    from test_torch_segment_sum import make_case

    n, idx, vals = make_case(case)
    ref = ss.segment_sum_plain(n, idx, vals)
    plan = ss.segment_plan(idx.to(cuda), n)
    before = ss.launches()
    out = ss.segment_sum(vals.to(cuda), ss.segment_plan(idx.to(cuda), n))
    again = ss.segment_sum(vals.to(cuda), plan)
    torch.cuda.synchronize()
    assert ss.launches() == before + (2 if idx.numel() else 0)
    assert _same_as_plain(out, ref) and _same_as_plain(again, ref)


def _path_shape(name, rng):
    """(targets, idx, values) at the shapes of the paths' sums
    (chip_smoke.py step 16), drawn from a seed: local BA at capacity (32
    cameras of 1024 slots, 4096 points), the whole map (320 keyframes,
    32768 points), the pose graphs' 1152 edge ends over 320 nodes, 8192
    edges on 8192 distinct targets. Unused slots have +-0 rows and target
    point 0, as the BA problems give them."""
    C, P = (32, 4096) if name.startswith("local") else (320, 32768)
    K = 1024
    used = rng.random(C * K) < (0.4 if name.startswith("local") else 0.05)
    e_cam = np.repeat(np.arange(C), K)
    e_pt = np.where(used, rng.integers(0, P, C * K), 0)
    if name.startswith("pose"):
        n, idx, k = 320, rng.integers(0, 320, 1152), {"pose_grad": 6, "pose_D": 36}[name]
        used = rng.random(1152) < 0.9
    elif name.startswith("distinct"):   # every tile 256 runs of one edge each
        n = 8192
        idx, k, used = rng.permutation(n), int(name[-2:]), np.ones(n, bool)
    else:
        n, idx, k = {"local_Hcc": (C, e_cam, 36), "local_Hpp": (P, e_pt, 9),
                     "local_W": (P * C, e_pt * C + e_cam, 18), "map_to_points": (P, e_pt, 3),
                     "map_to_cameras": (C, e_cam, 6)}[name]
    vals = rng.normal(0, 1, (len(idx), k)) * used[:, None]
    dtype = np.float64 if name == "pose_D" else np.float32
    return n, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(vals.astype(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["local_Hcc", "local_Hpp", "local_W", "map_to_points",
                                  "map_to_cameras", "pose_grad", "pose_D", "distinct_18",
                                  "distinct_36"])
def test_segment_sum_kernel_at_the_paths_shapes(cuda, name):
    """The kernel against `index_add_` on CPU copies, bitwise, at the
    shapes of local BA, the whole-map matvecs and the pose graphs, and on
    tiles of 256 one-edge runs (a pair block's shape); one launch a call,
    three calls with one plan over new values each, the last on another
    stream (stale look-back words of a call before would show)."""
    from lc_crf_slam_torch.ops import segment_sum as ss

    rng = np.random.default_rng(len(name))
    n, idx, vals = _path_shape(name, rng)
    plan = ss.segment_plan(idx.to(cuda), n)
    side = torch.cuda.Stream()
    for call in range(3):
        vals = vals[torch.from_numpy(rng.permutation(len(vals)))] if call else vals
        before = ss.launches()
        if call == 2:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = ss.segment_sum(vals.to(cuda), plan)
            torch.cuda.current_stream().wait_stream(side)
        else:
            out = ss.segment_sum(vals.to(cuda), plan)
        torch.cuda.synchronize()
        assert ss.launches() == before + 1
        assert _same_as_plain(out, ss.segment_sum_plain(n, idx, vals)), call


@pytest.mark.cuda
def test_segment_sum_replayed_from_a_graph(cuda):
    """A sum on the look-back path whose plan is made inside a CUDA graph's
    capture, as local BA's are in the mapping step's graph: every replay,
    over new values, gives `index_add_`'s bits (its epochs restart on
    scratch the graph zeroes), and counts one launch on the card; the
    capture counts none."""
    from lc_crf_slam_torch.ops import segment_sum as ss

    rng = np.random.default_rng(19)
    n, idx, vals = _path_shape("local_Hcc", rng)
    assert idx.numel() > ss.SMALL_EDGES
    i, v = idx.to(cuda), vals.to(cuda)
    ss.segment_sum(v, ss.segment_plan(i, n))
    before = ss.launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.segment_sum(v, ss.segment_plan(i, n))
    assert ss.launches() == before
    for replay in range(3):
        vals = vals[torch.from_numpy(rng.permutation(len(vals)))]
        v.copy_(vals.to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert _same_as_plain(out, ss.segment_sum_plain(n, idx, vals)), replay
    assert ss.launches() == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("live", ["every_tile", "sparse"])
def test_segment_sum_kernel_carries_across_more_tiles_than_sms(cuda, dtype, live):
    """One run over 600 tiles (the card has 132 SMs), non-zero rows in
    every tile or in a few, between two other runs; the same plan three
    times in a row over new values, and the CPU model's many-tile case
    with -0, NaN and inf rows."""
    from lc_crf_slam_torch.ops import segment_sum as ss
    from test_torch_segment_sum import long_run_case

    rng = np.random.default_rng(7)
    E = 600 * ss.TILE + 100
    idx = torch.full((E,), 2, dtype=torch.int64)
    idx[:50], idx[-30:] = 0, 5
    plan = ss.segment_plan(idx.to(cuda), 6)
    for call in range(3):
        vals = torch.from_numpy(rng.normal(0, 1, (E, 7))).to(dtype)
        if live == "sparse":
            vals[torch.from_numpy(rng.random(E) < 0.999)] = -0.0
        out = ss.segment_sum(vals.to(cuda), plan)
        assert _same_as_plain(out, ss.segment_sum_plain(6, idx, vals)), call
    n, idx, vals = long_run_case(np.float64 if dtype == torch.float64 else np.float32)
    out = ss.segment_sum(vals.to(cuda), ss.segment_plan(idx.to(cuda), n))
    assert _same_as_plain(out, ss.segment_sum_plain(n, idx, vals))


@pytest.mark.cuda
def test_segment_sum_kernel_refuses_bad_input(cuda):
    from lc_crf_slam_torch.ops import segment_sum as ss

    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    kp = ss.segment_plan(idx, 2).kernel
    with pytest.raises(ValueError):
        ss.segment_sum_cuda(torch.zeros((4, 3), dtype=torch.float16, device=cuda), kp)
    with pytest.raises(ValueError):
        ss.segment_sum_cuda(torch.zeros((4, 65), device=cuda), kp)
    with pytest.raises(ValueError):
        ss.segment_sum_cuda(torch.zeros((3, 3), device=cuda), kp)
    with pytest.raises(ValueError):
        ss.segment_sum_cuda(torch.zeros((3, 4), device=cuda).t(), kp)
    with pytest.raises(ValueError):     # a plan built on the CPU has no kernel plan
        ss.segment_sum(torch.zeros((4, 3), device=cuda), ss.segment_plan(idx.cpu(), 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n_idx", [300, 100_000])
def test_scatter_set_last_write_wins_on_the_card(cuda, n_idx):
    """Duplicate writes to one row: the last one wins on the card as on
    the CPU, so two runs give the same bits."""
    from lc_crf_slam_torch._ops import scatter_set

    rng = np.random.default_rng(n_idx)
    arr = torch.tensor(rng.normal(0, 1, (50, 3)).astype(np.float32))
    idx = torch.tensor(rng.integers(0, 60, n_idx))
    val = torch.tensor(rng.normal(0, 1, (n_idx, 3)).astype(np.float32))
    ref = scatter_set(arr, idx, val)
    for _ in range(3):
        assert torch.equal(scatter_set(arr.to(cuda), idx.to(cuda), val.to(cuda)).cpu(), ref)
