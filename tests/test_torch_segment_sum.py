"""The fixed-order segment sum (lc_crf_slam_torch/ops/segment_sum.py) on
the CPU: the wrapper against `index_add_`, bitwise, at the shapes of the
port's edge sums, and the plan walked as csrc/segment_sum.cu walks it (each
target's run of sorted positions in order, all-zero rows skipped) against
`index_add_`, bitwise. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).

Inputs are made with numpy from a seed. A share of the rows is set to +0
and -0, as the masked edges of BA give them, and one row of one case holds a NaN."""

import numpy as np
import pytest
import torch

from lc_crf_slam_torch.ops.segment_sum import (segment_plan, segment_sum,
                                               segment_sum_plain, sorted_runs)

# (edges, per-edge block shape, targets, dtype, how the targets are drawn)
CASES = {
    "hcc_6x6": (32768, (6, 6), 32, np.float32, "uniform"),
    "g_p_3": (32768, (3,), 4096, np.float32, "uniform"),
    "w_6x3_pairs": (8192, (6, 3), 4096 * 32, np.float32, "uniform"),   # most empty
    "sim3_7x7_f64": (4000, (7, 7), 1000, np.float64, "uniform"),
    "empty": (0, (6,), 7, np.float32, "uniform"),
    "one_target": (20000, (6,), 5, np.float32, "one"),
}


def make_case(name, seed=0):
    E, block, n, dtype, how = CASES[name]
    rng = np.random.default_rng([seed, len(name)])
    idx = rng.integers(0, n, E) if how == "uniform" else np.full(E, 3)
    vals = rng.normal(0, 1, (E,) + block).astype(dtype)
    if E:
        zero = rng.random(E) < 0.3
        vals[zero] = 0.0
        vals[zero & (rng.random(E) < 0.5)] = -0.0
        if name == "g_p_3":
            vals[E // 2, 0] = np.nan
    return n, torch.from_numpy(idx), torch.from_numpy(vals)


def walk_plan(plan, vals):
    """csrc/segment_sum.cu's fold on the CPU over the sorted runs of the
    plan's targets: every target's run of sorted positions added in order
    from +0, rows of +-0 skipped. Vectorised over the runs: step r adds the
    r-th live row of every run that has one."""
    n, plan = plan.n, sorted_runs(plan.idx)
    E = vals.shape[0]
    flat = vals.reshape(E, int(np.prod(vals.shape[1:])))
    out = torch.zeros((n, flat.shape[1]), dtype=vals.dtype)
    if E == 0:
        return out.reshape((n,) + tuple(vals.shape[1:]))
    live = (flat[plan.perm] != 0).any(dim=1)
    pos = torch.arange(E)
    start = torch.cummax(torch.where(plan.head.bool(), pos, 0), 0).values
    assert torch.equal(plan.end[start], plan.end)
    # the rank of each live position among its run's live positions
    csum = torch.cumsum(live.long(), 0)
    rank = csum - 1 - torch.where(start > 0, csum[start - 1], 0)
    acc = out
    for r in range(int(rank[live].max()) + 1 if live.any() else 0):
        sel = live & (rank == r)
        acc[plan.sorted_idx[sel]] = acc[plan.sorted_idx[sel]] + flat[plan.perm[sel]]
    return acc.reshape((n,) + tuple(vals.shape[1:]))


def bitwise(a, b):
    """Equal bits, NaN included."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_bitwise_equals_index_add(case):
    n, idx, vals = make_case(case)
    ref = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype).index_add_(
        0, idx, vals)
    plan = segment_plan(idx, n)
    assert plan.runs is None        # on the CPU index_add_ needs no sorted runs
    out = segment_sum(vals, plan)
    assert bitwise(out, ref) and bitwise(segment_sum_plain(n, idx, vals), ref)
    # the kernel's runs: a stable sort, run heads, run ends
    runs = sorted_runs(plan.idx)
    assert torch.equal(runs.sorted_idx, idx[runs.perm])
    for t in torch.unique(idx)[:50]:
        run = runs.perm[runs.sorted_idx == t]
        assert torch.equal(run, torch.sort(run).values)
    assert int(runs.head.sum()) == torch.unique(idx).numel()
    # the kernel's walk of the plan gives index_add_'s bits
    assert bitwise(walk_plan(plan, vals), ref)
    if case == "w_6x3_pairs":
        assert (ref.reshape(n, -1) != 0).any(dim=1).float().mean() < 0.1


def test_reused_plan_gives_the_same_bits():
    """One plan, built once, serves every sum over its index vector: the
    sums over new values with it equal those with a fresh plan and
    index_add_'s."""
    n, idx, vals = make_case("hcc_6x6")
    plan = segment_plan(idx, n)
    for seed in (1, 2):
        _, _, other = make_case("hcc_6x6", seed)
        ref = torch.zeros((n, 6, 6)).index_add_(0, idx, other)
        assert bitwise(walk_plan(plan, other), ref)
        assert bitwise(walk_plan(segment_plan(idx, n), other), ref)
        assert bitwise(segment_sum(other, plan), ref)
