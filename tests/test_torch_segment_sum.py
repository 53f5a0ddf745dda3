"""The fixed-order segment sum (lc_crf_slam_torch/ops/segment_sum.py) on
the CPU: the wrapper against `index_add_`, bitwise, at the shapes of the
port's edge sums, and a plain-torch model of csrc/segment_sum.cu's
schedule over the kernel's plan against `index_add_`, bitwise. The kernel
itself runs only on the card (tests/test_torch_kernels_cuda.py).

Inputs are made with numpy from a seed. A share of the rows is set to +0
and -0, as the masked edges of BA give them, and one row of one case holds
a NaN."""

import os

import numpy as np
import pytest
import torch

from lc_crf_slam_torch.ops.segment_sum import (OWN, SMALL_EDGES, TILE, kernel_plan,
                                               segment_plan, segment_sum,
                                               segment_sum_plain)

# (edges, per-edge block shape, targets, dtype, how the targets are drawn)
CASES = {
    "hcc_6x6": (32768, (6, 6), 32, np.float32, "uniform"),
    "g_p_3": (32768, (3,), 4096, np.float32, "uniform"),
    "w_6x3_pairs": (8192, (6, 3), 4096 * 32, np.float32, "uniform"),   # most empty
    "sim3_7x7_f64": (4000, (7, 7), 1000, np.float64, "uniform"),
    "empty": (0, (6,), 7, np.float32, "uniform"),
    "one_target": (20000, (6,), 5, np.float32, "one"),
}
BA_MAP = os.path.join(os.path.dirname(__file__), "data", "loop_per_frame_ba_map.npz")


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


def model_kernel(idx, n, vals, seed=0):
    """csrc/segment_sum.cu's schedule on the CPU over `kernel_plan(idx,
    n)`. Up to SMALL_EDGES edges (`owned_kernel`): each block folds the runs
    whose heads lie in its OWN positions, every row in order, to their
    ends. Above (`tile_kernel`): one block a tile of TILE sorted positions,
    each publishing the carry of the run it leaves open (or that its rows
    of it are all +-0: pass, or +0 from its start); the blocks run as
    coroutines in a random order, and one that needs a carry looks back
    over the tiles that passed and waits (yields) while the one it needs is
    unpublished; each run folds its non-zero rows in sorted order from its
    carry. Then the zero-filling blocks. Asserts that every target is
    written exactly once; returns (out, {"tiles", "passed", "waits"})."""
    kp = kernel_plan(idx, n)
    E = kp.E
    flat = vals.reshape(E, int(np.prod(vals.shape[1:])))
    k = flat.shape[1]
    perm, tgt = kp.perm.long(), kp.tgt.long()
    out = torch.full((n, k), float("nan"), dtype=vals.dtype)   # torch.empty's stand-in
    writes = torch.zeros(n, dtype=torch.int64)
    stats = {"tiles": 0, "passed": 0, "waits": 0}
    zero = torch.zeros(k, dtype=vals.dtype)

    def write(t, acc):
        out[t] = acc
        writes[t] += 1

    def fold(rows, acc):
        for row in rows:
            acc = acc + row
        return acc

    if kp.own is not None:
        covered = torch.zeros(E, dtype=torch.int64)
        for lo, hi in kp.own.tolist():          # one block each
            covered[lo:hi] += 1
            t = tgt[lo:hi].tolist()
            starts = [i for i in range(hi - lo) if i == 0 or t[i] != t[i - 1]] + [hi - lo]
            for a, b_ in zip(starts, starts[1:]):
                write(t[a], fold(flat[perm[lo + a:lo + b_]], zero))
        assert bool((covered == 1).all())       # every position owned by one block
    else:
        status = [None] * -(-E // TILE)         # None: not published yet

        def look_back(i):
            """The carry into tile i, or None while it is unpublished."""
            j = i - 1
            while status[j] is not None and status[j][0] == "pass":
                j -= 1
                assert j >= 0                   # the run's first tile never passes
            if status[j] is None:
                return None
            return status[j][1] if status[j][0] == "carry" else zero

        def block(i):
            stats["tiles"] += 1
            p0 = i * TILE
            L = min(TILE, E - p0)
            t = tgt[p0:p0 + L].tolist()
            rows = flat[perm[p0:p0 + L]]
            live = (rows != 0).any(dim=1)
            starts = [0] + [j for j in range(1, L) if t[j] != t[j - 1]] + [L]
            segs = [(t[a], rows[a:b_][live[a:b_]]) for a, b_ in zip(starts, starts[1:])]
            cont_in = p0 > 0 and int(tgt[p0 - 1]) == t[0]
            cont_out = p0 + L < E and int(tgt[p0 + L]) == t[L - 1]
            one = len(segs) == 1
            if cont_out and not (cont_in and one):      # (a) the last run, from +0
                live_rows = segs[-1][1]
                status[i] = ("carry", fold(live_rows, zero)) if len(live_rows) else ("zero",)
            for s in range(1 if cont_in else 0, len(segs) - 1 if cont_out else len(segs)):
                write(segs[s][0], fold(segs[s][1], zero))   # (b)
            if cont_in:                                 # (c) the first run, from its carry
                goes_on = cont_out and one
                if not len(segs[0][1]) and goes_on:
                    status[i] = ("pass",)
                    stats["passed"] += 1
                else:
                    while (cin := look_back(i)) is None:
                        stats["waits"] += 1
                        yield
                    acc = fold(segs[0][1], cin)
                    if goes_on:
                        status[i] = ("carry", acc)
                    else:
                        write(segs[0][0], acc)

        running = [block(i) for i in range(len(status))]
        rng = np.random.default_rng(seed)
        while running:
            waiting = []
            for j in rng.permutation(len(running)):
                try:
                    next(running[j])
                    waiting.append(running[j])
                except StopIteration:
                    pass
            assert len(waiting) < len(running)    # someone always gets on
            running = waiting
    # the zero-filling blocks: every target whose bit is clear
    clear = ((kp.hit[:, None] >> torch.arange(64)) & 1 == 0).reshape(-1)[:n]
    out[clear] = 0
    writes += clear
    assert bool((writes == 1).all())
    return out, stats


def bitwise(a, b):
    """Equal bits, NaN included."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def reference(n, idx, vals):
    return torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype).index_add_(
        0, idx, vals)


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_bitwise_equals_index_add(case):
    n, idx, vals = make_case(case)
    ref = reference(n, idx, vals)
    plan = segment_plan(idx, n)
    assert plan.kernel is None      # on the CPU index_add_ needs no kernel plan
    out = segment_sum(vals, plan)
    assert bitwise(out, ref) and bitwise(segment_sum_plain(n, idx, vals), ref)
    # the kernel's plan: a stable sort and the bits of the targets hit
    kp = kernel_plan(idx, n)
    assert torch.equal(kp.tgt.long(), idx[kp.perm.long()])
    for t in torch.unique(idx)[:50]:
        run = kp.perm[kp.tgt == t]
        assert torch.equal(run, torch.sort(run).values)
    bits = (kp.hit[:, None] >> torch.arange(64)) & 1
    assert torch.equal(bits.reshape(-1)[:n].bool(),
                       torch.zeros(n, dtype=torch.bool).index_fill_(0, idx, True))
    assert (kp.own is None) == (idx.numel() > SMALL_EDGES)
    if kp.span is not None:     # a span tile's edges are consecutive ids from its first
        for i in range(len(kp.span)):
            tile = kp.perm[i * TILE:(i + 1) * TILE].long()
            is_span = bool((tile == tile[0] + torch.arange(len(tile))).all())
            assert int(kp.span[i]) == (int(tile[0]) if is_span else -1)
    # the kernel's schedule gives index_add_'s bits
    assert bitwise(model_kernel(idx, n, vals)[0].reshape(ref.shape), ref)
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
        assert bitwise(model_kernel(idx, n, other, seed)[0].reshape(ref.shape), ref)
        assert bitwise(segment_sum(other, plan), ref)


def long_run_case(dtype):
    """One run of target 3 over 40 tiles, its rows +-0 but in tiles 0, 5,
    6, 20 and 39 (one tile of it live throughout), with NaN, +inf and -inf
    rows; runs of other targets cut into it at tiles 10 and 30."""
    rng = np.random.default_rng(9)
    E = 40 * TILE + 17
    idx = np.full(E, 3)
    idx[10 * TILE + 5:10 * TILE + 60] = rng.integers(0, 9, 55)
    idx[30 * TILE:31 * TILE] = 7
    vals = np.zeros((E, 5), dtype=dtype)
    vals[rng.random(E) < 0.5] = -0.0
    for tile, share in ((0, 0.1), (5, 0.02), (6, 1.0), (20, 0.05), (39, 0.3)):
        rows = tile * TILE + np.flatnonzero(rng.random(TILE) < share)
        vals[rows] = rng.normal(0, 1, (len(rows), 5))
    vals[20 * TILE + 3, 1] = np.inf
    vals[39 * TILE + 1, 1] = -np.inf            # inf - inf: NaN from there on
    vals[6 * TILE + 7, 4] = np.nan
    vals[10 * TILE + 20] = rng.normal(0, 1, 5)  # a live row of another run
    return 10, torch.from_numpy(idx), torch.from_numpy(vals)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_schedule_carries_across_many_tiles(dtype, seed):
    """A run across 40 tiles: the tiles whose rows of it are all +-0 pass
    the carry on, the live ones fold from it, in two random orders of the
    tiles; -0, NaN and inf rows as index_add_ adds them."""
    n, idx, vals = long_run_case(dtype)
    ref = reference(n, idx, vals)
    out, stats = model_kernel(idx, n, vals, seed)
    assert bitwise(out, ref)
    assert torch.isnan(ref[3, 1]) and torch.isnan(ref[3, 4])
    assert stats["tiles"] == 41 and stats["passed"] >= 30 and stats["waits"] > 0


def test_owned_runs_path_for_small_problems():
    """Up to SMALL_EDGES edges a block owns the runs that start in its OWN
    positions and folds them to their end, past the OWN where a run
    reaches further; at most OWN edges, one block. The blocks own disjoint
    ranges that cover every position."""
    rng = np.random.default_rng(4)
    for E, n in ((30, 9), (200, 40), (1152, 320), (SMALL_EDGES, 3)):
        idx = torch.from_numpy(rng.integers(0, n, E))
        vals = torch.from_numpy(rng.normal(0, 1, (E, 6)).astype(np.float32))
        vals[rng.random(E) < 0.3] = -0.0
        kp = kernel_plan(idx, n)
        assert kp.own.shape == (-(-E // OWN), 2) and kp.status is None
        assert bitwise(model_kernel(idx, n, vals)[0], reference(n, idx, vals))
        if n == 3:      # runs of ~1365 edges: most blocks own nothing
            assert int((kp.own[:, 1] > kp.own[:, 0]).sum()) == 3


@pytest.mark.parametrize("which", ["camera", "point"])
def test_schedule_on_the_loop_maps_index_vectors(which):
    """The camera and point targets of the whole-map BA over the map the
    card hands its first global-BA slice (tests/data/
    loop_per_frame_ba_map.npz: 34 keyframes of 1024 slots, 10134 points),
    the unobserved slots' rows +-0 and their targets 0, as
    `_map_ba_problem` gives them."""
    z = np.load(BA_MAP)
    F, K = z["kf_obs"].shape
    valid = (z["kf_alive"][:, None] & z["kf_valid"] & (z["kf_obs"] >= 0)).reshape(-1)
    if which == "camera":
        idx, n = np.repeat(np.arange(F), K), F
    else:
        idx, n = np.clip(z["kf_obs"], 0, None).reshape(-1), len(z["p_xyz"])
    rng = np.random.default_rng(5)
    vals = rng.normal(0, 1, (F * K, 3)).astype(np.float32) * valid[:, None]
    idx, vals = torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(vals)
    out, stats = model_kernel(idx, n, vals)
    assert bitwise(out, reference(n, idx, vals))
    assert stats["tiles"] == F * K // TILE
