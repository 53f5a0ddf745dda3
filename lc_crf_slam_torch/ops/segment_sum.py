"""Fixed-order segment sum: `out[t] = sum of vals[e] over the edges e with
idx[e] == t`, added one after another in increasing e, starting from 0.

The port's float sums over edges go through it: BA's camera, point and
coupling blocks and gradients (`ops/schur.py`, `models/loopclosing.py::
global_ba_alternating`) and the pose graphs' gradient, block diagonal and
matvec (`models/posegraph.py`). On the CPU the plain version is
`index_add_`, which adds each target's entries in edge order. On a card
`index_add_` is a float atomic whose order changes from run to run;
`csrc/segment_sum.cu` adds in the CPU's order, so a run on the card
repeats bit for bit and gives the plain version's bits. The kernel
replaces no TPU kernel: the reference sums with XLA's scatter-add.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, and anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

MAX_COLUMNS = 64   # the kernel's lanes cover columns c and c + 32

# kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


class SortedRuns(NamedTuple):
    """The kernel's view of one index vector (`sorted_runs`)."""

    sorted_idx: torch.Tensor  # (E,) int64: the targets, stably sorted
    perm: torch.Tensor        # (E,) int64: the edge at each sorted position
    head: torch.Tensor        # (E,) uint8: 1 where a target's run starts
    end: torch.Tensor         # (E,) int64: one past the last position of the run


class SegmentPlan(NamedTuple):
    """One index vector over n targets, built once (`segment_plan`) and
    handed to every sum over it."""

    idx: torch.Tensor             # (E,) int64: each edge's target
    n: int                        # the number of targets
    runs: Optional[SortedRuns]    # the kernel's view; None on the CPU


def sorted_runs(idx: torch.Tensor) -> SortedRuns:
    """The kernel's view of `idx` (E,) int64, by torch ops that are
    deterministic on the card and read nothing to the host: a stable sort
    (each target's run lists its edges in increasing order), the run
    heads and each run's end."""
    sorted_idx, perm = torch.sort(idx, stable=True)
    end = torch.searchsorted(sorted_idx, sorted_idx, right=True)
    head = torch.ones_like(sorted_idx, dtype=torch.uint8)
    head[1:] = (sorted_idx[1:] != sorted_idx[:-1]).to(torch.uint8)
    return SortedRuns(sorted_idx, perm, head, end)


def segment_plan(idx: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of `idx` (E,) over n targets: on a CUDA tensor with the
    kernel's sorted runs, on the CPU (where `index_add_` needs none)
    without."""
    idx = idx.reshape(-1).long()
    return SegmentPlan(idx, int(n), sorted_runs(idx) if idx.is_cuda else None)


def segment_sum_plain(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(n,) + vals.shape[1:] sums of vals (E, ...) by target idx (E,), by
    `index_add_` (in edge order on the CPU)."""
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add_(0, idx.reshape(-1).long(), vals)


@functools.lru_cache(maxsize=None)
def _lib():
    from ..kernels.build import load

    lib = load("segment_sum")
    fns = {}
    for dtype, name in ((torch.float32, "segment_sum_f32"),
                        (torch.float64, "segment_sum_f64")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_longlong] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.segment_sum_tile.restype = ctypes.c_int
    return fns, int(lib.segment_sum_tile())


def segment_sum_cuda(n: int, vals: torch.Tensor, runs: SortedRuns) -> torch.Tensor:
    """Launch the kernel on the current stream: vals (E, k) contiguous
    float32 or float64 CUDA tensor, k <= 64, and the sorted runs of its
    targets (every target in [0, n)) -> (n, k)."""
    global launches
    if not vals.is_cuda:
        raise ValueError("segment_sum_cuda needs a CUDA tensor")
    if vals.dtype not in (torch.float32, torch.float64) or vals.dim() != 2 \
            or not vals.is_contiguous():
        raise ValueError(f"need contiguous (E, k) float32 or float64 values, got "
                         f"{vals.dtype} {tuple(vals.shape)} "
                         f"contiguous={vals.is_contiguous()}")
    E, k = vals.shape
    if not 1 <= k <= MAX_COLUMNS:
        raise ValueError(f"the kernel sums 1 to {MAX_COLUMNS} columns, got {k}")
    if runs.perm.shape != (E,) or runs.perm.device != vals.device:
        raise ValueError(f"the runs are of {tuple(runs.perm.shape)} edges on "
                         f"{runs.perm.device}, the values of ({E},) on {vals.device}")
    out = torch.zeros((n, k), dtype=vals.dtype, device=vals.device)
    if E == 0:
        return out
    fns, tile = _lib()
    nz = torch.empty((E,), dtype=torch.uint8, device=vals.device)
    tile_nz = torch.empty((-(-E // tile),), dtype=torch.uint8, device=vals.device)
    with torch.cuda.device(vals.device):
        err = fns[vals.dtype](
            vals.data_ptr(), runs.sorted_idx.data_ptr(), runs.perm.data_ptr(),
            runs.head.data_ptr(), runs.end.data_ptr(), E, k, n, nz.data_ptr(),
            tile_nz.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err}")
    launches += 1
    return out


def segment_sum(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(n,) + vals.shape[1:] sums of vals (E, ...) by the plan's targets,
    each target's entries added in edge order: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if vals.is_cuda:
        if plan.runs is None:
            raise ValueError("the plan was built on the CPU; build it from a CUDA index")
        E, k = vals.shape[0], math.prod(vals.shape[1:])
        out = segment_sum_cuda(plan.n, vals.reshape(E, k).contiguous(), plan.runs)
        return out.reshape((plan.n,) + tuple(vals.shape[1:]))
    if vals.device.type != "cpu":
        raise ValueError(f"no segment-sum path for device {vals.device}")
    return segment_sum_plain(plan.n, plan.idx, vals)
