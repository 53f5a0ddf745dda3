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

MAX_COLUMNS = 64     # the kernel's carry words hold 64 columns
TILE = 256           # sorted positions a tile: csrc/segment_sum.cu's kTile
OWN = 32             # owned runs: the positions whose runs a block owns (kOwn)
SMALL_EDGES = 4096   # up to this many edges blocks own whole runs (no look-back)
CARRY_WORDS = 2 * MAX_COLUMNS   # tagged 64-bit words of one tile's carry

# the devices the kernel has been launched on (each keeps its launch count)
_devices: set = set()


def _launch_counts(reset: bool) -> int:
    """The kernel launches that ran on the card since the last reset, summed
    over the devices it ran on (0 where it never ran)."""
    if not _devices:
        return 0
    fn = _lib()["launches"]
    total = 0
    for device in sorted(_devices):
        count = ctypes.c_ulonglong(0)
        err = fn(device, ctypes.byref(count), int(reset))
        if err != 0:
            raise RuntimeError(f"segment_sum launch count failed: cudaError {err}")
        total += count.value
    return total


def launches() -> int:
    """Kernel launches since the last `reset_launches()`, counted on the
    card by the kernel itself, so a launch replayed from a CUDA graph counts
    (plain-version calls do not). Waits for the devices' work so far."""
    return _launch_counts(reset=False)


def reset_launches() -> None:
    _launch_counts(reset=True)


class _Plan(ctypes.Structure):
    """csrc/segment_sum.cu's `SegmentSumPlan`, field for field."""

    _fields_ = [("perm", ctypes.c_void_p), ("tgt", ctypes.c_void_p),
                ("own", ctypes.c_void_p), ("hit", ctypes.c_void_p),
                ("span", ctypes.c_void_p), ("status", ctypes.c_void_p), ("carry", ctypes.c_void_p),
                ("E", ctypes.c_longlong), ("n", ctypes.c_longlong),
                ("tiles", ctypes.c_int), ("owned", ctypes.c_int),
                ("epoch", ctypes.c_uint), ("device", ctypes.c_int)]


class KernelPlan:
    """The kernel's view of one index vector (`kernel_plan`): built once,
    used by every sum over it, one call at a time (a call on another
    stream waits for the last one: they share the look-back scratch)."""

    def __init__(self, E: int, n: int, perm: torch.Tensor, tgt: torch.Tensor,
                 hit: torch.Tensor, own: Optional[torch.Tensor],
                 span: Optional[torch.Tensor], status: Optional[torch.Tensor],
                 carry: Optional[torch.Tensor]):
        self.E, self.n = E, n
        self.perm = perm        # (E,) int32: the edge at each sorted position
        self.tgt = tgt          # (E,) int32: the targets, stably sorted
        self.hit = hit          # (ceil(n / 64),) int64: bit t % 64 of word t // 64 if t is hit
        self.own = own          # (blocks, 2) int32: each block's owned runs [lo, hi), or None
        self.span = span        # (tiles,) int32: a tile's first edge if its edges are
                                # consecutive ids, else -1; or None
        self.status = status    # (tiles,) int32 look-back status words, or None
        self.carry = carry      # (tiles, CARRY_WORDS) int64 tagged carries, or None
        self.stream = None      # the stream of the last call, and its handle
        self.stream_ptr = None
        self._struct = None

    def struct(self) -> _Plan:
        if self._struct is None:
            ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
            self._struct = _Plan(
                ptr(self.perm), ptr(self.tgt), ptr(self.own), ptr(self.hit),
                ptr(self.span), ptr(self.status), ptr(self.carry), self.E, self.n,
                0 if self.status is None else self.status.shape[0],
                0 if self.own is None else self.own.shape[0], 0, self.perm.device.index)
        return self._struct


class SegmentPlan(NamedTuple):
    """One index vector over n targets, built once (`segment_plan`) and
    handed to every sum over it."""

    idx: torch.Tensor               # (E,) int64: each edge's target
    n: int                          # the number of targets
    kernel: Optional[KernelPlan]    # the kernel's view; None on the CPU


def kernel_plan(idx: torch.Tensor, n: int) -> KernelPlan:
    """The kernel's view of `idx` (E,) over n targets, by torch ops that
    are deterministic on the card and read nothing to the host: a stable
    sort (each target's run lists its edges in increasing order), the bits
    of the targets hit, and either each block's owned runs (E <=
    SMALL_EDGES) or the tiles that are spans of consecutive edges and the
    look-back scratch, zeroed once. Runs on any device (the CPU tests
    model the kernel's schedule with it)."""
    idx = idx.reshape(-1).long()
    E, dev = idx.shape[0], idx.device
    if max(E, n) >= 2 ** 31:
        raise ValueError(f"the kernel indexes edges and targets with int32: E={E}, n={n}")
    sorted_idx, perm = torch.sort(idx, stable=True)
    head = torch.ones_like(sorted_idx, dtype=torch.bool)
    head[1:] = sorted_idx[1:] != sorted_idx[:-1]
    ok = head & (sorted_idx >= 0) & (sorted_idx < n)
    t = torch.where(ok, sorted_idx, 0)
    bits = torch.where(ok, torch.bitwise_left_shift(torch.ones_like(t), t % 64), 0)
    hit = torch.zeros((-(-n // 64),), dtype=torch.int64, device=dev).index_add_(
        0, t // 64, bits)   # distinct bits: the integer sum is their OR
    own = span = status = carry = None
    if E <= SMALL_EDGES:
        starts = torch.arange(0, E, OWN, device=dev)
        last = torch.clamp(starts + OWN, max=E) - 1
        run_end = lambda p: torch.searchsorted(sorted_idx, sorted_idx[p], right=True)  # noqa: E731
        lo = torch.where(head[starts], starts, run_end(starts))
        own = torch.stack([lo, torch.maximum(run_end(last), lo)], 1).to(torch.int32)
    else:
        tiles = -(-E // TILE)
        # the tiles whose edges are consecutive ids: one span of the values
        step = torch.ones(tiles * TILE, dtype=torch.bool, device=dev)
        step[1:E] = perm[1:] == perm[:-1] + 1
        step[::TILE] = True
        span = torch.where(step.view(tiles, TILE).all(dim=1), perm[::TILE], -1).to(torch.int32)
        status = torch.zeros((tiles,), dtype=torch.int32, device=dev)
        carry = torch.zeros((tiles, CARRY_WORDS), dtype=torch.int64, device=dev)
    return KernelPlan(E, int(n), perm.to(torch.int32), sorted_idx.to(torch.int32), hit, own,
                      span, status, carry)


def segment_plan(idx: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of `idx` (E,) over n targets: on a CUDA tensor with the
    kernel's view, on the CPU (where `index_add_` needs none) without."""
    idx = idx.reshape(-1).long()
    return SegmentPlan(idx, int(n), kernel_plan(idx, n) if idx.is_cuda else None)


def segment_sum_plain(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(n,) + vals.shape[1:] sums of vals (E, ...) by target idx (E,), by
    `index_add_` (in edge order on the CPU)."""
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add_(0, idx.reshape(-1).long(), vals)


def _current_stream_ptr(device: torch.device) -> int:
    """The handle of the device's current stream, by torch's raw call where
    the build has it (no Stream object made)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _lib():
    from ..kernels.build import load

    lib = load("segment_sum")
    if (lib.segment_sum_tile(), lib.segment_sum_owned(), lib.segment_sum_plan_bytes()) != \
            (TILE, OWN, ctypes.sizeof(_Plan)):
        raise RuntimeError("csrc/segment_sum.cu and ops/segment_sum.py disagree on the plan")
    fns = {}
    for dtype, name in ((torch.float32, "segment_sum_f32"),
                        (torch.float64, "segment_sum_f64")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Plan), ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    fn = lib.segment_sum_launches
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    fns["launches"] = fn
    return fns


def segment_sum_cuda(vals: torch.Tensor, plan: KernelPlan) -> torch.Tensor:
    """Launch the kernel on the current stream: vals (E, k) contiguous
    float32 or float64 CUDA tensor, k <= 64, and the kernel's plan of its
    targets (every target in [0, n)) -> (n, k). One launch; the output is
    allocated uninitialised and the kernel writes all of it."""
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
    if plan.E != E or plan.perm.device != vals.device:
        raise ValueError(f"the plan is of {plan.E} edges on {plan.perm.device}, the "
                         f"values of {E} on {vals.device}")
    if E == 0:
        return torch.zeros((plan.n, k), dtype=vals.dtype, device=vals.device)
    fn = _lib()[vals.dtype]
    out = torch.empty((plan.n, k), dtype=vals.dtype, device=vals.device)
    stream_ptr = _current_stream_ptr(vals.device)
    if stream_ptr != plan.stream_ptr:
        stream = torch.cuda.current_stream(vals.device)
        if plan.stream is not None:
            stream.wait_stream(plan.stream)     # the scratch is the last call's until it ends
        plan.stream, plan.stream_ptr = stream, stream_ptr
    err = fn(ctypes.byref(plan.struct()), vals.data_ptr(), out.data_ptr(), k, stream_ptr)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err}")
    _devices.add(vals.device.index)
    return out


def segment_sum(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(n,) + vals.shape[1:] sums of vals (E, ...) by the plan's targets,
    each target's entries added in edge order: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if vals.is_cuda:
        if plan.kernel is None:
            raise ValueError("the plan was built on the CPU; build it from a CUDA index")
        E, k = vals.shape[0], math.prod(vals.shape[1:])
        out = segment_sum_cuda(vals.reshape(E, k).contiguous(), plan.kernel)
        return out.reshape((plan.n,) + tuple(vals.shape[1:]))
    if vals.device.type != "cpu":
        raise ValueError(f"no segment-sum path for device {vals.device}")
    return segment_sum_plain(plan.n, plan.idx, vals)
