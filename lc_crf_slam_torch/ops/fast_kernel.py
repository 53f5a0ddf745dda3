"""Dual-threshold FAST + 3x3 NMS: wrappers of the two CUDA kernels.

Both replace lc_crf_slam_tpu/ops/pallas_fast.py::fast_score_dual_pallas.
- `fast_cell_best` (`csrc/fast_cells.cu`) is the main path's: one launch
  takes every pyramid level of every frame of a batch and emits, per 16-px
  cell, the best corner of keypoint selection (score, y, x) without
  writing the score maps. Plain version: `fast_cell_best_plain`
  (`ops/fast.py::fast_score_dual`, then `ops/select.py::cell_best`).
- `fast_nms_dual` (`csrc/fast_nms.cu`) emits both NMS'd score maps of
  every level of every frame of a batch in one launch, as two buffers laid
  out as `PyramidBatch.flat`: the way to look at the maps. Plain version:
  `fast_nms_dual_plain` (`ops/fast.py::fast_score_dual` per frame and
  level). `fast_score_dual_nms` keeps the TPU kernel's one-level
  signature and launches it with a one-level table.
A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, and anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

from typing import List, Tuple

import torch

from .fast import fast_score_dual
from .pyramid import PyramidBatch
from .select import cell_best

KERNEL_CELL = 16   # the cell size csrc/fast_cells.cu is compiled for

# kernel launches since the last reset (plain-version calls do not count):
# of the map kernel, and of the fused cell kernel
launches = 0
cell_launches = 0

CellBest = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # best, y, x


def reset_launches() -> None:
    global launches, cell_launches
    launches = 0
    cell_launches = 0


MAX_LEVELS = 16       # the level table csrc/fast_common.cuh passes by value
MAX_FRAMES = 65535    # gridDim.y


@functools.lru_cache(maxsize=None)
def _lib():
    from ..kernels.build import load

    fn = load("fast_nms").fast_nms_dual
    ints = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ints, ints, ints,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_batch(flat: torch.Tensor, shapes, th_high: float, th_low: float,
                 what: str) -> None:
    """Raise on a pyramid buffer or thresholds the FAST kernels do not take."""
    if not flat.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if flat.dtype != torch.float32 or flat.dim() != 2 or not flat.is_contiguous():
        raise ValueError(
            f"need a contiguous (B, pixels) float32 buffer, got {flat.dtype} "
            f"{tuple(flat.shape)} contiguous={flat.is_contiguous()}")
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"need 1 to {MAX_LEVELS} levels, got {len(shapes)}")
    if not 1 <= flat.shape[0] <= MAX_FRAMES:
        raise ValueError(f"need 1 to {MAX_FRAMES} frames, got {flat.shape[0]}")
    if sum(h * w for h, w in shapes) != flat.shape[1]:
        raise ValueError("level shapes do not add up to the buffer's row length")
    if not th_high >= th_low:
        raise ValueError(f"need th_high >= th_low, got {th_high}, {th_low}")


def fast_nms_dual_cuda(pyr: PyramidBatch, th_high: float, th_low: float):
    """One launch on the current stream over all levels of all frames of
    `pyr` (a contiguous float32 CUDA buffer): (score_high, score_low), each
    laid out as `pyr.flat`."""
    global launches
    flat = pyr.flat
    _check_batch(flat, pyr.shapes, th_high, th_low, "fast_nms_dual_cuda")
    hi = torch.empty_like(flat)
    lo = torch.empty_like(flat)
    n = len(pyr.shapes)
    table = ctypes.c_int * n
    with torch.cuda.device(flat.device):
        err = _lib()(flat.data_ptr(), hi.data_ptr(), lo.data_ptr(), flat.shape[0],
                     flat.stride(0), n, table(*[h for h, _ in pyr.shapes]),
                     table(*[w for _, w in pyr.shapes]), table(*pyr.offsets),
                     float(th_high), float(th_low),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_dual launch failed: cudaError {err}")
    launches += 1
    return hi, lo


def fast_nms_dual_plain(pyr: PyramidBatch, th_high: float, th_low: float):
    """The plain version of the map kernel: `fast_score_dual` on each
    level of each frame, into two buffers laid out as `pyr.flat`."""
    hi, lo = torch.empty_like(pyr.flat), torch.empty_like(pyr.flat)
    for l, (h, w) in enumerate(pyr.shapes):
        off = pyr.offsets[l]
        for b, img in enumerate(pyr.level(l)):
            ph, pl = fast_score_dual(img, th_high, th_low)
            hi[b, off: off + h * w] = ph.reshape(-1)
            lo[b, off: off + h * w] = pl.reshape(-1)
    return hi, lo


def fast_nms_dual(pyr: PyramidBatch, th_high: float, th_low: float):
    """Both NMS'd maps of every level of every frame: the kernel for a CUDA
    buffer, the plain version for a CPU buffer."""
    if pyr.flat.is_cuda:
        return fast_nms_dual_cuda(pyr, th_high, th_low)
    if pyr.flat.device.type != "cpu":
        raise ValueError(f"no FAST path for device {pyr.flat.device}")
    return fast_nms_dual_plain(pyr, th_high, th_low)


def fast_score_dual_cuda(img: torch.Tensor, th_high: float, th_low: float):
    """The map kernel on one level, a one-level table: (H, W) float32
    contiguous CUDA tensor -> (score_high, score_low)."""
    if not img.is_cuda:
        raise ValueError("fast_score_dual_cuda needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            f"need a contiguous 2-D float32 image, got {img.dtype} "
            f"{tuple(img.shape)} contiguous={img.is_contiguous()}")
    H, W = img.shape
    hi, lo = fast_nms_dual_cuda(PyramidBatch(img.view(1, H * W), ((H, W),)),
                                th_high, th_low)
    return hi.view(H, W), lo.view(H, W)


def fast_score_dual_nms(img: torch.Tensor, th_high: float, th_low: float):
    """FAST+NMS of one pyramid level at both thresholds: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if img.is_cuda:
        return fast_score_dual_cuda(img, th_high, th_low)
    if img.device.type != "cpu":
        raise ValueError(f"no FAST path for device {img.device}")
    return fast_score_dual(img, th_high, th_low)


@functools.lru_cache(maxsize=None)
def _cells_lib():
    from ..kernels.build import load

    fn = load("fast_cells").fast_cell_best
    ints = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ints, ints, ints, ints,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cell_counts(shapes, cell: int) -> List[int]:
    return [-(-h // cell) * -(-w // cell) for h, w in shapes]


def fast_cell_best_cuda(pyr: PyramidBatch, th_high: float, th_low: float,
                        cell: int = KERNEL_CELL, margin: int = 19) -> List[CellBest]:
    """One launch on the current stream over all levels of all frames of
    `pyr` (a contiguous float32 CUDA buffer): per level (best float32,
    y int32, x int32), each (B, n_cells_l)."""
    global cell_launches
    flat = pyr.flat
    _check_batch(flat, pyr.shapes, th_high, th_low, "fast_cell_best_cuda")
    if cell != KERNEL_CELL:
        raise ValueError(f"the kernel is compiled for cell={KERNEL_CELL}, got {cell}")
    if margin < 0:
        raise ValueError(f"need margin >= 0, got {margin}")
    n = len(pyr.shapes)
    counts = _cell_counts(pyr.shapes, cell)
    cell_offsets = [sum(counts[:l]) for l in range(n)]
    B, total = flat.shape[0], sum(counts)
    best = torch.empty((B, total), dtype=torch.float32, device=flat.device)
    ys = torch.empty((B, total), dtype=torch.int32, device=flat.device)
    xs = torch.empty((B, total), dtype=torch.int32, device=flat.device)
    table = ctypes.c_int * n
    with torch.cuda.device(flat.device):
        err = _cells_lib()(
            flat.data_ptr(), best.data_ptr(), ys.data_ptr(), xs.data_ptr(),
            B, flat.stride(0), total, n,
            table(*[h for h, _ in pyr.shapes]), table(*[w for _, w in pyr.shapes]),
            table(*pyr.offsets), table(*cell_offsets), int(margin),
            float(th_high), float(th_low),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_cell_best launch failed: cudaError {err}")
    cell_launches += 1
    return list(zip(*(torch.split(t, counts, dim=1) for t in (best, ys, xs))))


def fast_cell_best_plain(pyr: PyramidBatch, th_high: float, th_low: float,
                         cell: int = KERNEL_CELL, margin: int = 19) -> List[CellBest]:
    """The plain version of the fused kernel: per frame and level the dual
    FAST+NMS maps, then their masked per-cell best."""
    out = []
    for l in range(len(pyr.shapes)):
        per_frame = [cell_best(*fast_score_dual(img, th_high, th_low), cell, margin)
                     for img in pyr.level(l)]
        out.append(tuple(torch.stack(t) for t in zip(*per_frame)))
    return out


def fast_cell_best(pyr: PyramidBatch, th_high: float, th_low: float,
                   cell: int = KERNEL_CELL, margin: int = 19) -> List[CellBest]:
    """Best corner per cell for every level of every frame: the fused
    kernel for a CUDA buffer, the plain version for a CPU buffer."""
    if pyr.flat.is_cuda:
        return fast_cell_best_cuda(pyr, th_high, th_low, cell, margin)
    if pyr.flat.device.type != "cpu":
        raise ValueError(f"no FAST path for device {pyr.flat.device}")
    return fast_cell_best_plain(pyr, th_high, th_low, cell, margin)
