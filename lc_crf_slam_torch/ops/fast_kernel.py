"""Fused dual-threshold FAST + 3x3 NMS: wrapper of the CUDA kernel.

Replaces lc_crf_slam_tpu/ops/pallas_fast.py::fast_score_dual_pallas. The
kernel (`csrc/fast_nms.cu`) emits both NMS'd score maps of one pyramid
level in one launch. A tensor on the CPU goes to the plain version
(`ops/fast.py::fast_score_dual`); a CUDA tensor goes to the kernel, and
anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .fast import fast_score_dual

# kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    from ..kernels.build import load

    lib = load("fast_nms")
    fn = lib.fast_nms_dual
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fast_score_dual_cuda(img: torch.Tensor, th_high: float, th_low: float):
    """Launch the kernel on the current stream: (H, W) float32 contiguous
    CUDA tensor -> (score_high, score_low)."""
    global launches
    if not img.is_cuda:
        raise ValueError("fast_score_dual_cuda needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            f"need a contiguous 2-D float32 image, got {img.dtype} "
            f"{tuple(img.shape)} contiguous={img.is_contiguous()}")
    H, W = img.shape
    hi = torch.empty_like(img)
    lo = torch.empty_like(img)
    with torch.cuda.device(img.device):
        err = _lib()(img.data_ptr(), hi.data_ptr(), lo.data_ptr(), H, W,
                     float(th_high), float(th_low),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_dual launch failed: cudaError {err}")
    launches += 1
    return hi, lo


def fast_score_dual_nms(img: torch.Tensor, th_high: float, th_low: float):
    """FAST+NMS of one pyramid level at both thresholds: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if img.is_cuda:
        return fast_score_dual_cuda(img, th_high, th_low)
    if img.device.type != "cpu":
        raise ValueError(f"no FAST path for device {img.device}")
    return fast_score_dual(img, th_high, th_low)
