"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source under `lc_crf_slam_torch/csrc/` has a plain C entry
point, so it compiles in seconds without PyTorch's headers. The shared
library goes to `build/torch_kernels/` at the repository root and is
rebuilt whenever its source is newer. Nothing is built at import time:
the first wrapper call on a CUDA tensor triggers the build.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return cand


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` into `build/torch_kernels/lib<name>.so`
    (if missing or stale) and load it."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    return ctypes.CDLL(out)
