"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source under `lc_crf_slam_torch/csrc/` has a plain C entry
point, so it compiles in seconds without PyTorch's headers. The shared
library goes to `build/torch_kernels/` at the repository root and is
rebuilt whenever its source or a shared header (`*.cuh`) is newer.
Nothing is built at import time: the first wrapper call on a CUDA tensor
triggers the build, or `build_all()` builds every source at once, one
nvcc process each.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
from typing import Iterable, Optional

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


def kernel_names() -> list:
    """Every kernel source under csrc/, by name."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _paths(name: str):
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, out = _paths(name)
    if not os.path.exists(out):
        return True
    deps = [src, *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]
    return os.path.getmtime(out) < max(os.path.getmtime(d) for d in deps)


def build_all(names: Optional[Iterable[str]] = None) -> dict:
    """Compile every stale `csrc/<name>.cu` into
    `build/torch_kernels/lib<name>.so`, all nvcc processes started
    together; returns {name: compiler output} of what was built."""
    procs = {}
    for name in (kernel_names() if names is None else names):
        if not _stale(name):
            continue
        src, out = _paths(name)
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (tmp, out, src, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, out, src, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{logs[name]}")
        else:
            os.replace(tmp, out)   # atomic: concurrent builds never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` (if missing or stale) and load it."""
    build_all([name])
    return ctypes.CDLL(_paths(name)[1])


def ptxas_report(names: Optional[Iterable[str]] = None) -> dict:
    """{name: what `nvcc -Xptxas -v` says of csrc/<name>.cu}: each kernel's
    registers, shared memory and spills. The libraries it builds on the
    way are thrown away; one nvcc process per source, started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in (kernel_names() if names is None else names):
        tmp = os.path.join(BUILD_DIR, f"ptxas_{name}.{os.getpid()}.so")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, _paths(name)[0]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if os.path.exists(tmp):
            os.remove(tmp)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
    return logs


if __name__ == "__main__":
    # python -m lc_crf_slam_torch.kernels.build [name ...]: the ptxas report
    import sys

    for name, log in ptxas_report(sys.argv[1:] or None).items():
        print(f"== {name}\n{log}")
