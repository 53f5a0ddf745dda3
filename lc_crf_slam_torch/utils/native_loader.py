"""ctypes binding to the native prefetching TUM loader (counterpart of
lc_crf_slam_tpu/utils/native_loader.py).

`runtime/libtumloader.so` (built by runtime/build.sh from
runtime/tum_loader.cc) decodes RGB/depth PNG pairs in a C++ thread pool
into a bounded in-order queue. This module never writes into runtime/:
when the library is not there it compiles the same source with
build.sh's flags into build/libtumloader.so. When neither builds or
loads (no g++ or libpng, or a library the host cannot load),
`build_native_runtime()` says False and callers use
`utils.io_tum.TUMSequence`, which gives the same iteration contract. This
is a data reader: no device or kernel runs here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "runtime", "tum_loader.cc")
_PREBUILT = os.path.join(_REPO, "runtime", "libtumloader.so")
_BUILT = os.path.join(_REPO, "build", "libtumloader.so")


def _library_path() -> str:
    return _PREBUILT if os.path.exists(_PREBUILT) else _BUILT


def compile_native_runtime(out_path: str = _BUILT) -> bool:
    """Compile runtime/tum_loader.cc with runtime/build.sh's flags into
    `out_path` (written under a temporary name, then renamed, so that
    concurrent builds never load half a file). True when it built."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           _SOURCE, "-o", tmp, "-lpng", "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out_path)
    return True


def _load_lib(path: Optional[str] = None) -> Optional[ctypes.CDLL]:
    path = path or _library_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:         # e.g. libpng missing on this host
        return None
    lib.tum_loader_create.restype = ctypes.c_void_p
    lib.tum_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.tum_loader_next.restype = ctypes.c_int
    lib.tum_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.tum_loader_destroy.restype = None
    lib.tum_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def build_native_runtime() -> bool:
    """Whether the native loader is available: runtime/libtumloader.so, or
    else build/libtumloader.so, compiled first if missing; False when it
    cannot be built or loaded."""
    if not os.path.exists(_library_path()) and not compile_native_runtime():
        return False
    return _load_lib() is not None


class NativeTUMLoader:
    """Iterates (timestamp, gray float32 (H, W), depth float32 (H, W)) with
    C++ decode threads prefetching ahead of the consumer."""

    def __init__(self, entries, width: int, height: int,
                 depth_map_factor: float = 5000.0,
                 n_threads: int = 4, queue_cap: int = 8):
        """entries: list of (t_rgb, rgb_path, t_depth, depth_path)."""
        self._lib = _load_lib()
        if self._lib is None:
            raise RuntimeError("native loader not available; see "
                               "build_native_runtime() or use utils.io_tum.TUMSequence")
        self.width, self.height = width, height
        self.n = len(entries)
        rgb = (ctypes.c_char_p * self.n)(*[e[1].encode() for e in entries])
        dep = (ctypes.c_char_p * self.n)(*[e[3].encode() for e in entries])
        ts = (ctypes.c_double * self.n)(*[e[0] for e in entries])
        self._keepalive = (rgb, dep, ts)
        # the library delivers a frame whose size differs from (width,
        # height) as failed (rc 0), never copying past the buffers below
        self._h = self._lib.tum_loader_create(
            rgb, dep, ts, self.n, depth_map_factor, n_threads, queue_cap,
            width, height)
        self._closed = False

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        gray = np.empty((self.height, self.width), np.float32)
        depth = np.empty((self.height, self.width), np.float32)
        t, w, h = ctypes.c_double(), ctypes.c_int(), ctypes.c_int()
        as_float = ctypes.POINTER(ctypes.c_float)
        while not self._closed:
            r = self._lib.tum_loader_next(
                self._h, gray.ctypes.data_as(as_float), depth.ctypes.data_as(as_float),
                ctypes.byref(t), ctypes.byref(w), ctypes.byref(h))
            if r < 0:
                return
            if r == 0:
                continue    # decode failure: skip the frame, keep the order
            yield t.value, gray.copy(), depth.copy()

    def close(self) -> None:
        if not getattr(self, "_closed", True):
            self._lib.tum_loader_destroy(self._h)
            self._closed = True

    def __del__(self):
        self.close()
