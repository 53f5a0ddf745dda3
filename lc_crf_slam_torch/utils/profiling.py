"""Stage timing and device traces (counterpart of
lc_crf_slam_tpu/utils/profiling.py).

  - StageTimer: host wall-clock per named stage with summary stats (the
    reference's end-of-run timing block). On the card a stage brackets
    the host's dispatch of its work, not the device's execution of it:
    PyTorch returns before the kernels finish, and the timer adds no
    synchronize, so a stage reads its device time only where its own code
    waits for the device.
  - trace(): a torch.profiler context (host and CUDA activities) that
    writes a Chrome trace into `log_dir`, in place of jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import numpy as np


class StageTimer:
    """Accumulates wall-clock per named stage; reports median / mean / p90
    like the reference's end-of-run timing block."""

    def __init__(self) -> None:
        self.samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "n": len(xs),
                "median_ms": float(np.median(arr) * 1e3),
                "mean_ms": float(arr.mean() * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self) -> str:
        lines = ["stage                  n   median     mean      p90"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<20} {s['n']:>4} {s['median_ms']:>7.2f}ms "
                f"{s['mean_ms']:>7.2f}ms {s['p90_ms']:>7.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler over the block, host and (with a card) CUDA
    activities; on exit the Chrome trace is written to
    `log_dir/trace.json` (chrome://tracing, Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
