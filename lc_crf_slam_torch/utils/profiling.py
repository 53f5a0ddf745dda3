"""Stage timing and device traces (counterpart of
lc_crf_slam_tpu/utils/profiling.py).

  - StageTimer: host wall-clock per named stage with summary stats (the
    reference's end-of-run timing block). Stages nest: the timer keeps a
    stack, so each stage knows its parent and its self time (its duration
    less its children's). On the card a stage brackets the host's
    dispatch of its work, not the device's execution of it: PyTorch
    returns before the kernels finish, and the timer adds no synchronize,
    so a stage reads its device time only where its own code waits for
    the device. While a torch.profiler runs, each stage is also a
    `record_function` annotation of its name, so the spans and the device
    trace share one clock; with no profiler on, a stage costs two clock
    reads and an append.
  - span(name) / spanned / sections(): stages opened by free functions
    (`track_step`'s sections, `pose_optimize`) on the timer that the
    running `SLAMSystem` entry installed (`installed`); with no system
    running they do nothing.
  - trace(): a torch.profiler context (host and CUDA activities) that
    writes a Chrome trace into `log_dir`, in place of jax.profiler.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch.autograd.profiler as _autograd_profiler

# the timer of the SLAMSystem entry call in progress (None outside one)
_TIMER: contextvars.ContextVar = contextvars.ContextVar("stage_timer", default=None)


class _Stage:
    """One open stage of a StageTimer (a context manager)."""

    __slots__ = ("timer", "name", "annotation", "t0", "children_s")

    def __init__(self, timer: "StageTimer", name: str):
        self.timer, self.name = timer, name

    def __enter__(self) -> "_Stage":
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = _autograd_profiler.record_function(self.name)
            self.annotation.__enter__()
        self.children_s = 0.0
        self.timer._stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        timer = self.timer
        stack = timer._stack
        stack.pop()
        timer.samples[self.name].append(dt)
        timer.self_s[self.name] += dt - self.children_s
        if stack:
            stack[-1].children_s += dt
            timer.parents[self.name][stack[-1].name] += 1
        else:
            timer.parents[self.name][None] += 1
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


class StageTimer:
    """Accumulates wall-clock per named stage; reports median / mean / p90
    like the reference's end-of-run timing block, with each stage's
    parents and self time. `samples` holds each stage's inclusive
    durations by name; `parents` counts each stage's calls by the stage
    it ran in (None: at the top); `self_s` sums its self time."""

    def __init__(self) -> None:
        self.samples: Dict[str, list] = defaultdict(list)
        self.parents: Dict[str, Counter] = defaultdict(Counter)
        self.self_s: Dict[str, float] = defaultdict(float)
        self._stack: list = []

    def stage(self, name: str) -> _Stage:
        return _Stage(self, name)

    def count(self, name: str) -> int:
        """Calls of stage `name` so far."""
        return len(self.samples.get(name, ()))

    def span_totals(self, prefix: str = "") -> Dict[str, Tuple[int, float]]:
        """{stage: (calls, seconds)} of the stages whose names start with
        `prefix`, in the order they first ran."""
        return {name: (len(xs), float(np.sum(xs))) for name, xs in self.samples.items()
                if name.startswith(prefix)}

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
                "self_s": float(self.self_s[name]),
                "parents": {p or "": n for p, n in self.parents[name].items()},
            }
        return out

    def report(self) -> str:
        """The stages as a tree (each under the parent it first ran in,
        children by total time), one line each: calls, median, mean, p90,
        total and self time, and the other parents it ran in."""
        summary = self.summary()
        children: Dict[str, list] = defaultdict(list)
        for name, s in summary.items():
            children[next(iter(s["parents"]))].append(name)
        lines = [f"{'stage':<32} {'n':>5} {'median':>9} {'mean':>9} {'p90':>9} "
                 f"{'total':>9} {'self':>9}  also under"]

        shown = set()

        def walk(parent: str, depth: int) -> None:
            for name in sorted(children[parent], key=lambda n: -summary[n]["total_s"]):
                if name in shown:
                    continue
                shown.add(name)
                s = summary[name]
                others = ", ".join(f"{p or '(top)'} x{n}" for p, n in s["parents"].items()
                                   if p != parent)
                label = "  " * depth + name
                lines.append(
                    f"{label:<32} {s['n']:>5} {s['median_ms']:>7.2f}ms "
                    f"{s['mean_ms']:>7.2f}ms {s['p90_ms']:>7.2f}ms "
                    f"{s['total_s']:>8.3f}s {s['self_s']:>8.3f}s  {others}".rstrip())
                walk(name, depth + 1)

        walk("", 0)
        return "\n".join(lines)


@contextlib.contextmanager
def installed(timer) -> Iterator[None]:
    """`span`, `spanned` and `sections` open their stages on `timer`
    inside the block (a `SLAMSystem` entry installs its `timer`)."""
    token = _TIMER.set(timer)
    try:
        yield
    finally:
        _TIMER.reset(token)


def span(name: str):
    """A stage named `name` on the installed timer, or nothing."""
    timer = _TIMER.get()
    return contextlib.nullcontext() if timer is None else timer.stage(name)


def spanned(fn: Callable) -> Callable:
    """`fn` with each call inside `span(fn.__name__)`."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapped


class Sections:
    """Contiguous stages on `timer` (or none, when it is None): calling
    it with a name closes the open section and opens the next; leaving
    the block closes the last."""

    def __init__(self, timer) -> None:
        self.timer = timer
        self._open = None

    def __call__(self, name: str) -> None:
        self._close()
        if self.timer is not None:
            self._open = self.timer.stage(name)
            self._open.__enter__()

    def _close(self) -> None:
        if self._open is not None:
            stage, self._open = self._open, None
            stage.__exit__(None, None, None)

    def __enter__(self) -> "Sections":
        return self

    def __exit__(self, *exc) -> None:
        self._close()


def sections() -> Sections:
    """`Sections` on the installed timer."""
    return Sections(_TIMER.get())


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler over the block, host and (with a card) CUDA
    activities; on exit the Chrome trace is written to
    `log_dir/trace.json` (chrome://tracing, Perfetto). The timer's stages
    appear in it as annotations of their names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
