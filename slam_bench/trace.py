"""Reduce a torch.profiler slice of whole frames to the device's busy
time, its kernels by name, and its idle gaps labelled by the host span
the host was in.

The slice is marked by a `slice` annotation; each frame by a `frame`
annotation and each `slam.timer` stage by an annotation of its name
(`program.AnnotatingTimer`). Device activity is every kernel, copy and
fill on the card; the annotations' own device-side copies are not.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE, FRAME = "slice", "frame"


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The disjoint intervals that cover the same time, in order."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of [lo, hi] between disjoint sorted `busy` ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def label(gap: Interval, spans: Sequence[Tuple[str, float, float]]) -> str:
    """The innermost host span that holds the gap's midpoint: a stage of
    `slam.timer`, else `frame` (inside a frame but in no stage: flow and
    CRF, loop detection, the pose read-back), else `harness`."""
    mid = 0.5 * (gap[0] + gap[1])
    best, width = "harness", float("inf")
    for name, a, b in spans:
        if a <= mid <= b and b - a < width:
            best, width = name, b - a
    return best


def reduce(device: Sequence[Tuple[str, float, float]],
           host: Sequence[Tuple[str, float, float]], top: int = 10) -> dict:
    """`device`: (name, start, end) of each device activity; `host`:
    (name, start, end) of the annotations, one of them the slice. Times in
    seconds on one clock. Returns busy_s and window_s over the slice, the
    kernels by name ({name: [launches, seconds]}), the `top` heaviest
    device operations, and the device's idle time summed by the label of
    each idle gap, the `top` largest."""
    sl = [(a, b) for n, a, b in host if n == SLICE]
    if len(sl) != 1:
        raise ValueError(f"need one '{SLICE}' annotation, found {len(sl)}")
    lo, hi = sl[0]
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]
    busy = union((a, b) for _, a, b in inside)
    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for n, a, b in inside:
        by_name[n][0] += 1
        by_name[n][1] += b - a
    spans = [h for h in host if h[0] != SLICE]
    idle_by: Dict[str, float] = defaultdict(float)
    for g in gaps(busy, lo, hi):
        idle_by[label(g, spans)] += g[1] - g[0]
    idle = sorted(idle_by.items(), key=lambda x: -x[1])
    ops = sorted(((n, v[1]) for n, v in by_name.items()), key=lambda x: -x[1])
    return {"busy_s": sum(b - a for a, b in busy), "window_s": hi - lo,
            "kernels": dict(by_name),
            "device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle[:top]]}


def from_profiler(prof, host_names: Iterable[str]) -> dict:
    """`reduce` over a finished `torch.profiler.profile`: device activities
    and the annotations named in `host_names` (plus the slice and frames)
    from its raw events."""
    names = set(host_names) | {SLICE, FRAME}
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type().name == "CUDA":
            # torch builds without `activity_type` name the annotations'
            # device-side copies after the annotation
            kind = e.activity_type() if hasattr(e, "activity_type") else None
            if kind in DEVICE_ACTIVITIES or (kind is None and e.name() not in names):
                device.append((e.name(), a, b))
        elif e.name() in names:
            host.append((e.name(), a, b))
    return reduce(device, host)
