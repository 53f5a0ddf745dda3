"""One run of a cell: set-up, the measured window, the profiled slice of a
traced run, the comparison that decides `correct`, and the result.

The window is a closed loop with one camera: a session's frames go to
the program's entry that the traffic names, in the hand-ins its entry
module makes (one frame, or a chunk), as host numpy arrays, and the next
hand-in goes in once the returned poses are on the host. At the end of a
session `slam.reset()` runs inside the window and the next session starts
on the same frames, so the work per frame does not depend on the
program's speed.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from . import faults, program, spec, trace as tracing, yardstick
from .reference import checks as ref_checks
from .reference.frontend import reference_frame
from .world import Pinhole, SyntheticWorld


class NoCard(RuntimeError):
    """The cell asks for cards this machine does not have."""


@dataclass
class RunRecord:
    """What the metric readers read: the window's frames and spans, the
    set-up, and in a traced run the host syncs and the profiled slice."""

    frame_ms: List[float]
    window_s: float
    statuses: List[int]
    peak_bytes: int
    setup_s: float
    spans: Dict[str, tuple]          # stage -> (calls, seconds) in the window
    syncs: List[tuple]               # (host syncs, frames) of each hand-in (traced runs)
    trace: Optional[dict]            # `trace.reduce` of the slice (traced runs)
    shape: dict                      # the frame's FAST launch: height, width, levels


def seed_of(seed: int) -> int:
    """Any whole number as a seed numpy takes."""
    return int(seed) % 2**63


def world_of(conf: dict, seed: int) -> SyntheticWorld:
    """The configuration's scene (its own `world.seed` draws the points
    and descriptors), with the sensor noise of every frame drawn from
    `seed`: every seed gets the same scene and trajectory, and so the same
    work, under other noise."""
    world = SyntheticWorld(cam=Pinhole(**conf["camera"]), **conf["world"])
    world.rng = np.random.default_rng(seed_of(seed))
    return world


def render(world: SyntheticWorld, n: int, entry=None) -> List[tuple]:
    """A session's frames as the camera hands them to `entry` (by default
    RGB-D: gray, depth in metres, timestamp), numpy on the host, rendered
    in order (the sensor noise is drawn frame after frame)."""
    if entry is None:
        from .entries import track_rgbd as entry
    return [entry.render(world, k) for k in range(n)]


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")


class ClosedLoop:
    """The closed loop over sessions, with what the comparison needs kept
    aside: each session's returned poses, the front end's output on the
    sampled frames (`program.FrameTap`), the first session's map, and the
    program's counts of keyframes, loop detections and CRF steps over
    each hand-in."""

    def __init__(self, slam, frames: List[tuple], mix: dict, tap: program.FrameTap,
                 cuda: bool):
        self.slam, self.frames, self.mix, self.tap, self.cuda = slam, frames, mix, tap, cuda
        self.entry = mix["module"]
        self.steps = self.entry.steps(len(frames), mix)
        self.session, self.i = 0, 0
        self.sessions = [{"frames": [], "Tcw": []}]
        self.frame_ms: List[float] = []
        self.statuses: List[int] = []
        self.syncs: List[tuple] = []
        self.counts: List[tuple] = []    # (keyframes, detections, CRF steps, initialised)
        self.first_map = None

    @property
    def k(self) -> int:
        """The session frame handed in last."""
        return self.steps[self.i - 1][-1] if self.i else -1

    def step(self, count_syncs: bool = False) -> float:
        """Make the next hand-in; returns the host clock at its end."""
        import torch

        slam = self.slam
        if self.i == len(self.steps):
            if self.first_map is None:
                self.first_map = program.map_snapshot(slam)
            slam.reset()
            self.session += 1
            self.i = 0
            self.sessions.append({"frames": [], "Tcw": []})
        ks = self.steps[self.i]
        self.tap.next_step(self.session, ks)
        before = program.counters(slam)
        t0 = time.perf_counter()
        if count_syncs:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    poses, statuses = self.entry.hand_in(slam, self.frames, ks, self.mix)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            self.syncs.append((yardstick.count_syncs(caught), len(ks)))
        else:
            poses, statuses = self.entry.hand_in(slam, self.frames, ks, self.mix)
        t1 = time.perf_counter()
        after = program.counters(slam)
        self.frame_ms.extend([(t1 - t0) * 1e3] * len(ks))
        self.statuses.extend(statuses)
        self.counts.append((after[0] - before[0], after[1] - before[1],
                            after[2] - before[2], before[3]))
        self.sessions[-1]["frames"].extend(ks)
        self.sessions[-1]["Tcw"].extend(poses)
        self.i += 1
        return t1


def warm_up(slam, frames: List[tuple], mix: dict) -> int:
    """The session's first hand-ins until `warmup_keyframes` keyframes
    after the first frame's have been taken, and one more; then
    `reset()`. Returns the frames run."""
    entry, run = mix["module"], 0
    for ks in entry.steps(len(frames), mix):
        done = len(slam.kf_log) >= mix["warmup_keyframes"]
        entry.hand_in(slam, frames, ks, mix)
        run += len(ks)
        if done:
            break
    slam.reset()
    return run


def profile_slice(loop: ClosedLoop, n_frames: int) -> dict:
    """torch.profiler over `n_frames` whole frames, each stage of
    `slam.timer` annotated; reduced by `trace.from_profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    slam = loop.slam
    timer = slam.timer
    slam.timer = program.AnnotatingTimer(timer)
    activities = [ProfilerActivity.CPU]
    if loop.cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    try:
        with profile(activities=activities) as prof:
            with record_function(tracing.SLICE):
                for _ in range(n_frames):
                    with record_function(tracing.FRAME):
                        loop.step()
                if loop.cuda:
                    torch.cuda.synchronize()
    finally:
        slam.timer = timer
    return tracing.from_profiler(prof, set(timer.samples))


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", variant: Optional[str] = None,
        frames: Optional[int] = None, diagnose: bool = False,
        log: Callable[[str], None] = print) -> dict:
    """One run of `workload`; returns the result (the keys of the last
    line). `device="cpu"`, `variant`, `frames` (the window ends after so
    many frames, not `seconds`) and `diagnose` (the result adds
    `diagnostics`, readings beside the compared numbers) are for the tests
    and the calibration: the benchmark's runs take none of them."""
    bench = spec.benchmark(root)
    cell = spec.cell(bench, workload)
    conf = spec.config(root, bench, cell["config"])
    traffic = spec.traffic(root, cell["traffic"])
    entries = spec.metrics(bench, workload, trace)
    readers = spec.readers(root, entries)
    cuda = device == "cuda"
    parts = {}

    import torch

    if cuda:
        check_card(cell["chips"])
        torch.zeros(1, device=device)
    parts["import_and_context_s"] = time.perf_counter() - t_start
    t = time.perf_counter()
    if cuda:
        program.load_kernels()
    parts["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    world = world_of(conf, seed)
    n = conf["session_frames"]
    session_frames = render(world, n, traffic["module"])
    parts["render_s"] = time.perf_counter() - t
    t = time.perf_counter()
    slam = program.make_system(conf["camera"], conf["slam"], device)
    parts["warmup_frames"] = warm_up(slam, session_frames, traffic)
    rng = np.random.default_rng([seed_of(seed), 1])
    tap = program.FrameTap(rng.choice(n, size=min(conf["compare_frames"], n),
                                      replace=False).tolist())
    loop = ClosedLoop(slam, session_frames, traffic, tap, cuda)
    variant_ctx = faults.VARIANTS[variant](slam) if variant else contextlib.nullcontext()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans0 = program.span_totals(slam.timer)
    # what set-up made is never garbage: keep the collector off it
    gc.collect()
    gc.freeze()
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"setup parts: {parts}")

    t_w0 = time.perf_counter()
    with variant_ctx, tap.installed():
        while True:
            t_end = loop.step(count_syncs=trace and cuda)
            if (len(loop.frame_ms) >= frames) if frames else (t_end - t_w0 >= seconds):
                break
        window_s = t_end - t_w0
        n_window = len(loop.frame_ms)
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        spans1 = program.span_totals(slam.timer)
        sliced = profile_slice(loop, traffic["trace_frames"]) if trace else None

    spans = {k: (c - spans0.get(k, (0, 0.0))[0], s - spans0.get(k, (0, 0.0))[1])
             for k, (c, s) in spans1.items()}
    maps = [(program.snapshot_to_host(program.map_snapshot(slam)), loop.k)]
    if loop.first_map is not None:
        maps.insert(0, (program.snapshot_to_host(loop.first_map), n - 1))
    port_frames = tap.to_host()
    threshold = program.dynamic_threshold(slam)
    del slam, loop.slam, tap
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window, in float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    orb = {k.split(".", 1)[1]: v for k, v in conf["slam"].items() if k.startswith("orb.")}
    ref_frames = {}
    for k in sorted({k for k, _ in port_frames}):
        r = reference_frame(session_frames[k][0], session_frames[k][1], orb, device)
        ref_frames[k] = {f: getattr(r, f).cpu().numpy() for f in ("uv", "level", "desc", "valid")}
    judged = ref_checks.Judged(frames=port_frames, ref_frames=ref_frames,
                               sessions=loop.sessions, maps=maps, counts=loop.counts,
                               world=world, n_frames=n, dyn_threshold=threshold)
    values = ref_checks.evaluate(list(conf["checks"]), judged)
    log(f"reference: {time.perf_counter() - t:.1f} s over {len(ref_frames)} frames")
    checks = {name: {"value": values[name], "limit": limit}
              for name, limit in conf["checks"].items()}
    finite = all(np.all(np.isfinite(np.asarray(s["Tcw"]))) for s in loop.sessions)
    correct = finite and all(c["value"] is not None and math.isfinite(c["value"])
                             and c["value"] <= c["limit"] for c in checks.values())

    record = RunRecord(
        frame_ms=loop.frame_ms[:n_window], window_s=window_s,
        statuses=loop.statuses[:n_window], peak_bytes=peak, setup_s=setup_s,
        spans=spans, syncs=loop.syncs, trace=sliced,
        shape={"height": conf["camera"]["height"], "width": conf["camera"]["width"],
               "n_levels": conf["slam"]["orb.n_levels"],
               "scale_factor": conf["slam"]["orb.scale_factor"],
               "cell": conf["slam"]["orb.cell_size"]})
    metrics = {}
    for m in entries:
        value = readers[m["name"]](record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"] if cuda else 0, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": n_window,
              "failed": sum(s == 2 for s in record.statuses),
              "metrics": metrics, "device": dev}
    if sliced is not None:
        dev["busy_s"] = sliced["busy_s"]
        dev["window_s"] = sliced["window_s"]
        result["breakdown"] = {"device_ops": sliced["device_ops"],
                               "idle_gaps": sliced["idle_gaps"]}
    if diagnose:
        result["diagnostics"] = ref_checks.diagnostics(judged)
    result["checks"] = checks
    return result
