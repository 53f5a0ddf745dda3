"""Per-stage time and op count of the dynamic pipeline, per frame or
chunked.

    python -m lc_crf_slam_torch.utils.stage_profile [--frames 31]
    python -m lc_crf_slam_torch.utils.stage_profile --sequence [--chunk 15]
    python -m lc_crf_slam_torch.utils.stage_profile --loop
    python -m lc_crf_slam_torch.utils.stage_profile --stereo [--sequence]
    python -m lc_crf_slam_torch.utils.stage_profile --mono

Runs `SLAMSystem.track_rgbd` with mapping and the CRF on (loop closing
off) over bench.py's billboard world at TUM3 640×480 and default
capacities, on the CUDA device, and prints one row per stage: calls,
mean ms per call and per frame (a synchronize on both sides of every
call; frames from the 4th on), and the aten ops one call dispatches
(counted in a second, untimed pass over the same frames). A stage's
figures include the stages it calls. A third pass traces frames 10-14
with torch.profiler: device busy ms and kernels per frame, and the
device's idle share of the unprofiled frame time.

`--sequence` profiles the chunked throughput path instead
(`SLAMSystem.track_sequence`, the default configuration with loop
detection on, same world): the stages of a chunk (the batched front-end
`build_frames`, the hoisted LK batch, `track_step`, the keyframe branch's
spawn gate / insertion / `mapping_step` / `detect_loop`, the flow EMA,
`crf_step`) under the same synchronisation, their aten ops, and the
unsynchronised `seq_phases` split of a third run (step loop, fetch and
host logic included).

`--loop` profiles the same chunked path over the loop world instead (a
1.2-turn pan over a textured wall, 130 frames, as `chip_smoke.py`'s loop
phase), whose revisit closes a loop: it adds the rows of loop closing,
`verify_loop`, `correct_loop` (its `optimize_pose_graph` apart), one
`global_ba` slice and the group-wide `search_and_fuse`.

`--stereo` profiles `track_stereo` (with `--sequence`,
`track_sequence_stereo`) on tests/test_mono_stereo_e2e.py's stereo world
(24 TUM3 pairs, the right eye one baseline along camera x; with
`--sequence`, bench.py's billboard frames and their right eyes, as
chip_smoke.py's stereo sequence phase), default configuration: adds the
`stereo_match` row. `--mono` profiles `track_monocular` on that file's
monocular world (30 frames, stages from the 2nd: `initialize_mono` runs
before the 4th), then hands `correct_loop_sim3` a closure between the
newest keyframe and keyframe 0 on the map it left (s_corr 0.8, as
chip_smoke.py's Sim(3) stage) and adds its rows, `optimize_pose_graph_sim3`
apart. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models import loopclosing, mapping, system

# (module, function, row name), outermost first
STAGES = (
    (system, "build_frames", "build_frames (batch)"),
    (system, "stereo_match", "stereo_match"),
    (system, "initialize_mono", "initialize_mono"),
    (system, "correct_loop_sim3", "correct_loop_sim3"),
    (loopclosing, "optimize_pose_graph_sim3", "correct_loop_sim3: pose graph"),
    (system, "lk_track_batch", "LK batch (chunk)"),
    (system, "flow_ema", "flow_ema"),
    (system, "detect_loop", "detect_loop"),
    (system, "verify_loop", "verify_loop"),
    (system, "correct_loop", "correct_loop"),
    (loopclosing, "optimize_pose_graph", "correct_loop: pose graph"),
    (system, "global_ba", "global_ba (slice)"),
    (system, "search_and_fuse", "search_and_fuse (group)"),
    (system, "build_frame", "build_frame"),
    (system, "track_step", "track_step"),
    (system, "flow_evidence", "flow_evidence"),
    (system, "crf_step", "crf_step"),
    (system, "spawn_flow_dyn", "spawn_flow_dyn"),
    (system, "insert_keyframe", "insert_keyframe"),
    (system, "relocalize", "relocalize"),
    (system, "mapping_step", "mapping_step"),
    (mapping, "create_new_points", "mapping: triangulate"),
    (mapping, "fuse_duplicates", "mapping: fuse (x3)"),
    (mapping, "refresh_point_stats", "mapping: refresh"),
    (mapping, "local_bundle_adjustment", "mapping: local BA"),
    (mapping, "cull_points", "mapping: culls"),
    (mapping, "cull_keyframes", "mapping: culls"),
)


class _OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched, into each stage on the stack."""

    def __init__(self, stack: List[str], counts: Dict[str, int]):
        super().__init__()
        self.stack, self.counts = stack, counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for name in set(self.stack):
            self.counts[name] += 1
        self.counts["(frame)"] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _instrumented(on_call):
    """Wrap every stage function; on_call(name, fn, args, kwargs) runs it."""
    saved = []
    for mod, fn_name, row in STAGES:
        fn = getattr(mod, fn_name)
        saved.append((mod, fn_name, fn))

        def wrapped(*args, _fn=fn, _row=row, **kwargs):
            return on_call(_row, _fn, args, kwargs)
        setattr(mod, fn_name, wrapped)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def profile(slam_factory, frames, skip: int = 3, track: str = "track_rgbd",
            keep: Optional[list] = None):
    """Rows {stage: (calls, ms per call, ms per frame, ops per call)} over
    `frames` (each the arguments of one `slam.<track>` call, e.g. (gray,
    depth, t)), timed from frame `skip` on; the row "(frame)" is the whole
    call under the same synchronisation. `keep` (a list) receives the
    system of the counting pass."""
    slam = slam_factory()
    sync = torch.cuda.synchronize if slam.device.type == "cuda" else (lambda: None)
    ms = collections.defaultdict(float)
    calls = collections.defaultdict(int)
    timing = {"on": False}

    def timed(row, fn, args, kwargs):
        if not timing["on"]:
            return fn(*args, **kwargs)
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        ms[row] += (time.perf_counter() - t0) * 1e3
        calls[row] += 1
        return out

    frame_ms = []
    with _instrumented(timed):
        for k, args in enumerate(frames):
            timing["on"] = k >= skip
            sync()
            t0 = time.perf_counter()
            getattr(slam, track)(*args)
            sync()
            if k >= skip:
                frame_ms.append((time.perf_counter() - t0) * 1e3)

    stack: List[str] = []
    ops = collections.defaultdict(int)
    op_calls = collections.defaultdict(int)

    def counted(row, fn, args, kwargs):
        stack.append(row)
        op_calls[row] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()

    slam = slam_factory()
    with _instrumented(counted):
        for k, args in enumerate(frames):
            if k == skip:
                ops.clear()
                op_calls.clear()
            if k >= skip:
                with _OpCounter(stack, ops):
                    getattr(slam, track)(*args)
            else:
                getattr(slam, track)(*args)
    if keep is not None:
        keep.append(slam)
    n = max(len(frames) - skip, 1)
    rows = {}
    for _, _, row in STAGES:
        if calls[row]:
            rows[row] = (calls[row], ms[row] / calls[row], ms[row] / n,
                         ops[row] / max(op_calls[row], 1))
    rows["(frame)"] = (n, sum(frame_ms) / n, sum(frame_ms) / n, ops["(frame)"] / n)
    return rows


def profile_closure(slam, s_corr: float = 0.8, calls: int = 2):
    """Rows of `correct_loop_sim3` handed a closure between the newest
    keyframe of `slam`'s map and keyframe 0 (s_corr, a small rotation and
    shift): ms of each of `calls` calls (a synchronize on both sides), ops
    of one."""
    from ..geometry.se3 import exp_se3

    m, dev = slam.map, slam.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    args = (slam.cfg, slam.cam, m, (m.n_kfs - 1).to(torch.int32),
            torch.zeros((), dtype=torch.int32, device=dev),
            exp_se3(torch.tensor([0.02, -0.01, 0.03, 0.01, -0.02, 0.015])).to(dev),
            torch.tensor(s_corr).to(dev))
    ms = collections.defaultdict(list)

    def timed(row, fn, a, kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        ms[row].append((time.perf_counter() - t0) * 1e3)
        return out

    with _instrumented(timed):
        for _ in range(calls):
            system.correct_loop_sim3(*args)
    stack: List[str] = []
    ops = collections.defaultdict(int)

    def counted(row, fn, a, kw):
        stack.append(row)
        try:
            return fn(*a, **kw)
        finally:
            stack.pop()

    with _instrumented(counted), _OpCounter(stack, ops):
        system.correct_loop_sim3(*args)
    return {row: (len(t), sum(t) / len(t), 0.0, ops[row]) for row, t in ms.items()}


def profile_sequence(slam_factory, grays, depths, stamps, chunk: int,
                     track: str = "track_sequence"):
    """({stage: (calls, ms per call, ms per chunked frame, ops per call)},
    seq_phases in host ms per chunked frame, ms per chunked frame
    unsynchronised) of `track_sequence` over the frames; a short run on a
    system of its own warms the device up first."""
    sync = torch.cuda.synchronize
    getattr(slam_factory(), track)(grays[:4], depths[:4], stamps[:4], chunk=chunk)
    n = len(stamps) - 1
    ms = collections.defaultdict(float)
    calls = collections.defaultdict(int)

    def timed(row, fn, args, kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        ms[row] += (time.perf_counter() - t0) * 1e3
        calls[row] += 1
        return out

    with _instrumented(timed):
        getattr(slam_factory(), track)(grays, depths, stamps, chunk=chunk)

    stack: List[str] = []
    ops = collections.defaultdict(int)

    def counted(row, fn, args, kwargs):
        stack.append(row)
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()

    with _instrumented(counted), _OpCounter(stack, ops):
        getattr(slam_factory(), track)(grays, depths, stamps, chunk=chunk)
    rows = {row: (calls[row], ms[row] / calls[row], ms[row] / n, ops[row] / calls[row])
            for _, _, row in STAGES if calls[row]}
    rows["(all frames)"] = (1, 0.0, 0.0, ops["(frame)"] / (n + 1))

    slam = slam_factory()
    slam.seq_phases = {}
    sync()
    t0 = time.perf_counter()
    getattr(slam, track)(grays, depths, stamps, chunk=chunk)
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / (n + 1)
    return rows, {k: v * 1e3 / n for k, v in slam.seq_phases.items()}, wall


def device_busy(slam_factory, frames, first: int = 10, n: int = 5, top: int = 10,
                track: str = "track_rgbd"):
    """(busy device ms per frame, kernels per frame, profiled wall ms per
    frame, the `top` kernels by device time as (name, ms per frame,
    launches per frame)) over frames first..first+n-1, traced by
    torch.profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    slam = slam_factory()
    for args in frames[:first]:
        getattr(slam, track)(*args)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for args in frames[first:first + n]:
            getattr(slam, track)(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    heavy = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n) for e in heavy]
    return busy_ms / n, sum(e.count for e in dev) / n, wall_ms / n, kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=31)
    ap.add_argument("--json", default=None, help="also write the rows here")
    ap.add_argument("--sequence", action="store_true",
                    help="profile track_sequence instead of track_rgbd")
    ap.add_argument("--loop", action="store_true",
                    help="profile track_sequence over the loop world (130 frames)")
    ap.add_argument("--stereo", action="store_true",
                    help="profile track_stereo (track_sequence_stereo with --sequence)")
    ap.add_argument("--mono", action="store_true",
                    help="profile track_monocular and a handed-in correct_loop_sim3")
    ap.add_argument("--chunk", type=int, default=15)
    args = ap.parse_args()
    if args.loop:
        args.sequence, args.frames = True, 130
    if (args.stereo and not args.sequence) or args.mono:
        args.frames = 24 if args.stereo else 30
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 1
    from ..config import LoopConfig, SLAMConfig
    from ..geometry.camera import TUM3
    from ..utils.synthetic import SyntheticWorld

    track, skip = "track_rgbd", 3
    if (args.stereo and not args.sequence) or args.mono:
        world = SyntheticWorld(cam=TUM3, n_frames=args.frames,
                               n_static=900 if args.stereo else 700, n_dynamic=0,
                               seed=11 if args.stereo else 19, trajectory="line",
                               pixel_noise=0.0, depth_noise=0.0)
    elif args.loop:
        world = SyntheticWorld(cam=TUM3, n_frames=args.frames, n_static=900, n_dynamic=0,
                               seed=5, trajectory="pan", wall=True, pan_leadin=0.1,
                               pan_turns=1.2, pan_translation=0.25,
                               render_depth_noise=0.015)
    else:
        world = SyntheticWorld(cam=TUM3, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                               trajectory="line", billboard=True, bb_speed=0.04)
    frames = []
    for k in range(args.frames):
        f = world.frame(k, render=True)
        if args.stereo:     # the right eye in place of the depth
            frames.append((f.image, world.right_eye(k), f.timestamp))
        elif args.mono:
            frames.append((f.image, f.timestamp))
        else:
            frames.append((f.image, f.depth_image, f.timestamp))
    if args.stereo:
        track = "track_sequence_stereo" if args.sequence else "track_stereo"
    elif args.mono:
        track, skip = "track_monocular", 1
    cfg = (SLAMConfig() if args.sequence or args.stereo or args.mono
           else SLAMConfig(loop=LoopConfig(enabled=False)))

    def make():
        return system.SLAMSystem(TUM3, cfg, enable_mapping=True, enable_crf=True,
                                 device="cuda")

    header = f"{'stage':24s} {'calls':>6s} {'ms/call':>10s} {'ms/frame':>10s} {'ops/call':>10s}"
    if args.sequence:
        rows, phases, wall = profile_sequence(
            make, np.stack([f[0] for f in frames]).astype(np.float32),
            np.stack([f[1] for f in frames]).astype(np.float32),
            [f[2] for f in frames], args.chunk,
            "track_sequence_stereo" if args.stereo else "track_sequence")
        print(f"{torch.cuda.get_device_name(0)}, {track if args.stereo else 'track_sequence'} over {args.frames} "
              f"frames, chunk {args.chunk}: {wall:.2f} ms/frame unsynchronised")
        print("seq_phases, host ms per chunked frame: "
              + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
        print(header)
        for row, (c, per_call, per_frame, n_ops) in rows.items():
            print(f"{row:24s} {c:6d} {per_call:10.2f} {per_frame:10.2f} {n_ops:10.0f}")
        if args.json:
            with open(args.json, "w") as fh:
                json.dump({"device": torch.cuda.get_device_name(0), "rows": rows,
                           "seq_phases_ms": phases, "ms_per_frame": wall}, fh, indent=1)
        return 0

    kept: list = []
    rows = profile(make, frames, skip=skip, track=track, keep=kept)
    if args.mono:
        rows.update(profile_closure(kept[0]))
    busy, kernels, traced, heavy = device_busy(make, frames, track=track)
    frame_ms = rows["(frame)"][1]
    print(f"{torch.cuda.get_device_name(0)}, {track} over {args.frames} frames, "
          f"stages from frame {skip + 1}")
    print(f"frames 10-14 traced: device busy {busy:.2f} ms/frame, {kernels:.0f} "
          f"kernels/frame, profiled wall {traced:.2f} ms/frame; idle share "
          f"{1 - busy / traced:.3f} profiled, {1 - busy / frame_ms:.3f} of the "
          f"unprofiled {frame_ms:.2f} ms/frame")
    print("heaviest device kernels, frames 10-14 (ms/frame, launches/frame):")
    for name, k_ms, k_n in heavy:
        print(f"  {k_ms:8.3f} {k_n:8.1f}  {name[:110]}")
    print(header)
    for row, (c, per_call, per_frame, n_ops) in rows.items():
        print(f"{row:24s} {c:6d} {per_call:10.2f} {per_frame:10.2f} {n_ops:10.0f}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"device": torch.cuda.get_device_name(0), "rows": rows,
                       "busy_ms": busy, "kernels": kernels, "traced_ms": traced,
                       "heaviest": heavy}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
