"""Command-line entry point of the port: the `rgbd_tum` equivalent
(counterpart of lc_crf_slam_tpu/run_slam.py).

Usage:
  # a TUM RGB-D sequence directory:
  python -m lc_crf_slam_torch.run_slam --seq DIR [--assoc FILE]
      [--camera tum1|tum2|tum3|bonn] [--config cfg.yaml] [--device cuda|cpu]
      [--throughput [--chunk N]] [--checkpoint FILE | --resume FILE]
      [--profile DIR] [--timing] [--log run.jsonl] [--out traj.txt]

  # a synthetic sequence (no dataset needed):
  python -m lc_crf_slam_torch.run_slam --synthetic [--frames N]
      [--dynamic N] [--render] [--out traj.txt]

Writes the TUM-format trajectory and keyframe trajectory, the per-frame
JSONL log, optionally a map plot and a checkpoint, and prints one JSON
summary line (with ATE when ground truth is available). The system runs
on the card unless `--device cpu` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

from .geometry.camera import BONN, TUM1, TUM2, TUM3

CAMERAS = {"tum1": TUM1, "tum2": TUM2, "tum3": TUM3, "bonn": BONN}
THROUGHPUT_WINDOW = 64     # frames handed to track_sequence at a time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--seq", help="TUM RGB-D sequence directory")
    src.add_argument("--synthetic", action="store_true",
                     help="run on a synthetic sequence")
    ap.add_argument("--assoc", help="association file (else associates "
                    "rgb.txt/depth.txt)")
    ap.add_argument("--camera", default="tum3", choices=sorted(CAMERAS))
    ap.add_argument("--config", help="config file (section.key: value)")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--log", default=None, help="per-frame JSONL log path")
    ap.add_argument("--viz", default=None, help="write map plot PNG here")
    ap.add_argument("--checkpoint", default=None, help="save map state here")
    ap.add_argument("--resume", default=None, help="resume from checkpoint")
    ap.add_argument("--frames", type=int, default=120,
                    help="synthetic sequence length")
    ap.add_argument("--dynamic", type=int, default=120,
                    help="synthetic dynamic point count")
    ap.add_argument("--render", action="store_true",
                    help="synthetic: run the full image front-end instead "
                    "of direct observations")
    ap.add_argument("--mono", action="store_true",
                    help="monocular mode (mono_tum equivalent): ignore "
                    "depth, bootstrap via two-view initialization")
    ap.add_argument("--no-crf", action="store_true")
    ap.add_argument("--no-mapping", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: raises without a card)")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace to this directory")
    ap.add_argument("--timing", action="store_true",
                    help="print the per-stage timing table at the end")
    ap.add_argument("--throughput", action="store_true",
                    help="batch frames through track_sequence (chunked "
                    "front-end, one packed fetch a chunk) instead of "
                    "per-frame calls")
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per chunk in --throughput mode")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-device run (not ported: raises)")
    return ap


def _run_throughput_stream(slam, frames_iter, n, chunk, window=THROUGHPUT_WINDOW):
    """Feed a (t, gray, depth) stream through track_sequence in windows of
    `window` frames: bounds host memory on long sequences while each
    window still runs in chunks."""
    buf, done = [], 0

    def flush():
        slam.track_sequence(np.stack([g for _, g, _ in buf]).astype(np.float32),
                            np.stack([d for _, _, d in buf]).astype(np.float32),
                            np.asarray([t for t, _, _ in buf]), chunk=chunk)

    for item in frames_iter:
        buf.append(item)
        if len(buf) == window:
            flush()
            done += len(buf)
            print(f"frame {done}/{n}", file=sys.stderr)
            buf = []
    if buf:
        flush()


def _run_stream(slam, frames_iter, n, mono: bool) -> None:
    for k, (t, gray, depth) in enumerate(frames_iter):
        if mono:
            slam.track_monocular(gray, t)
        else:
            slam.track_rgbd(gray, depth, t)
        if k % 50 == 0:
            print(f"frame {k}/{n}", file=sys.stderr)


def _run_sequence(slam, args, cfg, cam):
    """Track a TUM sequence directory: the native prefetching loader when
    it builds and loads here, else `TUMSequence`; returns the ground
    truth (timestamps, Twc) when the directory has one."""
    from .utils.io_tum import TUMSequence, load_groundtruth, poses_from_tum
    from .utils.native_loader import NativeTUMLoader, build_native_runtime

    seq = TUMSequence(args.seq, args.assoc, cfg.tracking.depth_map_factor)
    n = min(len(seq), args.max_frames or len(seq))
    loader = None
    if build_native_runtime():
        entries = [(t_rgb, os.path.join(args.seq, rp), t_d, os.path.join(args.seq, dp))
                   for t_rgb, rp, t_d, dp in seq.entries[:n]]
        loader = NativeTUMLoader(entries, cam.width, cam.height,
                                 cfg.tracking.depth_map_factor)
        frames = iter(loader)
        print("using native prefetching loader", file=sys.stderr)
    else:
        frames = (seq[k] for k in range(n))
        print("using the Python loader (TUMSequence)", file=sys.stderr)
    try:
        if args.throughput and not args.mono:
            _run_throughput_stream(slam, frames, n, args.chunk)
        else:
            _run_stream(slam, frames, n, args.mono)
    finally:
        if loader is not None:
            loader.close()
    gt_path = os.path.join(args.seq, "groundtruth.txt")
    if not os.path.exists(gt_path):
        return None
    ts_g, vals = load_groundtruth(gt_path)
    return ts_g, poses_from_tum(vals)


def _run_synthetic(slam, args, cam):
    from .utils.synthetic import SyntheticWorld

    world = SyntheticWorld(cam=cam, n_frames=args.frames, n_static=900,
                           n_dynamic=args.dynamic)
    n = min(args.max_frames or args.frames, args.frames)
    if args.mono:
        for k in range(n):
            f = world.frame(k, render=True)
            slam.track_monocular(f.image, f.timestamp)
    elif args.throughput and args.render:
        fs = [world.frame(k, render=True) for k in range(n)]
        slam.track_sequence(np.stack([f.image for f in fs]).astype(np.float32),
                            np.stack([f.depth_image for f in fs]).astype(np.float32),
                            np.asarray([f.timestamp for f in fs]), chunk=args.chunk)
    else:
        for k in range(n):
            f = world.frame(k, render=args.render)
            if args.render:
                slam.track_rgbd(f.image, f.depth_image, f.timestamp)
            else:
                slam.track_observations(f.uv, f.depth, f.desc, f.timestamp)
    return world.groundtruth()


def lost_frames(stats) -> int:
    """Frames without a tracked pose: the frame records whose status is
    not 1 (the first record, the map's initialisation, aside; a monocular
    frame before the initialisation has none) and the lost frames each
    chunk reports. Records of other events are not frames."""
    n = 0
    for s in stats[1:]:
        if s.get("event") == "chunk_lost":
            n += s["lost_frames"]
        elif s.get("event") not in ("chunk_reloc", "capacity_full") and s.get("status") != 1:
            n += 1
    return n


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: the multi-device path (parallel/, SLAMSystem(mesh=)) "
            "is not ported to lc_crf_slam_torch")

    from .config import SLAMConfig, load_yaml
    from .models.system import SLAMSystem
    from .utils.evaluate import evaluate_ate

    cam = CAMERAS[args.camera]
    cfg = load_yaml(args.config) if args.config else SLAMConfig()
    if args.mono and cfg.loop.fix_scale:
        # monocular scale is unobservable: loop closing runs the Sim(3)
        # essential graph (the reference's bFixScale=false for MONOCULAR)
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, fix_scale=False))

    slam = SLAMSystem(cam, cfg, log_path=args.log, enable_mapping=not args.no_mapping,
                      enable_crf=not args.no_crf, device=args.device)
    slam.enable_loop = not args.no_loop
    if args.resume:
        from .utils.checkpoint import load_checkpoint

        m, ts, meta = load_checkpoint(args.resume, device=slam.device)
        slam.restore(m, ts, meta.get("trajectory", ()), meta.get("kf_log", ()))
        print(f"resumed from {args.resume} ({len(slam.trajectory)} prior frames)",
              file=sys.stderr)

    with contextlib.ExitStack() as profiling:
        if args.profile:
            from .utils.profiling import trace

            profiling.enter_context(trace(args.profile))
        t_start = time.perf_counter()
        gt = (_run_synthetic(slam, args, cam) if args.synthetic
              else _run_sequence(slam, args, cfg, cam))
        wall = time.perf_counter() - t_start
        slam.flush_stats()
    if args.timing:
        print(slam.timer.report(), file=sys.stderr)
    slam.save_trajectory_tum(args.out)
    slam.save_keyframe_trajectory_tum(args.kf_out)
    ts_est, poses_est = slam.get_trajectory()
    n_frames = len(ts_est)
    summary = {
        "frames": n_frames,
        "fps": round(n_frames / wall, 2),
        "keyframes": int(slam.map.n_kfs),
        "points": int(slam.map.n_points),
        "loops_closed": len(slam.loop_log),
        "lost_frames": lost_frames(slam.stats),
    }
    if gt is not None:
        # monocular estimates are up to scale: Umeyama with scale (the
        # TUM protocol's monocular convention)
        ate = evaluate_ate(ts_est, poses_est, gt[0], gt[1], with_scale=args.mono)
        summary["ate_rmse_m"] = round(ate.rmse, 4)
        summary["ate_median_m"] = round(ate.median, 4)
    if args.viz:
        from .utils.viewer import plot_map

        plot_map(slam.map, args.viz, trajectory=poses_est,
                 groundtruth=gt[1] if gt is not None else None)
    if args.checkpoint:
        from .utils.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, slam.map, slam.ts,
                        trajectory=slam.trajectory, kf_log=slam.kf_log)
    print(json.dumps(summary))
    slam.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
