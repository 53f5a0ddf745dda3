"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch build.
2. Builds both FAST CUDA kernels from lc_crf_slam_torch/csrc/ (one nvcc
   process per source, started together).
3. Holds each kernel against its plain PyTorch version and times both
   with CUDA events:
   - `fast_nms_dual` (both NMS'd score maps of one level): bitwise on the
     8 pyramid levels of a rendered TUM3 frame and on two random images
     (200x300, not a multiple of the tile; 256x256);
   - `fast_cell_best` (FAST + NMS + best corner per 16-px cell, all levels
     of all frames of a batch in one launch): `best` bitwise, `y` and `x`
     exact, at B=1 (the 8 levels of a rendered frame), B=2 (a stereo pair),
     B=8 (the command line's chunk), B=15 (a chunk of rendered frames) and
     B=30 (a stereo chunk: 15 left and 15 right eyes).
4. Tracking phase: SLAMSystem.track_rgbd with mapping and the CRF off on
   31 rendered 640x480 frames of a 600-point static world, default map
   capacities (32768 points, 320 keyframes, 1024 features). Checks one
   fused FAST launch per frame, no lost frame, keyframes made, ATE < 1 cm.
5. Dynamic phase: the per-frame dynamic pipeline (mapping and the CRF on,
   loop closing off) on bench.py's billboard world (a rigid textured
   mover crossing a 1400-point static scene), frames 0-30. Checks one
   fused launch per frame, no frame lost, >= 2 keyframes, one mapping_step
   per keyframe, one crf_step per frame after the first, ATE < 2 cm, and
   1 host sync on a non-keyframe frame (torch's sync debug mode).
6. Sequence phase: the chunked throughput path on the same frames with the
   default SLAMConfig (loop detection on):
   `SLAMSystem.track_sequence(grays, depths, timestamps, chunk=15)`.
   Checks 0 lost frames, ATE < 2 cm, >= 2 keyframes, one mapping_step and
   one detect_loop per in-chunk keyframe, one crf_step per chunk,
   1 + chunks fused launches, and at most frames + 1 host syncs inside a
   chunk. Prints ms/frame over the 30 chunked frames beside the dynamic
   phase's, the seq_phases split and peak memory.
7. Loop phase: the reference's default-config loop world (a 1.2-turn pan
   over a textured wall with depth noise) at 640x480, 130 frames, default
   SLAMConfig and map capacities, through `track_sequence(chunk=15)`. The
   revisit must close a loop: checks >= 1 entry in `loop_log`, finite
   poses, >= 1 global-BA slice run and none pending after
   `get_trajectory()`, every live point's observation count equal to the
   recount of the observation table, ATE < 0.35 m, the keyframes'
   ATE after the closure no worse than 1.1 x the same keyframes' just
   before the first `correct_loop`, 1 + chunks fused launches, and at
   most frames + 1 host syncs per chunk plus one per verified candidate
   (and three per relocalisation attempt). Lost frames: none before the
   first closure, and tracking is back by the end. A closure re-anchors
   the tracker on its reference keyframe's pose with zero velocity, as
   the reference does; inside a chunk that keyframe lies a few frames
   (~10 degrees of this pan) back, the next chunk loses track, and
   relocalisation recovers it at a chunk boundary (the reference loses
   the same chunk: tests/test_torch_loop_close.py, slow). Those frames
   are counted and printed, not hidden.
   Prints, each line beside the card's name and power limit: ms/frame,
   the ms of every `verify_loop`, `correct_loop`, `global_ba` slice and
   group-wide `search_and_fuse` (a synchronize on both sides), `loop_log`,
   keyframes, both ATEs and peak memory.
   Each phase sets the wrappers' launch counts to 0 just before it drives
   its path and reads them just after: the map kernel is off every path
   and must count 0 there.
8. Stereo phase: `SLAMSystem.track_stereo` with the default SLAMConfig on
   tests/test_mono_stereo_e2e.py's stereo world (24 TUM3 frames, 900
   points, the right eye rendered one baseline bf / fx along camera x).
   Checks 0 lost frames, ATE < 0.05 m (the reference's bar), >= 3
   keyframes, one fused launch a frame (both eyes in one batch), 1 host
   sync on a non-keyframe frame.
9. Stereo sequence phase: bench.py's stereo run, the dynamic phase's
   billboard frames 0-30 with their right eyes through
   `track_sequence_stereo(..., chunk=15)`, mapping and the CRF on, the
   default config. Checks 0 lost frames, ATE < 0.05 m, >= 2 keyframes,
   1 + chunks fused launches, at most frames + 1 host syncs a chunk;
   prints ms/frame beside the sequence phase's.
10. Monocular phase: tests/test_mono_stereo_e2e.py's monocular world (30
   TUM3 frames, 700 points) through `track_monocular`, default config.
   Checks the reference test's: a `mono_init` event, initialized, > 60
   map points, finite poses after the initialisation; and one fused
   launch a frame, the design's host syncs on the frames before the
   initialisation (1 on the reference frame, 2 on a failed attempt, 3 on
   the initialising frame) and 1 on a non-keyframe frame after it. Prints
   the initialising frame, the Python line behind each host sync up to
   it, keyframes, lost frames after it and the scale-aligned ATE.
11. Sim(3) closure stage: on the map the monocular phase leaves,
   `correct_loop_sim3` is handed a closure between its newest keyframe
   and keyframe 0 (s_corr = 0.8, a small rotation and shift), on the
   card and on a CPU copy of the same map. Checks `kf_Tcw` and the live
   points' `p_xyz` agree to 1e-3, the same live points, and no host sync
   inside; prints the ms of two calls on the card and one on the CPU,
   each with a synchronize on both sides. (The reference's own mono loop
   world never fires a closure, so the closure is handed in.)
12. TUM phase: the tracking world's first 16 frames exported as a TUM
   RGB-D directory (`SyntheticWorld.export_tum_sequence`), its timestamps
   shifted to Unix seconds (from 1305031102.175304 s), run through the
   command line in this process: `run_slam.main(["--seq", DIR, "--device",
   "cuda", "--log", ..., "--checkpoint", ..., "--timing"])`, then
   `--throughput --chunk 8` on the same directory, and `--throughput
   --chunk 8 --profile DIR` over its first 3 frames (a trace of all 16 is
   ~1.2 GiB). Checks exit 0, 16 frames, 0 lost, ATE < 1 cm (`evaluate_ate`
   against the exported groundtruth.txt), one JSONL line per record, every
   keyframe time within 1e-4 s of a frame time, fused launches 16 per
   frame and 1 + chunks chunked, the profile trace naming the fused
   kernel; then a
   system restored from the checkpoint (`load_checkpoint(device="cuda")`)
   tracks frames 16-19 with none lost. Prints the loader used, the stage
   table and ms/frame.
13. Localization phase: tests/test_localization_mode.py's world at
   640x480 (an orbit over 900 points, seed 5, 40 frames) through
   `track_rgbd`, default config: frames 0-19 map, 20-33 run in
   localisation mode with frames 26-27 black, 34-39 map. Checks keyframes,
   live points and mapping passes unchanged over 20-33, the black frames
   the only lost ones and tracking back (relocalisation) within 2 frames,
   ATE < 0.02 m over the other frames, one fused launch a frame.
14. Direct-descriptor stage: the tracking phase's first 8 frames through
   `track_rgbd` with `orb.descriptor_variant="direct"` (the reference's
   computeOrbDescriptor semantics). Checks one fused launch a frame, no
   lost frame, ATE < 1 cm; prints the ATE.
15. Distributed phase (lc_crf_slam_torch/parallel/), default config:
   (a) `init_distributed` joins a world of one NCCL rank on the card, and
   the "edge" mesh is that rank;
   (b) the sequence phase's frames through `SLAMSystem(mesh=...)` with a
   "frames" mesh of two shards (the card listed twice, or every visible
   card when there are two or more), chunk 15: each shard builds its
   frames (one fused launch a shard) and runs its forward flow; beside
   it the same frames with `mesh=None`, both with torch's deterministic
   algorithms (local BA's float atomics make two runs of one path drift
   apart). Checks the same keyframes, camera centres within 1e-4 m,
   fused launches 1 + shards x chunks, at most frames + 1 host syncs a
   chunk;
   (c) on the loop phase's final map at full capacity (320 keyframes,
   32768 points), `dist_solve_ba` and `dist_solve_ba_blocks` against
   `solve_ba`, 10 iterations each, timed with the default algorithms
   and compared with deterministic ones: live keyframes' translations
   within 1e-4 m, live points within 1e-3;
   (d) on that map's CRF tracks, `dist_knn_graph` + `dist_mean_field`
   against `knn_graph` + `mean_field`: neighbours equal, weights and
   q_dyn within 1e-6.
   Prints each stage's ms and the phase's peak memory beside the card's
   name and power limit.
16. Prints the kernel report as one JSON line (`launches` = the paths'
   own, the kernel checks' launches apart), the card line again, and
   last `{"ok": true, "device": {...}}`.

Any failure raises, and the exit code is then non-zero. Without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 31
ATE_BAR_M = 0.01
DYN_FRAMES = 31
DYN_ATE_BAR_M = 0.02      # the reference's bar for its full pipeline
SEQ_CHUNK = 15
LOOP_FRAMES = 130
LOOP_ATE_BAR_M = 0.35     # the reference's bar for this world in throughput mode
LOOP_KF_ATE_FACTOR = 1.1  # keyframes' ATE after the closure vs just before it
STEREO_FRAMES = 24
STEREO_ATE_BAR_M = 0.05   # the reference's bar (tests/test_mono_stereo_e2e.py)
MONO_FRAMES = 30
# host reads of a monocular frame before the map exists, by its event: the
# reference frame's feature count; the eight-point solver's status and the
# verdict with the match count; and on success the map's point count
MONO_INIT_READS = {"mono_wait": 1, "mono_init_fail": 2, "mono_init": 3}
SIM3_S_CORR = 0.8
SIM3_TOL = 1e-3           # card vs CPU after correct_loop_sim3: poses, metres
TUM_FRAMES = 16
TUM_OFFSET_S = 1305031102.175304   # a TUM sequence's first Unix timestamp
TUM_CHUNK = 8
# the profiled chunked run: the first frame and one chunk of 2 (a trace of
# all 16 frames is ~1.2 GiB, most of a minute to write)
TUM_PROFILE_FRAMES = 3
TUM_RESUME_FRAMES = 4
KF_TIME_TOL_S = 1e-4
LOC_FRAMES = 40           # tests/test_localization_mode.py's schedule
LOC_START, LOC_END = 20, 34
LOC_BLACK = (26, 27)      # black frames inside the localised stretch
LOC_RECOVER = 2           # frames after the last black one to be tracked again
LOC_ATE_BAR_M = 0.02      # the reference test's bar
DIRECT_FRAMES = 8         # tracking-world frames with the "direct" descriptor
DIST_SHARDS = 2           # the frames mesh on one card: the card listed twice
DIST_CAM_TOL_M = 1e-4     # the reference's bars (tests/test_dist.py)
DIST_PT_TOL = 1e-3
DIST_CRF_TOL = 1e-6
DIST_BA_ITERS = 10        # solve_ba's default
# The JAX reference on the same 31 frames, measured on the CPU with
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dynamic_slice.py \
#       -m slow -k full_size -s
# (this script imports no jax, so the number is a constant here)
REF_DYN_ATE_M = 0.00169054956667069

# The card's published peaks (H100 SXM data sheet): memory rate, and
# float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float32 operations the function needs on a given input. Every pixel: the
# 4-pixel compass test at the low threshold, 2 (I +- t) + 4 x 2 compares +
# 2 to combine (a pixel that fails it scores 0 at both thresholds). Every
# pixel whose score comes out non-zero, per threshold: the full test, 2 +
# 16 circle pixels x (2 compares, 2 x 2 subtractions, 2 adds) + 3 (arc
# select, max), and 10 for the 3x3 NMS. The non-zero outputs of a run are
# counted from its plain version's result.
OPS_COMPASS = 2 + 4 * 2 + 2
OPS_FULL = 2 + 16 * 8 + 3 + 10


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, *args, batches: int = 20, reps: int = 10):
    """(device ms, host-bound ms) of one call, each the median of
    `batches` CUDA-event timings of `reps` back-to-back calls.

    Device time: a spin kernel holds the stream while the batch is
    enqueued, so the events bracket only the GPU's own work. Host-bound
    time: no spin, so the gaps while Python enqueues each call count too
    (what a caller that launches one level at a time pays)."""
    for _ in range(min(3, batches)):
        fn(*args)
    out = []
    for spin in (True, False):
        times = []
        for _ in range(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            if spin:
                torch.cuda._sleep(50_000_000)   # ~25 ms of GPU clock cycles
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        out.append(statistics.median(times))
    return tuple(out)


def bound(n_bytes: float, n_pixels: int, n_scored: int):
    """(least ms the card could take, what sets it): the larger of the
    bytes (each input read once, each output written once) over the memory
    rate and the operations (compass test on `n_pixels`, full test on the
    `n_scored` non-zero scores of this run) over the float32 rate."""
    n_ops = OPS_COMPASS * n_pixels + OPS_FULL * n_scored
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_fast_kernel(images):
    """Map kernel vs plain version on each image: bitwise equality, times."""
    from lc_crf_slam_torch.ops.fast import fast_score_dual
    from lc_crf_slam_torch.ops.fast_kernel import fast_score_dual_cuda

    rows = []
    for name, img in images:
        hi, lo = fast_score_dual_cuda(img, 20.0, 7.0)
        ph, pl = fast_score_dual(img, 20.0, 7.0)
        torch.cuda.synchronize()
        n_scored = int((ph > 0).sum()) + int((pl > 0).sum())
        err = max(float((hi - ph).abs().max()), float((lo - pl).abs().max()))
        if not (torch.equal(hi, ph) and torch.equal(lo, pl)):
            raise AssertionError(f"FAST kernel != plain version on {name}: "
                                 f"max abs err {err}")
        ms, host_ms = cuda_ms(fast_score_dual_cuda, img, 20.0, 7.0)
        plain_ms, plain_host_ms = cuda_ms(fast_score_dual, img, 20.0, 7.0,
                                          batches=5, reps=2)
        rows.append((name, tuple(img.shape), err, ms, plain_ms, n_scored))
        print(f"fast_nms {name:>13} {tuple(img.shape)}: bitwise equal; device "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; host-bound kernel "
              f"{host_ms:.4f} ms, plain {plain_host_ms:.4f} ms")
    return rows


def check_cell_kernel(name, grays, cfg):
    """Fused kernel vs plain version on the pyramids of `grays` (B, H, W):
    `best` bitwise, `y`/`x` exact; times of both. Returns a report row."""
    from lc_crf_slam_torch.ops.fast_kernel import (fast_cell_best_cuda,
                                                   fast_cell_best_plain)
    from lc_crf_slam_torch.ops.pyramid import build_pyramid_batch

    orb = cfg.orb
    pyr = build_pyramid_batch(grays, orb.n_levels, orb.scale_factor)
    args = (pyr, float(orb.ini_th_fast), float(orb.min_th_fast), orb.cell_size,
            orb.edge_margin)
    out = fast_cell_best_cuda(*args)
    ref = fast_cell_best_plain(*args)
    torch.cuda.synchronize()
    err, n_cells, n_corners = 0.0, 0, 0     # corners: cells with a non-zero best
    for l, (o, r) in enumerate(zip(out, ref)):
        err = max(err, float((o[0] - r[0]).abs().max()))
        for what, a, b in zip(("best", "y", "x"), o, r):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"fused FAST kernel != plain version on {name}, "
                                     f"level {l}, {what}: max abs err of best {err}")
        n_cells += o[0].numel()
        n_corners += int((o[0] > 0).sum())
    B = grays.shape[0]
    ms, host_ms = cuda_ms(fast_cell_best_cuda, *args)
    plain_ms, _ = cuda_ms(fast_cell_best_plain, *args, batches=3,
                          reps=2 if B == 1 else 1)
    n_pixels = pyr.flat.numel()
    b_ms, b_by = bound(4 * n_pixels + 12 * n_cells, n_pixels, n_corners)
    print(f"fast_cells {name} (B={B}, {n_pixels} pixels, {n_cells} cells, "
          f"{n_corners} with a corner): best bitwise equal, y/x equal; device "
          f"kernel {ms:.4f} ms ({ms / B:.4f} a frame), host-bound {host_ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms; bound {b_ms:.5f} ms by {b_by}")
    return {"B": B, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def ate_rmse(ts_est, est_twc, ts_gt, gt_twc, with_scale: bool = False) -> float:
    """ATE RMSE by the TUM protocol (`utils/evaluate.evaluate_ate`: frames
    paired by timestamp, Umeyama-aligned)."""
    from lc_crf_slam_torch.utils.evaluate import evaluate_ate

    return evaluate_ate(ts_est, est_twc, ts_gt, gt_twc, with_scale=with_scale).rmse


def count_syncs(caught) -> int:
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def sync_sites(caught) -> list:
    """file:line (relative to the repo) of the Python call behind each host
    sync that torch's sync debug mode reported."""
    return [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


def path_launches():
    """(fused, map) kernel launches since `fast_kernel.reset_launches()`."""
    from lc_crf_slam_torch.ops import fast_kernel
    return fast_kernel.cell_launches, fast_kernel.launches


def drive(slam, frames, counted, track=None, sites=None):
    """Every frame through `track(frame)` (default `slam.track_rgbd`), each
    timed to a synchronize: (ms per frame, {frame: host syncs} for the
    frames in `counted`, counted in torch's sync debug mode, (fused, map)
    kernel launches of the path, peak device MiB). A dict `sites` fills
    with each counted frame's `sync_sites`."""
    track = track or (lambda f: slam.track_rgbd(f.image, f.depth_image, f.timestamp))
    from lc_crf_slam_torch.ops import fast_kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_kernel.reset_launches()
    frame_ms, syncs = [], {}
    for k, f in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn" if k in counted else "default")
            t0 = time.perf_counter()
            track(f)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        if k in counted:
            syncs[k] = count_syncs(caught)
            if sites is not None:
                sites[k] = sync_sites(caught)
    return (frame_ms, syncs, path_launches(),
            torch.cuda.max_memory_allocated() / 2**20)


def check_launches(phase, got, n_fused):
    """`got` = (fused, map) launches of a phase's path: the fused kernel as
    often as the path asks for it, the map kernel never."""
    if got != (n_fused, 0):
        raise AssertionError(
            f"{phase}: kernel launches (fused, map) = {got}, expected "
            f"({n_fused}, 0)")


def tracking_phase(cam, frames, world) -> int:
    """The tracking slice at full width (see the module docstring, step 4);
    returns the path's fused-kernel launches."""
    from lc_crf_slam_torch.config import LoopConfig, SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem

    cfg = SLAMConfig(loop=LoopConfig(enabled=False))
    slam = SLAMSystem(cam, cfg, enable_mapping=False, enable_crf=False,
                      device="cuda")
    # frames 10-11 count their host syncs (the design has one: the
    # keyframe decision fetch)
    frame_ms, syncs, got, peak_mb = drive(slam, frames, (10, 11))

    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    if poses.shape != (N_FRAMES, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"bad trajectory: shape {poses.shape}")
    ate = ate_rmse(ts, poses, gt_t, gt)
    statuses = [s.get("status", 1) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    inliers = [s["n_inliers"] for s in slam.stats if "n_inliers" in s]
    med = statistics.median(frame_ms[3:])
    print(f"slice: {N_FRAMES} frames, median {med:.2f} ms/frame after the "
          f"first 3 ({1e3 / med:.1f} fps), first frame {frame_ms[0]:.1f} ms, "
          f"ATE {ate:.5f} m, keyframes {n_kfs}, mean inliers "
          f"{np.mean(inliers):.1f}, lost frames {statuses.count(2)}, "
          f"kernel launches (fused, map) {got}, peak memory {peak_mb:.0f} MiB, "
          f"host syncs per frame {list(syncs.values())}")
    check_launches("tracking phase", got, N_FRAMES)
    if 2 in statuses:
        raise AssertionError(f"tracking lost: statuses {statuses}")
    if n_kfs < 2:
        raise AssertionError(f"only {n_kfs} keyframes")
    if not ate < ATE_BAR_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_BAR_M} m")
    return got[0]


def dynamic_phase(cam, frames, world):
    """The per-frame dynamic pipeline at full width (see the module
    docstring, step 5); returns (the path's fused-kernel launches, its
    mean ms/frame after the first frame)."""
    from lc_crf_slam_torch.config import LoopConfig, SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem

    cfg = SLAMConfig(loop=LoopConfig(enabled=False))
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True,
                      device="cuda")
    # from the 4th frame on, count every frame's host syncs
    frame_ms, syncs, got, peak_mb = drive(slam, frames, range(3, DYN_FRAMES))

    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    if poses.shape != (DYN_FRAMES, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"dynamic phase: bad trajectory, shape {poses.shape}")
    ate = ate_rmse(ts, poses, gt_t, gt)
    statuses = [s.get("status", 1) for s in slam.stats]
    is_kf = [bool(s.get("need_kf")) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    kf_ms = [t for t, kf in zip(frame_ms[3:], is_kf[3:]) if kf]
    other_ms = [t for t, kf in zip(frame_ms[3:], is_kf[3:]) if not kf]
    kf_at = [k for k in range(3, DYN_FRAMES) if is_kf[k]]
    other_at = [k for k in range(3, DYN_FRAMES) if not is_kf[k]]
    last = slam.stats[-1]
    med = statistics.median(frame_ms[3:])
    print(f"dynamic: {DYN_FRAMES} frames, median {med:.2f} "
          f"ms/frame after the first 3 (keyframe frames {statistics.median(kf_ms):.2f} "
          f"over {len(kf_ms)}, other frames {statistics.median(other_ms):.2f} over "
          f"{len(other_ms)}), mean of frames 1-{DYN_FRAMES - 1} {np.mean(frame_ms[1:]):.2f}, "
          f"first frame {frame_ms[0]:.1f} ms")
    print(f"dynamic: ATE {ate:.5f} m (JAX reference on the same frames, CPU: "
          f"{REF_DYN_ATE_M:.5f} m), keyframes {n_kfs}, lost frames "
          f"{statuses.count(2)}, mapping_step calls {slam.n_mapping_steps}, "
          f"crf_step calls {slam.n_crf_steps}, kernel launches (fused, map) {got}, "
          f"peak memory {peak_mb:.0f} MiB")
    print(f"dynamic: host syncs on keyframe frame {kf_at[0]}: {syncs[kf_at[0]]}, on "
          f"non-keyframe frame {other_at[0]}: {syncs[other_at[0]]}; per frame "
          f"from the 4th {list(syncs.values())}")
    print(f"dynamic: last frame n_dynamic {last['n_dynamic']}, n_tracks "
          f"{last['crf_tracks']}")
    check_launches("dynamic phase", got, DYN_FRAMES)
    if 2 in statuses:
        raise AssertionError(f"dynamic phase: tracking lost: statuses {statuses}")
    if n_kfs < 2:
        raise AssertionError(f"dynamic phase: only {n_kfs} keyframes")
    if slam.n_mapping_steps != sum(is_kf) or slam.n_mapping_steps != len(slam.kf_log):
        raise AssertionError(
            f"dynamic phase: {slam.n_mapping_steps} mapping_step calls for "
            f"{sum(is_kf)} keyframes")
    if slam.n_crf_steps != DYN_FRAMES - 1:
        raise AssertionError(f"dynamic phase: {slam.n_crf_steps} crf_step calls "
                             f"for {DYN_FRAMES - 1} frames after the first")
    if syncs[other_at[0]] != 1:
        raise AssertionError(f"dynamic phase: {syncs[other_at[0]]} host syncs on "
                             f"non-keyframe frame {other_at[0]}, expected 1")
    if not ate < DYN_ATE_BAR_M:
        raise AssertionError(f"dynamic phase: ATE {ate} m >= {DYN_ATE_BAR_M} m")
    return got[0], float(np.mean(frame_ms[1:]))


def count_chunks(slam) -> list:
    """Wrap `slam._track_chunk` so that every chunk runs in torch's sync
    debug mode and is timed to a synchronize; the returned list fills with
    (frames, host syncs, ms, (loop candidates verified, relocalisation
    attempts), the chunk's last frame if it closed a loop else None) per
    chunk."""
    chunks = []
    inner = slam._track_chunk

    def rare():
        return (slam.n_verify_loops, len(slam.loop_log),
                sum(s.get("event") == "chunk_lost" for s in slam.stats))

    def counted_chunk(g, d, t, *rest):
        torch.cuda.synchronize()
        before = rare()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                out = inner(g, d, t, *rest)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            after = rare()
            # a chunk that ends lost may try to relocalise at its boundary
            chunks.append((len(t), count_syncs(caught),
                           (time.perf_counter() - t0) * 1e3,
                           (after[0] - before[0], after[2] - before[2]),
                           round(float(t[-1]) * 30.0) if after[1] > before[1] else None))
        return out

    slam._track_chunk = counted_chunk
    return chunks


def sequence_phase(cam, frames, world, dyn_ms: float):
    """The chunked throughput path at full width (see the module
    docstring, step 6); returns (the path's fused-kernel launches, its
    ms/frame, its poses, its keyframe log)."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.ops import fast_kernel
    from lc_crf_slam_torch.models.system import SLAMSystem

    cfg = SLAMConfig()          # loop detection on
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True,
                      device="cuda")
    slam.seq_phases = {}
    grays = np.stack([f.image for f in frames]).astype(np.float32)
    depths = np.stack([f.depth_image for f in frames]).astype(np.float32)
    stamps = [f.timestamp for f in frames]

    chunks = count_chunks(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_kernel.reset_launches()
    poses_tcw = slam.track_sequence(grays, depths, stamps, chunk=SEQ_CHUNK)
    torch.cuda.synchronize()
    got = path_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    n_seq = DYN_FRAMES - 1      # the first frame goes through track_rgbd
    n_chunks = -(-n_seq // SEQ_CHUNK)
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    if poses.shape != (DYN_FRAMES, 4, 4) or not np.all(np.isfinite(poses)) \
            or poses_tcw.shape != (n_seq, 4, 4) or not np.all(np.isfinite(poses_tcw)):
        raise AssertionError(f"sequence phase: bad trajectory, shapes {poses.shape} "
                             f"{poses_tcw.shape}")
    ate = ate_rmse(ts, poses, gt_t, gt)
    n_lost = sum(s.get("lost_frames", 0) for s in slam.stats
                 if s.get("event") == "chunk_lost")
    n_kfs = int(slam.map.n_kfs)
    in_chunk_kfs = len(slam.kf_log)
    ms_frame = sum(c[2] for c in chunks) / n_seq
    total = sum(slam.seq_phases.values())
    split = ", ".join(f"{k} {v * 1e3 / n_seq:.2f}" for k, v in slam.seq_phases.items())
    print(f"sequence: {n_seq} chunked frames in {n_chunks} chunks of {SEQ_CHUNK}: "
          f"{ms_frame:.2f} ms/frame (chunks {[round(c[2], 1) for c in chunks]} ms); "
          f"the same world per frame through track_rgbd (dynamic phase, loop "
          f"detection off): {dyn_ms:.2f} ms/frame")
    print(f"sequence: seq_phases, host ms/frame: {split} (sum "
          f"{total * 1e3 / n_seq:.2f})")
    print(f"sequence: ATE {ate:.5f} m, keyframes {n_kfs} ({in_chunk_kfs} in chunks), "
          f"lost frames {n_lost}, mapping_step calls {slam.n_mapping_steps}, "
          f"detect_loop calls {slam.n_detect_loops}, crf_step calls "
          f"{slam.n_crf_steps}, kernel launches (fused, map) {got}, host syncs per "
          f"chunk {[c[1] for c in chunks]} for {[c[0] for c in chunks]} frames, "
          f"peak memory {peak_mb:.0f} MiB")
    check_launches("sequence phase", got, 1 + n_chunks)
    if n_lost or int(slam.ts.status) != 1:
        raise AssertionError(f"sequence phase: {n_lost} lost frames, final status "
                             f"{int(slam.ts.status)}")
    if n_kfs < 2:
        raise AssertionError(f"sequence phase: only {n_kfs} keyframes")
    if slam.n_mapping_steps != in_chunk_kfs or slam.n_detect_loops != in_chunk_kfs:
        raise AssertionError(
            f"sequence phase: {slam.n_mapping_steps} mapping_step and "
            f"{slam.n_detect_loops} detect_loop calls for {in_chunk_kfs} "
            f"in-chunk keyframes")
    if slam.n_crf_steps != n_chunks or len(chunks) != n_chunks:
        raise AssertionError(f"sequence phase: {slam.n_crf_steps} crf_step calls "
                             f"for {n_chunks} chunks")
    for n, syncs, *_ in chunks:
        if syncs > n + 1:
            raise AssertionError(f"sequence phase: {syncs} host syncs in a chunk "
                                 f"of {n} frames, at most {n + 1} allowed")
    if not ate < DYN_ATE_BAR_M:
        raise AssertionError(f"sequence phase: ATE {ate} m >= {DYN_ATE_BAR_M} m")
    return got[0], ms_frame, poses_tcw, slam.kf_log


def keyframe_ate(kf_Tcw, kf_time, which, gt_times, gt_twc) -> float:
    """ATE of the keyframes `which` (bool mask) against the ground truth
    at their timestamps."""
    Twc = np.linalg.inv(kf_Tcw[which].astype(np.float64))
    return ate_rmse(kf_time[which], Twc, gt_times, gt_twc)


def loop_phase(cam):
    """Loop closing at full width (see the module docstring, step 7);
    returns (the path's fused-kernel launches, its final map copied to the
    host, the tracker's frame index)."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models import system
    from lc_crf_slam_torch.ops import fast_kernel
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    t0 = time.perf_counter()
    world = SyntheticWorld(cam=cam, n_frames=LOOP_FRAMES, n_static=900, n_dynamic=0,
                           seed=5, trajectory="pan", wall=True, pan_leadin=0.1,
                           pan_turns=1.2, pan_translation=0.25,
                           render_depth_noise=0.015)
    frames = [world.frame(k, render=True) for k in range(LOOP_FRAMES)]
    grays = np.stack([f.image for f in frames]).astype(np.float32)
    depths = np.stack([f.depth_image for f in frames]).astype(np.float32)
    stamps = [f.timestamp for f in frames]
    gt_times, gt = world.groundtruth()
    card = card_line()
    print(f"loop: rendered {LOOP_FRAMES} frames in {time.perf_counter() - t0:.1f} s")

    slam = system.SLAMSystem(cam, SLAMConfig(), enable_mapping=True, enable_crf=True,
                             device="cuda")
    slam.seq_phases = {}

    # every closure stage timed to a synchronize on both sides; the timers'
    # own device reads stay out of the chunks' sync counts
    stage_ms = {"verify_loop": [], "correct_loop": [], "global_ba": [],
                "search_and_fuse": []}
    before = {}     # the keyframes just before the first correct_loop

    def timed(name):
        inner = getattr(system, name)

        def stage(*args):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            if name == "correct_loop" and not before:
                m = args[2]
                n = int(m.n_kfs)
                before.update(Tcw=m.kf_Tcw[:n].cpu().numpy(),
                              time=m.kf_time[:n].cpu().numpy(),
                              alive=m.kf_alive[:n].cpu().numpy())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.set_sync_debug_mode(mode)
            return out

        setattr(system, name, stage)
        return inner

    originals = {name: timed(name) for name in stage_ms}
    chunks = count_chunks(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_kernel.reset_launches()
    try:
        poses_tcw = slam.track_sequence(grays, depths, stamps, chunk=SEQ_CHUNK)
        torch.cuda.synchronize()
        got = path_launches()
        slices_in_run = slam._gba_slices_run
        slam.flush_stats()
        ts, poses = slam.get_trajectory()       # finishes a pending global BA
    finally:
        for name, fn in originals.items():
            setattr(system, name, fn)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    n_seq = LOOP_FRAMES - 1
    n_chunks = -(-n_seq // SEQ_CHUNK)
    if poses.shape != (LOOP_FRAMES, 4, 4) or not np.all(np.isfinite(poses)) \
            or poses_tcw.shape != (n_seq, 4, 4) or not np.all(np.isfinite(poses_tcw)):
        raise AssertionError(f"loop phase: bad trajectory, shapes {poses.shape} "
                             f"{poses_tcw.shape}")
    ate = ate_rmse(ts, poses, gt_times, gt)
    n_lost = sum(s.get("lost_frames", 0) for s in slam.stats
                 if s.get("event") == "chunk_lost")
    m = slam.map
    n_kfs = int(m.n_kfs)
    ms_frame = sum(c[2] for c in chunks) / n_seq
    print(f"loop [{card}]: {n_seq} chunked frames in {n_chunks} chunks of {SEQ_CHUNK}: "
          f"{ms_frame:.2f} ms/frame (chunks {[round(c[2], 1) for c in chunks]} ms)")
    print(f"loop [{card}]: seq_phases, host ms/frame: " + ", ".join(
        f"{k} {v * 1e3 / n_seq:.2f}" for k, v in slam.seq_phases.items()))
    for name, ms in stage_ms.items():
        print(f"loop [{card}]: {name} x{len(ms)}: ms {[round(t, 1) for t in ms]}")
    print(f"loop [{card}]: loop_log {slam.loop_log}, verified candidates {slam.n_verify_loops}, "
          f"global-BA slices {slam._gba_slices_run} ({slices_in_run} inside the run), "
          f"keyframes {n_kfs}, lost frames {n_lost}, kernel launches (fused, map) "
          f"{got}, host syncs per chunk {[c[1] for c in chunks]} with "
          f"{[c[3] for c in chunks]} (verified candidates, relocalisation attempts), "
          f"peak memory {peak_mb:.0f} MiB")
    failures = []
    try:
        check_launches("loop phase", got, 1 + n_chunks)
    except AssertionError as e:
        failures.append(str(e))
    if not slam.loop_log:
        failures.append("no loop was closed")
    # lost frames: none in a chunk that no closure preceded
    lost_at = [round(s["t"] * 30.0) for s in slam.stats if s.get("event") == "chunk_lost"]
    closed_at = [c[4] for c in chunks if c[4] is not None]
    first_closure = min(closed_at, default=LOOP_FRAMES)
    if any(k <= first_closure for k in lost_at) or int(slam.ts.status) != 1:
        failures.append(f"chunks ending at frames {lost_at} lost frames, the first "
                        f"closure came after frame {first_closure}, final status "
                        f"{int(slam.ts.status)}")
    if slam._gba_slices_run < 1 or slam._gba_pending is not None:
        failures.append(f"{slam._gba_slices_run} global-BA slices, pending "
                        f"{slam._gba_pending}")
    if len(chunks) != n_chunks:
        failures.append(f"{len(chunks)} chunks, expected {n_chunks}")
    for n, syncs, _, (verified, relocs), _ in chunks:
        allowed = n + 1 + verified + 3 * relocs
        if syncs > allowed:
            failures.append(f"{syncs} host syncs in a chunk of {n} frames with "
                            f"{verified} verified candidates and {relocs} "
                            f"relocalisation attempts, at most {allowed} allowed")

    # every live point's observation count equals the weighted recount of
    # the live keyframes' observation table (a depth-backed entry counts 2)
    kf_alive = m.kf_alive.cpu().numpy()
    obs = m.kf_obs.cpu().numpy()[kf_alive]
    valid = m.kf_valid.cpu().numpy()[kf_alive] & (obs >= 0)
    w = 1 + (m.kf_ur.cpu().numpy()[kf_alive] >= 0).astype(np.int64)
    P = m.capacity_points
    recount = np.bincount(obs[valid].ravel(), weights=w[valid].ravel(),
                          minlength=P)[:P].astype(np.int64)
    stale = m.p_alive.cpu().numpy() & (m.p_n_obs.cpu().numpy() != recount)
    if stale.any():
        failures.append(f"{int(stale.sum())} live points whose observation count "
                        f"differs from the recount")

    # the keyframes that were alive just before the first correct_loop and
    # still are: their ATE then and now
    n0 = len(before["alive"])
    same = before["alive"] & kf_alive[:n0]
    ate_before = keyframe_ate(before["Tcw"], before["time"], same, gt_times, gt)
    ate_after = keyframe_ate(m.kf_Tcw[:n0].cpu().numpy(), before["time"], same,
                             gt_times, gt)
    print(f"loop [{card}]: ATE {ate:.5f} m over {LOOP_FRAMES} frames; the {int(same.sum())} "
          f"keyframes alive at the first closure: ATE {ate_before:.5f} m just before "
          f"it, {ate_after:.5f} m at the end; {int(m.p_alive.sum())} live points")
    if not ate < LOOP_ATE_BAR_M:
        failures.append(f"ATE {ate} m >= {LOOP_ATE_BAR_M} m")
    if not ate_after <= LOOP_KF_ATE_FACTOR * ate_before:
        failures.append(f"keyframe ATE {ate_after} m after the closure > "
                        f"{LOOP_KF_ATE_FACTOR} x {ate_before} m before")
    if failures:
        raise AssertionError("loop phase: " + "; ".join(failures))
    return got[0], type(m)(*(t.cpu() for t in m)), int(slam.ts.frame_idx)


def stereo_phase(cam) -> int:
    """`track_stereo` at full width (see the module docstring, step 8);
    returns the path's fused-kernel launches."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    world = SyntheticWorld(cam=cam, n_frames=STEREO_FRAMES, n_static=900, n_dynamic=0,
                           seed=11, trajectory="line", pixel_noise=0.0, depth_noise=0.0)
    frames = [world.frame(k, render=True) for k in range(STEREO_FRAMES)]
    rights = [world.right_eye(k) for k in range(STEREO_FRAMES)]
    slam = SLAMSystem(cam, SLAMConfig(), device="cuda")
    frame_ms, syncs, got, peak_mb = drive(
        slam, frames, range(3, STEREO_FRAMES),
        track=lambda f: slam.track_stereo(f.image, rights[round(f.timestamp * 30)],
                                          f.timestamp))
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    if poses.shape != (STEREO_FRAMES, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"stereo phase: bad trajectory, shape {poses.shape}")
    ate = ate_rmse(ts, poses, gt_t, gt)
    statuses = [s.get("status", 1) for s in slam.stats]
    is_kf = [bool(s.get("need_kf")) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    other_at = [k for k in range(3, STEREO_FRAMES) if not is_kf[k]]
    print(f"stereo [{card_line()}]: {STEREO_FRAMES} pairs, median "
          f"{statistics.median(frame_ms[3:]):.2f} ms/frame after the first 3, first "
          f"frame {frame_ms[0]:.1f} ms; ATE {ate:.5f} m, keyframes {n_kfs}, lost frames "
          f"{statuses.count(2)}, mapping_step calls {slam.n_mapping_steps}, kernel "
          f"launches (fused, map) {got}, peak memory {peak_mb:.0f} MiB, host syncs per "
          f"frame from the 4th {list(syncs.values())}")
    check_launches("stereo phase", got, STEREO_FRAMES)
    if 2 in statuses:
        raise AssertionError(f"stereo phase: tracking lost: statuses {statuses}")
    if n_kfs < 3:
        raise AssertionError(f"stereo phase: only {n_kfs} keyframes")
    if not ate < STEREO_ATE_BAR_M:
        raise AssertionError(f"stereo phase: ATE {ate} m >= {STEREO_ATE_BAR_M} m")
    if syncs[other_at[0]] != 1:
        raise AssertionError(f"stereo phase: {syncs[other_at[0]]} host syncs on "
                             f"non-keyframe frame {other_at[0]}, expected 1")
    return got[0]


def stereo_sequence_phase(cam, frames, rights, world, seq_ms: float) -> int:
    """`track_sequence_stereo` at full width (see the module docstring,
    step 9); returns the path's fused-kernel launches."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.ops import fast_kernel

    slam = SLAMSystem(cam, SLAMConfig(), enable_mapping=True, enable_crf=True,
                      device="cuda")
    slam.seq_phases = {}
    lefts = np.stack([f.image for f in frames]).astype(np.float32)
    chunks = count_chunks(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_kernel.reset_launches()
    poses_tcw = slam.track_sequence_stereo(lefts, np.stack(rights).astype(np.float32),
                                           [f.timestamp for f in frames], chunk=SEQ_CHUNK)
    torch.cuda.synchronize()
    got = path_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n_seq = len(frames) - 1
    n_chunks = -(-n_seq // SEQ_CHUNK)
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    if poses.shape != (len(frames), 4, 4) or not np.all(np.isfinite(poses)) \
            or poses_tcw.shape != (n_seq, 4, 4) or not np.all(np.isfinite(poses_tcw)):
        raise AssertionError(f"stereo sequence phase: bad trajectory, shapes "
                             f"{poses.shape} {poses_tcw.shape}")
    ate = ate_rmse(ts, poses, gt_t, gt)
    n_lost = sum(s.get("lost_frames", 0) for s in slam.stats
                 if s.get("event") == "chunk_lost")
    n_kfs = int(slam.map.n_kfs)
    ms_frame = sum(c[2] for c in chunks) / n_seq
    print(f"stereo sequence [{card_line()}]: {n_seq} chunked pairs in {n_chunks} chunks "
          f"of {SEQ_CHUNK}: {ms_frame:.2f} ms/frame (chunks "
          f"{[round(c[2], 1) for c in chunks]} ms); the RGB-D sequence phase on the same "
          f"left frames: {seq_ms:.2f} ms/frame")
    print(f"stereo sequence: seq_phases, host ms/frame: " + ", ".join(
        f"{k} {v * 1e3 / n_seq:.2f}" for k, v in slam.seq_phases.items()))
    print(f"stereo sequence: ATE {ate:.5f} m, keyframes {n_kfs}, lost frames {n_lost}, "
          f"mapping_step calls {slam.n_mapping_steps}, crf_step calls "
          f"{slam.n_crf_steps}, kernel launches (fused, map) {got}, host syncs per "
          f"chunk {[c[1] for c in chunks]} for {[c[0] for c in chunks]} frames, peak "
          f"memory {peak_mb:.0f} MiB")
    check_launches("stereo sequence phase", got, 1 + n_chunks)
    if n_lost or int(slam.ts.status) != 1:
        raise AssertionError(f"stereo sequence phase: {n_lost} lost frames, final "
                             f"status {int(slam.ts.status)}")
    if n_kfs < 2:
        raise AssertionError(f"stereo sequence phase: only {n_kfs} keyframes")
    for n, syncs, *_ in chunks:
        if syncs > n + 1:
            raise AssertionError(f"stereo sequence phase: {syncs} host syncs in a "
                                 f"chunk of {n} frames, at most {n + 1} allowed")
    if not ate < STEREO_ATE_BAR_M:
        raise AssertionError(f"stereo sequence phase: ATE {ate} m >= "
                             f"{STEREO_ATE_BAR_M} m")
    return got[0]


def mono_phase(cam):
    """`track_monocular` at full width (see the module docstring, step
    10); returns (the path's fused-kernel launches, the system)."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    world = SyntheticWorld(cam=cam, n_frames=MONO_FRAMES, n_static=700, n_dynamic=0,
                           seed=19, trajectory="line", pixel_noise=0.0, depth_noise=0.0)
    frames = [world.frame(k, render=True) for k in range(MONO_FRAMES)]
    slam = SLAMSystem(cam, SLAMConfig(), device="cuda")
    sites = {}
    frame_ms, syncs, got, peak_mb = drive(
        slam, frames, range(MONO_FRAMES),
        track=lambda f: slam.track_monocular(f.image, f.timestamp), sites=sites)
    slam.flush_stats()
    events = [s.get("event", "track") for s in slam.stats]
    init_at = events.index("mono_init") if "mono_init" in events else None
    ts, poses = slam.get_trajectory()
    gt_times, gt = world.groundtruth()
    after = np.asarray([int(r) >= 0 for _, _, r in slam.trajectory])
    n_kfs = int(slam.map.n_kfs)
    n_points = int(slam.map.p_alive.sum())
    statuses = [s.get("status", 1) for s in slam.stats]
    lost_after = statuses[init_at + 1:].count(2) if init_at is not None else None
    ate = (ate_rmse(ts[after], poses[after], gt_times, gt, with_scale=True)
           if after.sum() > 2 else None)
    tracked = [k for k in range(MONO_FRAMES) if events[k] == "track"]
    other_at = [k for k in tracked if not slam.stats[k].get("need_kf")]
    before_init = [syncs[k] for k in range(init_at + 1 if init_at is not None else 0)]
    print(f"mono [{card_line()}]: {MONO_FRAMES} frames, events until the "
          f"initialisation {events[:(init_at or 0) + 1]}, initialised on frame "
          f"{init_at}; ms of those frames {[round(t, 1) for t in frame_ms[:(init_at or 0) + 1]]}, "
          f"median {statistics.median(frame_ms[-10:]):.2f} ms over the last "
          f"10 frames; keyframes {n_kfs}, live points {n_points}, lost frames after the "
          f"initialisation {lost_after}, scale-aligned ATE over the {int(after.sum())} "
          f"frames from it {ate if ate is None else round(ate, 5)} m, kernel launches "
          f"(fused, map) {got}, peak memory {peak_mb:.0f} MiB; host syncs on the frames "
          f"up to the initialisation {before_init}, after it "
          f"{[syncs[k] for k in tracked]}")
    check_launches("mono phase", got, MONO_FRAMES)
    if init_at is None or not slam.initialized:
        raise AssertionError(f"mono phase: no initialisation: {events}")
    if int(slam.map.n_points) <= 60:
        raise AssertionError(f"mono phase: {int(slam.map.n_points)} map points")
    if not np.all(np.isfinite(poses[after])) or not np.all(np.isfinite(
            slam.ts.Tcw.cpu().numpy())):
        raise AssertionError("mono phase: poses not finite after the initialisation")
    print(f"mono: host sync sites on the frames up to the initialisation "
          f"{[sites[k] for k in range(len(before_init))]}")
    design = [MONO_INIT_READS[e] for e in events[:len(before_init)]]
    if before_init != design:
        raise AssertionError(f"mono phase: host syncs before the initialisation "
                             f"{before_init}, the design's {design}")
    if other_at and syncs[other_at[0]] != 1:
        raise AssertionError(f"mono phase: {syncs[other_at[0]]} host syncs on "
                             f"non-keyframe frame {other_at[0]}, expected 1")
    return got[0], slam


def sim3_closure_stage(slam) -> None:
    """`correct_loop_sim3` handed a closure on the monocular map, on the
    card and on a CPU copy (see the module docstring, step 11)."""
    from lc_crf_slam_torch.geometry.se3 import exp_se3
    from lc_crf_slam_torch.models.loopclosing import correct_loop_sim3
    from lc_crf_slam_torch.models.mapstate import MapState

    m = slam.map
    kf = int(m.n_kfs) - 1
    T_corr = exp_se3(torch.tensor([0.02, -0.01, 0.03, 0.01, -0.02, 0.015]))
    args = (torch.tensor(kf, dtype=torch.int32), torch.tensor(0, dtype=torch.int32),
            T_corr, torch.tensor(SIM3_S_CORR))
    cuda_args = tuple(a.cuda() for a in args)
    ms, syncs = [], []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                out = correct_loop_sim3(slam.cfg, slam.cam, m, *cuda_args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        syncs.append(count_syncs(caught))
    m_cpu = MapState(*(x.cpu() for x in m))
    t0 = time.perf_counter()
    ref = correct_loop_sim3(slam.cfg, slam.cam, m_cpu, *args)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    alive, alive_cpu = out.p_alive.cpu(), ref.p_alive
    both = alive & alive_cpu
    d_kf = float((out.kf_Tcw.cpu() - ref.kf_Tcw).abs().max())
    d_p = float((out.p_xyz.cpu() - ref.p_xyz)[both].abs().max())
    moved = float(torch.linalg.norm(out.kf_Tcw[kf, :3, 3] - m.kf_Tcw[kf, :3, 3]))
    print(f"sim3 closure [{card_line()}]: correct_loop_sim3 keyframe {kf} -> 0 on "
          f"{int(m.n_kfs)} keyframes and {int(m.p_alive.sum())} live points, s_corr "
          f"{SIM3_S_CORR}: card {ms[0]:.1f} ms then {ms[1]:.1f} ms, CPU {cpu_ms:.1f} ms; "
          f"host syncs {syncs}; card vs CPU: kf_Tcw max abs diff {d_kf:.2e}, live "
          f"p_xyz max abs diff {d_p:.2e} m, live points {int(alive.sum())} vs "
          f"{int(alive_cpu.sum())}; the closing keyframe moved {moved:.4f}")
    if syncs != [0, 0]:
        raise AssertionError(f"sim3 closure: {syncs} host syncs inside correct_loop_sim3")
    if not (d_kf <= SIM3_TOL and d_p <= SIM3_TOL and torch.equal(alive, alive_cpu)):
        raise AssertionError(f"sim3 closure: card vs CPU kf_Tcw {d_kf}, p_xyz {d_p}, "
                             f"live points {int(alive.sum())} vs {int(alive_cpu.sum())}")
    if not (np.isfinite(d_kf) and moved > 0):
        raise AssertionError("sim3 closure: the closing keyframe did not move")


def shift_sequence(d: str, offset: float) -> None:
    """Add `offset` seconds to every timestamp of a TUM directory's lists."""
    from lc_crf_slam_torch.utils.io_tum import read_file_list

    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        path = os.path.join(d, name)
        rows = read_file_list(path)
        with open(path, "w") as fh:
            fh.writelines(f"{t + offset:.6f} {' '.join(v)}\n" for t, v in rows)


def run_cli(argv):
    """`run_slam.main(argv)` in this process, timed to a synchronize:
    (exit code, summary dict, its standard error, (fused, map) launches,
    seconds)."""
    from lc_crf_slam_torch import run_slam
    from lc_crf_slam_torch.ops import fast_kernel

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    fast_kernel.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_slam.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return rc, json.loads(out.getvalue().splitlines()[-1]), err.getvalue(), \
        path_launches(), seconds


def tum_phase(cam, world, frames) -> dict:
    """The command line on a TUM-format sequence (see the module
    docstring, step 12); returns the fused-kernel launches of its three
    paths."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.ops import fast_kernel
    from lc_crf_slam_torch.utils.checkpoint import load_checkpoint
    from lc_crf_slam_torch.utils.io_tum import (load_groundtruth, poses_from_tum,
                                                read_file_list, read_trajectory_tum)

    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tum_")
    try:
        d = os.path.join(tmp, "seq")
        t0 = time.perf_counter()
        world.export_tum_sequence(d, n=TUM_FRAMES)
        shift_sequence(d, TUM_OFFSET_S)
        print(f"tum: exported {TUM_FRAMES} frames of the tracking world at Unix times "
              f"from {TUM_OFFSET_S} in {time.perf_counter() - t0:.1f} s")
        frame_t = np.array([t for t, _ in read_file_list(os.path.join(d, "rgb.txt"))])
        gt_t, gt_vals = load_groundtruth(os.path.join(d, "groundtruth.txt"))
        gt = poses_from_tum(gt_vals)
        out = {k: os.path.join(tmp, k) for k in (
            "traj.txt", "kf.txt", "run.jsonl", "ck.npz", "traj_tp.txt", "kf_tp.txt",
            "run_tp.jsonl", "profile")}
        failures, launches = [], {}

        def check_run(name, summary, traj, kf, log, n_records, got, n_fused):
            ts, poses = read_trajectory_tum(traj)
            ate = ate_rmse(ts, poses, gt_t, gt)
            kf_t, _ = read_trajectory_tum(kf)
            kf_off = np.abs(kf_t[:, None] - frame_t[None]).min(axis=1).max()
            records = [json.loads(x) for x in open(log)]
            print(f"tum {name} [{card}]: summary {summary}; ATE {ate:.5f} m "
                  f"(evaluate_ate against groundtruth.txt); {len(kf_t)} keyframes, their "
                  f"times at most {kf_off:.2e} s from a frame time; {len(records)} JSONL "
                  f"lines; kernel launches (fused, map) {got}")
            if summary["frames"] != TUM_FRAMES or summary["lost_frames"] != 0:
                failures.append(f"{name}: frames {summary['frames']}, lost "
                                f"{summary['lost_frames']}")
            if not ate < ATE_BAR_M:
                failures.append(f"{name}: ATE {ate} m >= {ATE_BAR_M} m")
            if not (len(kf_t) >= 2 and kf_off <= KF_TIME_TOL_S):
                failures.append(f"{name}: keyframe times up to {kf_off} s off a frame time")
            if len(records) != n_records:
                failures.append(f"{name}: {len(records)} JSONL lines, {n_records} records")
            if got != (n_fused, 0):
                failures.append(f"{name}: kernel launches (fused, map) {got}, expected "
                                f"({n_fused}, 0)")

        # per frame, with the log, a checkpoint and the stage table
        rc, summary, err, got, sec = run_cli([
            "--seq", d, "--device", "cuda", "--log", out["run.jsonl"], "--checkpoint",
            out["ck.npz"], "--timing", "--out", out["traj.txt"], "--kf-out", out["kf.txt"]])
        print(f"tum per frame [{card}]: exit {rc}, {sec:.2f} s for {TUM_FRAMES} frames "
              f"({sec * 1e3 / TUM_FRAMES:.2f} ms/frame with decoding and exports; the "
              f"summary's {summary['fps']} fps); stderr:\n{err.rstrip()}")
        if rc != 0:
            failures.append(f"per frame: exit {rc}")
        # one record a frame
        check_run("per frame", summary, out["traj.txt"], out["kf.txt"], out["run.jsonl"],
                  TUM_FRAMES, got, TUM_FRAMES)
        launches["tum"] = got[0]

        # chunked
        rc, summary, err, got, sec = run_cli([
            "--seq", d, "--device", "cuda", "--throughput", "--chunk", str(TUM_CHUNK),
            "--log", out["run_tp.jsonl"], "--out", out["traj_tp.txt"],
            "--kf-out", out["kf_tp.txt"]])
        n_chunks = -(-(TUM_FRAMES - 1) // TUM_CHUNK)
        print(f"tum chunked [{card}]: exit {rc}, {sec:.2f} s for {TUM_FRAMES} frames in "
              f"1 + {n_chunks} chunks of {TUM_CHUNK} ({sec * 1e3 / TUM_FRAMES:.2f} "
              f"ms/frame with decoding and exports); stderr:\n{err.rstrip()}")
        if rc != 0:
            failures.append(f"chunked: exit {rc}")
        # the first frame's record, and a record for each chunk event
        check_run("chunked", summary, out["traj_tp.txt"], out["kf_tp.txt"],
                  out["run_tp.jsonl"], 1, got, 1 + n_chunks)
        launches["tum_throughput"] = got[0]

        # chunked under torch.profiler: the trace must name the fused kernel
        rc, summary, err, got, sec = run_cli([
            "--seq", d, "--device", "cuda", "--throughput", "--chunk", str(TUM_CHUNK),
            "--max-frames", str(TUM_PROFILE_FRAMES), "--profile", out["profile"],
            "--out", out["traj_tp.txt"], "--kf-out", out["kf_tp.txt"]])
        trace_path = os.path.join(out["profile"], "trace.json")
        trace_mb = os.path.getsize(trace_path) / 2**20
        with open(trace_path) as fh:
            named = "fast_cell_best_kernel" in fh.read()
        print(f"tum profiled [{card}]: exit {rc}, {sec:.2f} s for {summary['frames']} "
              f"frames (the first and one chunk) under torch.profiler, trace "
              f"{trace_mb:.1f} MiB naming fast_cell_best_kernel: {named}, kernel "
              f"launches (fused, map) {got}")
        if rc != 0 or summary["frames"] != TUM_PROFILE_FRAMES or not named \
                or got != (2, 0):
            failures.append(f"profiled: exit {rc}, {summary['frames']} frames, kernel "
                            f"named {named}, launches {got}")
        launches["tum_profiled"] = got[0]

        # resumed from the per-frame run's checkpoint: 4 more frames
        slam = SLAMSystem(cam, SLAMConfig(), device="cuda")
        m, ts, meta = load_checkpoint(out["ck.npz"], device="cuda")
        slam.restore(m, ts, meta["trajectory"], meta["kf_log"])
        more = frames[TUM_FRAMES:TUM_FRAMES + TUM_RESUME_FRAMES]
        torch.cuda.synchronize()
        fast_kernel.reset_launches()
        t0 = time.perf_counter()
        for f in more:
            slam.track_rgbd(f.image, f.depth_image, TUM_OFFSET_S + f.timestamp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(more)
        got = path_launches()
        slam.flush_stats()
        ts_all, poses = slam.get_trajectory()
        w_t, w_gt = world.groundtruth()
        ate = ate_rmse(ts_all, poses, w_t + TUM_OFFSET_S, w_gt)
        statuses = [s.get("status") for s in slam.stats]
        print(f"tum resume [{card}]: checkpoint of {len(meta['trajectory'])} frames on "
              f"{m.p_xyz.device}, {len(more)} more frames at {ms:.2f} ms/frame, statuses "
              f"{statuses}, ATE over all {len(ts_all)} frames {ate:.5f} m, kernel launches "
              f"(fused, map) {got}")
        if statuses != [1] * len(more) or len(ts_all) != TUM_FRAMES + len(more):
            failures.append(f"resume: statuses {statuses}, {len(ts_all)} frames")
        if not ate < ATE_BAR_M:
            failures.append(f"resume: ATE {ate} m >= {ATE_BAR_M} m")
        if got != (len(more), 0):
            failures.append(f"resume: kernel launches (fused, map) {got}")
        launches["tum_resume"] = got[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("tum phase: " + "; ".join(failures))
    return launches


def localization_phase(cam) -> int:
    """Localisation mode and relocalisation at full width (see the module
    docstring, step 13); returns the path's fused-kernel launches."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.ops import fast_kernel
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    card = card_line()
    world = SyntheticWorld(cam=cam, n_frames=LOC_FRAMES, n_static=900, n_dynamic=0,
                           seed=5, trajectory="orbit", pixel_noise=0.0, depth_noise=0.0)
    frames = [world.frame(k, render=True) for k in range(LOC_FRAMES)]
    slam = SLAMSystem(cam, SLAMConfig(), device="cuda")
    seen, frame_ms = [], []
    torch.cuda.synchronize()
    fast_kernel.reset_launches()
    for k, f in enumerate(frames):
        slam.set_localization_mode(LOC_START <= k < LOC_END)
        img, depth = f.image, f.depth_image
        if k in LOC_BLACK:
            img, depth = np.zeros_like(img), np.zeros_like(depth)
        t0 = time.perf_counter()
        slam.track_rgbd(img, depth, f.timestamp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        seen.append((int(slam.map.n_kfs), int(slam.map.p_alive.sum()), slam.n_mapping_steps))
    got = path_launches()
    slam.flush_stats()
    statuses = [s.get("status", 1) for s in slam.stats]
    lost = [k for k, st in enumerate(statuses) if st != 1]
    back = next((k for k in range(LOC_BLACK[-1] + 1, LOC_FRAMES) if statuses[k] == 1), None)
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    keep = np.array([k not in LOC_BLACK for k in range(LOC_FRAMES)])
    ate = ate_rmse(ts[keep], poses[keep], gt_t, gt)
    loc = [k for k in range(LOC_START, LOC_END) if k not in LOC_BLACK]
    mapped = [k for k in range(LOC_FRAMES) if k < LOC_START or k >= LOC_END]
    print(f"localization [{card}]: frames 0-{LOC_START - 1} map, {LOC_START}-{LOC_END - 1} "
          f"localise (black frames {list(LOC_BLACK)}), {LOC_END}-{LOC_FRAMES - 1} map; "
          f"keyframes / live points / mapping passes at frame {LOC_START - 1} "
          f"{seen[LOC_START - 1]}, at {LOC_END - 1} {seen[LOC_END - 1]}, at the end "
          f"{seen[-1]}; lost frames {lost}, tracked again on frame {back}; ms of the "
          f"black frames and the next two {[round(frame_ms[k], 1) for k in (*LOC_BLACK, LOC_BLACK[-1] + 1, LOC_BLACK[-1] + 2)]}; "
          f"median ms/frame localising {statistics.median(frame_ms[k] for k in loc):.2f}, "
          f"mapping {statistics.median(frame_ms[k] for k in mapped[3:]):.2f}; ATE over "
          f"the {int(keep.sum())} non-black frames {ate:.5f} m; kernel launches "
          f"(fused, map) {got}")
    failures = []
    if any(seen[k] != seen[LOC_START - 1] for k in range(LOC_START, LOC_END)):
        failures.append(f"the map changed in localisation mode: "
                        f"{[seen[k] for k in range(LOC_START - 1, LOC_END)]}")
    if seen[LOC_START - 1][0] < 2 or seen[-1][0] < seen[LOC_END - 1][0]:
        failures.append(f"keyframes {seen[LOC_START - 1][0]} before, {seen[-1][0]} at the end")
    if any(k not in LOC_BLACK for k in lost) or back is None \
            or back > LOC_BLACK[-1] + LOC_RECOVER:
        failures.append(f"lost frames {lost}, tracked again on frame {back}")
    if not ate < LOC_ATE_BAR_M:
        failures.append(f"ATE {ate} m >= {LOC_ATE_BAR_M} m")
    if got != (LOC_FRAMES, 0):
        failures.append(f"kernel launches (fused, map) {got}, expected ({LOC_FRAMES}, 0)")
    if failures:
        raise AssertionError("localization phase: " + "; ".join(failures))
    return got[0]


def direct_descriptor_stage(cam, frames, world) -> int:
    """The tracking phase's first frames with the "direct" descriptor (see
    the module docstring, step 14); returns the path's fused-kernel
    launches."""
    from lc_crf_slam_torch.config import LoopConfig, ORBConfig, SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem

    cfg = SLAMConfig(loop=LoopConfig(enabled=False),
                     orb=ORBConfig(descriptor_variant="direct"))
    t_stage = time.perf_counter()
    slam = SLAMSystem(cam, cfg, enable_mapping=False, enable_crf=False, device="cuda")
    frame_ms, _, got, peak_mb = drive(slam, frames[:DIRECT_FRAMES], ())
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t, gt = world.groundtruth()
    statuses = [s.get("status", 1) for s in slam.stats]
    if poses.shape != (DIRECT_FRAMES, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"direct descriptor: bad trajectory, shape {poses.shape}")
    ate = ate_rmse(ts, poses, gt_t, gt)
    print(f"direct descriptor [{card_line()}]: {DIRECT_FRAMES} frames, median "
          f"{statistics.median(frame_ms[1:]):.2f} ms/frame after the first, ATE "
          f"{ate:.5f} m, keyframes {int(slam.map.n_kfs)}, lost frames "
          f"{statuses.count(2)}, kernel launches (fused, map) {got}, peak memory "
          f"{peak_mb:.0f} MiB; the stage took {time.perf_counter() - t_stage:.1f} s")
    check_launches("direct descriptor", got, DIRECT_FRAMES)
    if 2 in statuses:
        raise AssertionError(f"direct descriptor: tracking lost: statuses {statuses}")
    if not ate < ATE_BAR_M:
        raise AssertionError(f"direct descriptor: ATE {ate} m >= {ATE_BAR_M} m")
    return got[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (on the card, `index_add_` without
    float atomics) inside the block; an op without one raises."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def synced_ms(fn, *args):
    """(fn(*args), its ms with a synchronize on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def distributed_phase(cam, frames, world, seq_ms, seq_poses, seq_kf_log, loop_map,
                      loop_frame_idx) -> int:
    """The multi-device layer on the card (see the module docstring, step
    15); returns the path's fused-kernel launches."""
    import torch.distributed as dist

    from lc_crf_slam_torch._ops import stable_topk
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models import crf
    from lc_crf_slam_torch.models.capacities import CRF_TRACKS, RECENCY_WINDOW
    from lc_crf_slam_torch.models.loopclosing import _map_ba_problem
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.ops import fast_kernel
    from lc_crf_slam_torch.ops.schur import solve_ba
    from lc_crf_slam_torch.parallel import dist_ba, dist_crf
    from lc_crf_slam_torch.parallel.mesh import edge_sharding, init_distributed, make_mesh

    card = card_line()
    cfg = SLAMConfig()
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # (a) a world of one NCCL rank
    _, init_ms = synced_ms(lambda: init_distributed(
        coordinator_address=f"localhost:{free_port()}", num_processes=1, process_id=0,
        device="cuda"))
    emesh = make_mesh()
    print(f"distributed [{card}]: init_distributed {init_ms:.1f} ms: backend "
          f"{dist.get_backend()}, world {dist.get_world_size()}, edge mesh "
          f"{[str(d) for d in emesh.devices]}")
    failures = []

    # (b) the sequence phase's frames through SLAMSystem(mesh=...) and
    # mesh=None. Local BA and the closures sum with float atomics on the
    # card, so two runs of one path drift apart in the last bits (ROADMAP
    # queue 3): both runs use torch's deterministic algorithms, and what
    # differs between them is the split alone.
    n_cards = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(n_cards)] if n_cards >= 2
               else ["cuda:0"] * DIST_SHARDS)
    fmesh = make_mesh(devices=devices, axis="frames")
    grays = np.stack([f.image for f in frames]).astype(np.float32)
    depths = np.stack([f.depth_image for f in frames]).astype(np.float32)
    n_seq = len(frames) - 1
    runs = {}
    for name, mesh in (("mesh=None", None), ("mesh", fmesh)):
        slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cuda",
                          mesh=mesh)
        chunks = count_chunks(slam)
        torch.cuda.synchronize()
        fast_kernel.reset_launches()
        with deterministic():
            poses_tcw = slam.track_sequence(grays, depths, [f.timestamp for f in frames],
                                            chunk=SEQ_CHUNK)
            torch.cuda.synchronize()
        got = path_launches()
        slam.flush_stats()
        runs[name] = (poses_tcw, slam.kf_log, chunks, got)
        del slam
    poses_tcw, kf_log, chunks, got = runs["mesh"]
    def centre(T):
        """Camera centres of poses Tcw (N, 4, 4)."""
        return np.einsum("nji,nj->ni", T[:, :3, :3], -T[:, :3, 3])

    dpos = float(np.abs(centre(poses_tcw) - centre(runs["mesh=None"][0])).max())
    spread = float(np.abs(centre(poses_tcw) - centre(seq_poses)).max())
    n_fused = 1 + sum(min(fmesh.size, c[0]) for c in chunks)
    ms = {k: sum(c[2] for c in v[2]) / n_seq for k, v in runs.items()}
    print(f"distributed [{card}]: frames mesh {[str(d) for d in fmesh.devices]}, "
          f"deterministic algorithms: {n_seq} chunked frames, {ms['mesh']:.2f} ms/frame "
          f"(chunks {[round(c[2], 1) for c in chunks]} ms), mesh=None {ms['mesh=None']:.2f} "
          f"(the sequence phase, default algorithms: {seq_ms:.2f}); keyframes in chunks "
          f"{len(kf_log)}, mesh=None {len(runs['mesh=None'][1])}, the sequence phase "
          f"{len(seq_kf_log)} (equal: {kf_log == seq_kf_log}); camera centres vs mesh=None "
          f"max {dpos:.3e} m (vs the sequence phase {spread:.3e} m); kernel launches "
          f"(fused, map) {got}; host syncs per chunk {[c[1] for c in chunks]} for "
          f"{[c[0] for c in chunks]} frames")
    try:
        check_launches("distributed phase", got, n_fused)
    except AssertionError as e:
        failures.append(str(e))
    if kf_log != runs["mesh=None"][1]:
        failures.append(f"keyframes {kf_log} != mesh=None's {runs['mesh=None'][1]}")
    if not dpos <= DIST_CAM_TOL_M:
        failures.append(f"poses {dpos} m from mesh=None's, more than {DIST_CAM_TOL_M}")
    for n, syncs, *_ in chunks:
        if syncs > n + 1:
            failures.append(f"{syncs} host syncs in a chunk of {n} frames")

    # (c) the loop phase's final map: the whole-map BA three ways, timed
    # with the default algorithms and compared with deterministic ones
    m = type(loop_map)(*(t.to("cuda") for t in loop_map))
    prob = _map_ba_problem(cfg, m)
    blocks = dist_ba.partition_point_blocks(prob, emesh.size)
    solves = {
        "solve_ba": lambda: solve_ba(cam, prob, DIST_BA_ITERS),
        "dist_solve_ba": lambda: dist_ba.dist_solve_ba(
            cam, dist_ba.shard_problem(prob, emesh), emesh, n_iters=DIST_BA_ITERS),
        "dist_solve_ba_blocks": lambda: dist_ba.dist_solve_ba_blocks(
            cam, dist_ba.shard_problem(blocks, emesh, blocks=True), emesh,
            n_iters=DIST_BA_ITERS)}
    timed = {name: synced_ms(fn) for name, fn in solves.items()}
    with deterministic():
        exact = {name: fn() for name, fn in solves.items()}
    kf_live, p_live = m.kf_alive.cpu().numpy(), m.p_alive.cpu().numpy()
    P = p_live.shape[0]

    def diffs(a, b):
        dc = float(np.abs((a[0] - b[0])[:, :3, 3].cpu().numpy()[kf_live]).max())
        dp = float(np.abs((a[1][:P] - b[1]).cpu().numpy()[p_live]).max())
        return dc, dp

    for name in ("dist_solve_ba", "dist_solve_ba_blocks"):
        (out, ms_d), (ref, ms_s) = timed[name], timed["solve_ba"]
        dc, dp = diffs(exact[name], exact["solve_ba"])
        dc_a, dp_a = diffs(out, ref)
        print(f"distributed [{card}]: {name} on the loop map (C={m.kf_Tcw.shape[0]}, "
              f"P={P}, {int(out[2].n_edges)} edges, {int(kf_live.sum())} live keyframes, "
              f"{int(p_live.sum())} live points), {DIST_BA_ITERS} iterations: "
              f"{ms_d:.1f} ms (solve_ba {ms_s:.1f} ms); cost {float(out[2].cost):.6g} "
              f"(solve_ba {float(ref[2].cost):.6g}); max diff to solve_ba, deterministic "
              f"algorithms: cameras {dc:.3e} m, live points {dp:.3e}; default "
              f"algorithms (atomics): {dc_a:.3e} m, {dp_a:.3e}")
        if not (dc <= DIST_CAM_TOL_M and dp <= DIST_PT_TOL):
            failures.append(f"{name}: cameras {dc} m, points {dp} from solve_ba")

    # (d) the CRF of that map's recent tracks, one rank's rows against the
    # single-device graph and mean field
    frame_idx = torch.full((), loop_frame_idx, dtype=torch.int32, device="cuda")
    recent = m.p_alive & ((frame_idx - m.p_last_seen) <= RECENCY_WINDOW) \
        & (m.p_visible >= 2)
    _, ids = stable_topk(recent.to(torch.float32), CRF_TRACKS)
    ok = recent[ids]
    u_s, u_d = crf.unary_energies(cfg, m, ids)
    xyz = m.p_xyz[ids]
    (nbr_s, w_s), knn_ms = synced_ms(crf.knn_graph, cfg, xyz, ok)
    q_s, mf_ms = synced_ms(crf.mean_field, cfg, u_s, u_d, nbr_s, w_s, ok)
    sh = lambda x: edge_sharding(emesh, x)     # noqa: E731
    (nbr_d, w_d), dknn_ms = synced_ms(dist_crf.dist_knn_graph, cfg, sh(xyz), sh(ok), emesh)
    q_d, dmf_ms = synced_ms(dist_crf.dist_mean_field, cfg, sh(u_s), sh(u_d), nbr_d, w_d,
                            sh(ok), emesh)
    same_nbr = bool(torch.equal(nbr_d, nbr_s))
    dw = float((w_d - w_s).abs().max())
    dq = float((q_d - q_s).abs().max())
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"distributed [{card}]: CRF of the loop map ({int(ok.sum())} of {CRF_TRACKS} "
          f"tracks): dist_knn_graph {dknn_ms:.2f} ms (knn_graph {knn_ms:.2f}), "
          f"dist_mean_field {dmf_ms:.2f} ms (mean_field {mf_ms:.2f}); neighbours equal "
          f"{same_nbr}, max diff weights {dw:.3e}, q_dyn {dq:.3e}")
    print(f"distributed [{card}]: peak memory of the phase {peak_mb:.0f} MiB; the phase "
          f"took {time.perf_counter() - t_phase:.1f} s")
    if not (same_nbr and dw <= DIST_CRF_TOL and dq <= DIST_CRF_TOL):
        failures.append(f"CRF: neighbours equal {same_nbr}, weights {dw}, q_dyn {dq}")
    dist.destroy_process_group()
    if failures:
        raise AssertionError("distributed phase: " + "; ".join(failures))
    return got[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.geometry.camera import TUM3
    from lc_crf_slam_torch.kernels import build
    from lc_crf_slam_torch.ops.pyramid import build_pyramid
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.kernel_names():
        build.load(name)
    print(f"build {sorted(built)} (one nvcc each, in parallel, then load): "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- worlds ------------------------------------------------------------
    cam = TUM3
    cfg = SLAMConfig()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    world = SyntheticWorld(cam=cam, n_frames=N_FRAMES, n_static=600,
                           n_dynamic=0, seed=0)
    frames = [world.frame(k, render=True) for k in range(N_FRAMES)]
    dyn_world = SyntheticWorld(cam=cam, n_frames=60, n_static=1400, n_dynamic=0,
                               seed=7, trajectory="line", billboard=True,
                               bb_speed=0.04)
    dyn_frames = [dyn_world.frame(k, render=True) for k in range(DYN_FRAMES)]
    dyn_rights = [dyn_world.right_eye(k) for k in range(DYN_FRAMES)]
    print(f"rendered {N_FRAMES} + {DYN_FRAMES} frames and {DYN_FRAMES} right eyes "
          f"{cam.width}x{cam.height} in {time.perf_counter() - t0:.1f} s")

    # ---- kernels vs plain --------------------------------------------------
    levels = build_pyramid(torch.as_tensor(frames[0].image, device=dev),
                           cfg.orb.n_levels, cfg.orb.scale_factor)
    rng = np.random.default_rng(0)
    images = [(f"level{l}", img) for l, img in enumerate(levels)]
    for shape in ((200, 300), (256, 256)):
        images.append((f"random{shape[0]}x{shape[1]}", torch.as_tensor(
            (rng.random(shape) * 255).astype(np.float32), device=dev)))
    rows = check_fast_kernel(images)
    chunk_grays = torch.as_tensor(
        np.stack([f.image for f in dyn_frames[1:1 + SEQ_CHUNK]]).astype(np.float32),
        device=dev)
    cells_b1 = check_cell_kernel("one frame", chunk_grays[:1], cfg)
    cells_b8 = check_cell_kernel("a chunk of 8", chunk_grays[:TUM_CHUNK], cfg)
    cells_b15 = check_cell_kernel("one chunk", chunk_grays, cfg)
    stereo_grays = torch.cat([chunk_grays, torch.as_tensor(
        np.stack(dyn_rights[1:1 + SEQ_CHUNK]).astype(np.float32), device=dev)])
    cells_b2 = check_cell_kernel("a stereo pair", stereo_grays[::SEQ_CHUNK], cfg)
    cells_b30 = check_cell_kernel("one stereo chunk", stereo_grays, cfg)

    # ---- the phases at full width -------------------------------------------
    by_path = {"tracking": tracking_phase(cam, frames, world)}
    by_path["dynamic"], dyn_ms = dynamic_phase(cam, dyn_frames, dyn_world)
    by_path["sequence"], seq_ms, seq_poses, seq_kf_log = sequence_phase(
        cam, dyn_frames, dyn_world, dyn_ms)
    by_path["loop"], loop_map, loop_frame_idx = loop_phase(cam)
    by_path["stereo"] = stereo_phase(cam)
    by_path["stereo_sequence"] = stereo_sequence_phase(cam, dyn_frames, dyn_rights,
                                                       dyn_world, seq_ms)
    by_path["mono"], mono = mono_phase(cam)
    sim3_closure_stage(mono)
    by_path.update(tum_phase(cam, world, frames))
    by_path["localization"] = localization_phase(cam)
    by_path["direct_descriptor"] = direct_descriptor_stage(cam, frames, world)
    by_path["distributed"] = distributed_phase(cam, dyn_frames, dyn_world, seq_ms,
                                               seq_poses, seq_kf_log, loop_map,
                                               loop_frame_idx)
    if min(by_path.values()) < 1:
        raise AssertionError(f"a path never launched the fused kernel: {by_path}")

    # ---- report ------------------------------------------------------------
    level_rows = [r for r in rows if r[0].startswith("level")]
    n_pixels = sum(r[1][0] * r[1][1] for r in level_rows)
    maps_bound_ms, maps_bound_by = bound(12 * n_pixels, n_pixels,
                                         sum(r[5] for r in level_rows))
    report = {"kernels": [{
        "name": "fast_cell_best",
        "route": "cuda",
        "source": "lc_crf_slam_torch/csrc/fast_cells.cu",
        "replaces": "lc_crf_slam_tpu/ops/pallas_fast.py:143",
        # the paths' own launches, each counted from 0 (no launch of
        # the kernel checks above is among them)
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"]
                           for c in (cells_b1, cells_b2, cells_b8, cells_b15, cells_b30)),
        # one launch for a chunk of 15 frames (the throughput path's shape)
        "ms": cells_b15["ms"],
        "plain_ms": cells_b15["plain_ms"],
        "bound_ms": cells_b15["bound_ms"],
        "bound_by": cells_b15["bound_by"],
        "library_ms": None,     # no single PyTorch call computes it
        # one launch for one frame (the per-frame path's shape)
        "one_frame": {k: cells_b1[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by")},
        # one launch for a stereo pair (track_stereo's shape)
        "stereo_pair": {k: cells_b2[k] for k in ("ms", "plain_ms", "bound_ms",
                                                  "bound_by", "max_abs_err")},
        # one launch for a chunk of 8 (run_slam --throughput's default chunk)
        "chunk_of_8": {k: cells_b8[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "max_abs_err")},
        # one launch for a stereo chunk: 15 left and 15 right eyes
        "stereo_chunk": {k: cells_b30[k] for k in ("ms", "plain_ms", "bound_ms",
                                                    "bound_by", "max_abs_err")},
    }, {
        "name": "fast_nms_dual",
        "route": "cuda",
        "source": "lc_crf_slam_torch/csrc/fast_nms.cu",
        "replaces": "lc_crf_slam_tpu/ops/pallas_fast.py:143",
        # off every path (each phase asserts 0): only the check above
        # launches it
        "launches": 0,
        "max_abs_err": max(r[2] for r in rows),
        # one frame's maps: the sum over the 8 pyramid level shapes
        "ms": sum(r[3] for r in level_rows),
        "plain_ms": sum(r[4] for r in level_rows),
        "bound_ms": maps_bound_ms,
        "bound_by": maps_bound_by,
        "library_ms": None,     # no single PyTorch call computes it
    }]}
    print(card_line())
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
