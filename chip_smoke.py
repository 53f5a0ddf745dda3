"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

(`--segment-sum` runs step 16 alone; `--phases NAME[,NAME]` runs the
named self-contained phases alone after the build: loop_per_frame (step
17), capacity (20), mover (18), chunk_reloc (19).)

1. Prints the card (nvidia-smi name and power limit) and the torch build.
2. Builds the CUDA kernels from lc_crf_slam_torch/csrc/ (both FAST
   kernels and the segment sum; one nvcc process per source, started
   together).
3. Holds each FAST kernel against its plain PyTorch version and times
   both with CUDA events (the segment sum: step 16):
   - `fast_nms_dual` (both NMS'd score maps of every level of every frame
     of a batch in one launch): bitwise through its one-level entry on
     the 8 pyramid levels of a rendered TUM3 frame and on two random
     images (200x300, not a multiple of the tile; 256x256), and on the
     pyramids of B=1 (that frame), B=2 and B=15 frames, each in one
     launch; level 0 alone and each batch timed;
   - `fast_cell_best` (FAST + NMS + best corner per 16-px cell, all levels
     of all frames of a batch in one launch): `best` bitwise, `y` and `x`
     exact, at B=1 (the 8 levels of a rendered frame), B=2 (a stereo pair),
     B=8 (the command line's chunk), B=15 (a chunk of rendered frames) and
     B=30 (a stereo chunk: 15 left and 15 right eyes).
4. Tracking phase: SLAMSystem.track_rgbd with mapping and the CRF off on
   the first 16 rendered 640x480 frames of a 600-point static world
   (31 frames long), default map
   capacities (32768 points, 320 keyframes, 1024 features). Checks one
   fused FAST launch per frame, no lost frame, keyframes made, ATE < 1 cm.
5. Dynamic phase: the per-frame dynamic pipeline (mapping and the CRF on,
   loop closing off) on bench.py's billboard world (a rigid textured
   mover crossing a 1400-point static scene), frames 0-30. Checks one
   fused launch per frame, no frame lost, >= 2 keyframes, one mapping_step
   per keyframe, one crf_step per frame after the first, ATE < 2 cm, and
   1 host sync on a non-keyframe frame (torch's sync debug mode). The
   phase runs twice (step 21).
6. Sequence phase: the chunked throughput path on the same frames with the
   default SLAMConfig (loop detection on):
   `SLAMSystem.track_sequence(grays, depths, timestamps, chunk=15)`.
   Checks 0 lost frames, ATE < 2 cm, >= 2 keyframes, one mapping_step and
   one detect_loop per in-chunk keyframe, one crf_step per chunk,
   1 + chunks fused launches, and at most frames + 1 host syncs inside a
   chunk. Prints ms/frame over the 30 chunked frames beside the dynamic
   phase's, the split by the chunked path's `chunk.<phase>` spans and peak memory.
7. Loop phase: the reference's default-config loop world (a 1.2-turn pan
   over a textured wall with depth noise) at 640x480, 130 frames, default
   SLAMConfig and map capacities, through `track_sequence(chunk=15)`. The
   revisit must close a loop: checks >= 1 entry in `loop_log`, finite
   poses, >= 1 global-BA slice run and none pending after
   `get_trajectory()`, every live point's observation count equal to the
   recount of the observation table, the keyframes' ATE right after the
   first `correct_loop` no worse than 1.1 x the same keyframes' just
   before it, 1 + chunks (+ 1 per relocalisation attempt) fused launches,
   and at most frames + 1 host syncs per chunk plus one per verified
   candidate (and three per relocalisation attempt). A closure
   re-anchors the tracker on its reference keyframe's pose with zero
   velocity, as the reference does (tests/test_torch_loop_close.py holds
   the port to it). Which candidate closes, and whether the chunks after
   it lose track until relocalisation at a boundary, turns on float
   order: on the CPU the jitted reference closes keyframe 21 on candidate
   5 and loses nothing, while the reference run op for op closes it on
   candidate 3 and loses 23 frames, as the port does on the CPU and here
   (tests/test_torch_loop_full_size.py; LOOP_REFERENCE). So the gates are
   what both reference runs share: no frame lost before the first
   closure, ATE < 0.35 m (the reference's bar for this world) over the
   frames up to the end of the closing chunk, tracking back by the end of
   the run. The ATE over all frames, the lost frames and the keyframes'
   ATE after each global-BA slice and at the end are printed, and the
   reference's runs beside them.
   Prints, each line beside the card's name and power limit: ms/frame,
   the ms of every `verify_loop`, `correct_loop`, `global_ba` slice and
   group-wide `search_and_fuse` (a synchronize on both sides), `loop_log`,
   keyframes, both ATEs and peak memory.
   Each phase sets the wrappers' launch counts to 0 just before it drives
   its path and reads them just after: the map kernel is off every path
   and must count 0 there; the segment sum must count at least 1 on every
   path that runs local BA or a pose graph, and 0 on the two that run
   neither (tracking, direct descriptor).
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
   it the same frames with `mesh=None`, both with the default
   algorithms. Checks poses bitwise equal to each other and to the
   sequence phase's, the same keyframes, fused launches 1 + shards x
   chunks, at most frames + 1 host syncs a chunk;
   (c) on the loop phase's final map at full capacity (320 keyframes,
   32768 points), `dist_solve_ba` and `dist_solve_ba_blocks` against
   `solve_ba`, 10 iterations each, timed and compared with the default
   algorithms: cameras and points bitwise equal (one rank sums the same
   edges in the same order);
   (d) on that map's CRF tracks, `dist_knn_graph` + `dist_mean_field`
   against `knn_graph` + `mean_field`: neighbours equal, weights and
   q_dyn within 1e-6.
   Prints each stage's ms and the phase's peak memory beside the card's
   name and power limit.
16. Segment-sum kernel (`csrc/segment_sum.cu`, run after the loop
   phase): `segment_sum` on the card against `segment_sum_plain`
   (`index_add_`) on CPU copies of the same inputs, bitwise, at BA's
   Hcc (E, 6, 6), Hpp (E, 3, 3) and W (E, 6, 3) sums over the loop
   phase's final map (C = 320 keyframes, P = 32768 points, E = 327680
   edge slots) and `solve_ba_cg`'s matvec halves over it (E, 3) -> P and
   (E, 6) -> C; local BA's Hcc, g_c, Hpp, g_p and W over the newest
   keyframe's window at its capacity (C = 32, P = 4096, E = 32768); the
   SE3 and Sim(3) pose graphs' block diagonals D (2E, 6, 6) and (2E, 7,
   7) over that map's essential graph (float32, and float64 7x7) and the
   SE3 graph's gradient and matvec (2E, 6); an empty edge list and one
   target hit by every edge. Each timed with CUDA events, device-only
   and host-bound, beside `index_add_` with the default algorithms
   (float atomics) and with deterministic ones, and its plan; the device
   kernels of one call counted in a `torch.profiler` window.
   `python3 chip_smoke.py --segment-sum` runs this step alone, on the map
   of tests/data/loop_per_frame_ba_map.npz.
17. Per-frame loop phase: the loop phase's 130 frames through
   `track_rgbd`, default SLAMConfig, mapping and the CRF on. After them
   (read from the system then; its pose hash is the trajectory's at that
   frame) the reference test's gates (tests/test_loopclosure_render_e2e.py:
   93-97): >= 1 loop, the first one's keyframe inside `kf_log`, ATE <
   0.10 m, 0 lost frames, >= 20 keyframes; the keyframes' ATE right after
   `correct_loop` <= 1.1 x just before it; the map handed to the first
   global-BA slice equal to BA_MAP_FILE (to 1e-5), and the keyframes' ATE
   after each slice and at frame 129 <= 1.1 x the reference's global BA
   on that map (it raises their ATE on this world,
   tests/test_torch_loop_close.py::test_global_ba_on_the_cards_loop_map).
   Then "two loops per frame": the same world rendered on to frame 158
   (its pan at the same yaw per frame, 1.5 turns), so that after the
   first closure the camera pans over the first turn's sector again and
   detection runs against the corrected map (its keyframes on frames 153
   and 158 verify candidates there). Over all 159 frames: every
   closure's keyframe inside `kf_log`, closures at least
   `min_kfs_since_last` keyframes apart, candidates verified after frame
   129, ATE < 0.10 m, 0 lost frames, exactly one `global_ba` slice on
   each frame while a budget is pending (the closing frame included) and
   none on the others, none pending after `get_trajectory()`, every live
   point's `p_n_obs` equal to the recount, 1 host sync on every
   non-keyframe frame from the 4th on with no budget pending, one fused
   launch a frame. Prints the ms of each closing frame, the keyframes' ATE
   just before and after each `correct_loop`, the ms of each
   `verify_loop`, `correct_loop`, `global_ba` slice and `search_and_fuse`,
   and the frames after frame 129 that verify candidates.
   (No pan length tried closes a second loop: PERF.md, PR 10.)
18. Revisit-with-a-mover phase: tests/test_loopclosure_render_e2e.py's
   `_run(billboard=True)` (:32-63): a QVGA sweep over 1600 points, seed
   3, a billboard mover in the start sector, 96 frames through
   `track_rgbd`, `min_total_matches=25`, the reverse neighbour fuse off,
   default capacities. The reference test's gates (:99-144): a loop, or
   early and late keyframes reconnected through covisibility (>= 12
   shared points); ATE < 0.10 m; <= 8 lost frames; judged mover points
   <= 8% and all mover points <= 20% of the live points; >= 55 live
   points. One fused launch a frame.
19. Chunk-boundary relocalisation phase: the world of
   tests/test_torch_sequence.py::test_blackout_relocalises_at_the_chunk_boundary
   (a QVGA sweep, frames 0-35, two black frames, frames 0-7) through
   `track_sequence(chunk=4)` with `max_frames_between_kf=4`. Checks a
   `chunk_lost` and a `chunk_reloc` event, lost frames only from frame
   36 to the next chunk boundary (40), status 1 at the end, at most
   frames + 1 host syncs a chunk plus 3 per relocalisation attempt, the
   final camera within 0.06 m of the revisited frame's ground truth
   (tests/test_tracking_e2e.py:196-204), 1 + chunks fused launches.
20. Capacity phase: the tracking world's orbit (repeating past its 31
   frames), 45 frames through `track_rgbd` with the default SLAMConfig
   but 16 keyframe slots (the least local BA's window takes) and 4096
   point slots (the least tracking's top-k takes): the configuration of
   tests/test_torch_capacity.py's orbit run (`torch_parity.ORBIT_CFG`).
   The keyframe table fills (frame 34), later keyframe decisions drop
   their insert and map on keyframe 15; the point table's high-water
   mark reaches its end (frame 38 on the CPU) and `add_points` hands
   culled slots out again, condemning the keyframe references to them to
   -2 and sending the ones still vetoing movers to the tombstone ring
   (every `add_points` counted on the card). Checks exactly one
   `capacity_full` event, 16 keyframes in the map, no lost frame, ATE <
   0.02 m, one fused launch a frame, >= 1 segment-sum launch, >= 1 slot
   reused and >= 1 reference condemned, no reference to a reused slot
   left behind by any `add_points`, and every live point's observation
   count equal to the recount. Prints the frame that reached the mark,
   the slots reused, the references condemned, `tomb_n`, live points
   and the references to culled slots not yet reused (kept on purpose,
   as the reference keeps them), and the peak device memory up to the
   fill and after it, beside the same frames up to the fill at the
   default capacity (320 keyframes, 32768 points).
21. Repeatability, with the default algorithms everywhere: the dynamic
   phase runs twice and both runs must give bitwise equal poses and the
   same keyframes; the sequence phase and the distributed phase's two
   runs must give bitwise equal poses and the same keyframes (step 15).
   Every phase's trajectory (the float64 Twc of `get_trajectory()`) is
   hashed (sha256, the first 16 hex digits) and printed on one line, so
   that two calls can be compared.
22. Prints the kernel report as one JSON line (`launches` = the paths'
   own, the kernel checks' launches apart), the card line again, and
   last `{"ok": true, "device": {...}}`.

Any failure raises, and the exit code is then non-zero. Without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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
N_FRAMES = 31             # the tracking world's length
TRACK_FRAMES = 16         # the tracking phase drives its first 16 frames
ATE_BAR_M = 0.01
DYN_FRAMES = 31
DYN_ATE_BAR_M = 0.02      # the reference's bar for its full pipeline
SEQ_CHUNK = 15
LOOP_FRAMES = 130
# the reference's default-config loop world (tests/test_loop_throughput_e2e.py:34-43)
LOOP_WORLD = dict(n_static=900, n_dynamic=0, seed=5, trajectory="pan", wall=True,
                  pan_leadin=0.1, pan_turns=1.2, pan_translation=0.25,
                  render_depth_noise=0.015)
LOOP_ATE_BAR_M = 0.35     # the reference's bar for this world in throughput mode
LOOP_KF_ATE_FACTOR = 1.1  # keyframes' ATE after the closure vs just before it
# The reference's own runs of the loop phase's world on the CPU
# (tests/test_torch_loop_full_size.py::test_chunked_loop_full_size_matches_reference,
# with the port's random draws): name -> (first closure (keyframe, candidate,
# inliers), frames lost, ATE over the 130 frames in m)
LOOP_REFERENCE = {"jitted": ((21, 5, 135), 0, 0.03735),
                  "op for op": ((21, 3, 60), 23, 0.73181)}
# The map the per-frame loop phase holds just before its first global-BA
# slice, cut to its used slots (`ba_map_arrays`), with the keyframes its
# ATE is taken over and the reference's keyframe ATE after each global-BA
# slice on it, computed and checked on the CPU by
#   JAX_PLATFORMS=cpu python -m pytest \
#       tests/test_torch_loop_close.py -k global_ba_on_the_cards_loop_map
# A run whose map differs writes its own to chiprun_out/ (BA_MAP_OUT).
BA_MAP_FILE = os.path.join(HERE, "tests", "data", "loop_per_frame_ba_map.npz")
BA_MAP_OUT = os.path.join(HERE, "chiprun_out", "loop_per_frame_ba_map.npz")
BA_MAP_KF_FIELDS = ("kf_Tcw", "kf_time", "kf_alive", "kf_uv", "kf_ur", "kf_level",
                    "kf_valid", "kf_obs")
BA_MAP_P_FIELDS = ("p_xyz", "p_alive")
BA_MAP_TOL = 1e-5         # metres, the file's map against the run's
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
DIST_CRF_TOL = 1e-6       # the reference's bar (tests/test_dist.py)
DIST_BA_ITERS = 10        # solve_ba's default
# tests/test_loopclosure_render_e2e.py's gates, per frame
PF_LOOP_ATE_BAR_M = 0.10
PF_LOOP_MIN_KFS = 20
MOVER_FRAMES = 96
MOVER_MAX_LOST = 8
MOVER_JUDGED_SHARE = 0.08     # judged mover points / live points
MOVER_ALL_SHARE = 0.20        # all mover points / live points
MOVER_MIN_LIVE = 55
MOVER_RECONNECT = 12          # early-late covisibility without a loop
# step 17 goes on past the loop world's 130 frames: the same world
# rendered on (its pan at the same yaw per frame, 1.5 turns by frame
# 158), so that after the first closure the camera pans over the first
# turn's sector again, where a second loop could close
TWO_LOOP_FRAMES = 159
# step 20: a full keyframe table, per frame: the tracking world's orbit
# (past its 31 frames the orbit repeats) with 16 keyframe slots, the least
# local BA's window takes (tests/test_torch_capacity.py holds the port to
# the reference there on the CPU); the table fills on frame 34
CAPACITY_KFS = 16
CAPACITY_POINTS = 4096    # the least tracking's top-k of LOCAL_POINTS takes
CAPACITY_FRAMES = 45
# tests/test_torch_sequence.py::test_blackout_relocalises_at_the_chunk_boundary
RELOC_FRAMES = list(range(36)) + [-1, -1] + list(range(8))   # -1: black
RELOC_CHUNK = 4
RELOC_BLACK_AT = 36
RELOC_REVISIT = 7         # the world frame the sequence ends on
RELOC_POS_BAR_M = 0.06    # tests/test_tracking_e2e.py:204
RELOC_SYNCS = 3           # host syncs a relocalisation attempt may add
# the paths that run no local BA and no pose graph: no segment sum
NO_SEGMENT_SUM = ("tracking", "direct_descriptor")
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


def qvga():
    """The QVGA camera of the reference's rendered end-to-end tests
    (tests/test_loopclosure_render_e2e.py:27, tests/test_tracking_e2e.py)."""
    from lc_crf_slam_torch.geometry.camera import Pinhole

    return Pinhole(fx=268.0, fy=270.0, cx=160.0, cy=120.0, width=320, height=240,
                   bf=20.0)


# phase -> hash of its final trajectory (step 21)
POSE_HASHES = {}


def pose_hash(poses) -> str:
    return hashlib.sha256(np.ascontiguousarray(poses).tobytes()).hexdigest()[:16]


# phase -> its seconds, rendering and checks included
PHASE_S = {}


def phase(name, fn, *args):
    """fn(*args), its wall time kept in PHASE_S[name]."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = round(time.perf_counter() - t0, 1)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def synced_ms(fn, *args):
    """(fn(*args), its ms with a synchronize on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def cuda_ms(fn, *args, batches: int = 20, reps: int = 10):
    """(device ms, host-bound ms) of one call, each the median of
    `batches` CUDA-event timings of `reps` back-to-back calls.

    Device time: a spin kernel holds the stream while the batch is
    enqueued, so the events bracket only the GPU's own work; it spins
    three times as long as one warm batch took to enqueue, at least ~1 ms
    and at most ~25 ms. Host-bound time: no spin, so the gaps while Python
    enqueues each call count too (what a caller that launches one level at
    a time pays)."""
    for _ in range(min(3, batches)):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    enqueue_s = time.perf_counter() - t0
    # GPU clock cycles (~2 GHz)
    spin_cycles = int(min(50e6, max(2e6, 3 * enqueue_s * 2e9)))
    out = []
    for spin in (True, False):
        times = []
        for _ in range(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            if spin:
                torch.cuda._sleep(spin_cycles)
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


def check_fast_kernel(images, grays, cfg):
    """Map kernel vs plain version: each of `images` alone through the
    one-level entry, and the pyramids of the first 1, 2 and 15 of `grays`
    (B, H, W) each in one launch, bitwise; times of level 0 alone and of
    each batch. Returns the report rows by case."""
    from lc_crf_slam_torch.ops.fast import fast_score_dual
    from lc_crf_slam_torch.ops.fast_kernel import (fast_nms_dual_cuda,
                                                   fast_nms_dual_plain,
                                                   fast_score_dual_cuda)
    from lc_crf_slam_torch.ops.pyramid import build_pyramid_batch

    th = (float(cfg.orb.ini_th_fast), float(cfg.orb.min_th_fast))
    cases = [(name, img, fast_score_dual_cuda, fast_score_dual) for name, img in images]
    for B in (1, 2, 15):
        pyr = build_pyramid_batch(grays[:B], cfg.orb.n_levels, cfg.orb.scale_factor)
        cases.append((f"B={B}", pyr, fast_nms_dual_cuda, fast_nms_dual_plain))
    rows = {}
    for name, x, kernel, plain in cases:
        hi, lo = kernel(x, *th)
        ph, pl = plain(x, *th)
        torch.cuda.synchronize()
        err = max(float((hi - ph).abs().max()), float((lo - pl).abs().max()))
        if not (torch.equal(hi, ph) and torch.equal(lo, pl)):
            raise AssertionError(f"FAST map kernel != plain version on {name}: "
                                 f"max abs err {err}")
        if not (name == "level0" or name.startswith("B=")):
            print(f"fast_nms {name:>13} {tuple(x.shape)}: bitwise equal")
            continue
        n_pixels = ph.numel()
        n_scored = int((ph > 0).sum()) + int((pl > 0).sum())
        ms, host_ms = cuda_ms(kernel, x, *th)
        plain_ms = synced_ms(plain, x, *th)[1]
        b_ms, b_by = bound(12 * n_pixels, n_pixels, n_scored)
        rows[name] = {"max_abs_err": err, "ms": ms, "host_ms": host_ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        print(f"fast_nms {name:>13} ({n_pixels} pixels, {n_scored} non-zero scores, "
              f"one launch): bitwise equal; device kernel {ms:.4f} ms, host-bound "
              f"{host_ms:.4f} ms, plain {plain_ms:.2f} ms; bound {b_ms:.5f} ms by {b_by}")
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
    plain_ms = synced_ms(fast_cell_best_plain, *args)[1]
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


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from lc_crf_slam_torch.ops import fast_kernel, segment_sum
    fast_kernel.reset_launches()
    segment_sum.reset_launches()


def path_launches():
    """(fused, map, segment-sum) kernel launches since `reset_counts()`."""
    from lc_crf_slam_torch.ops import fast_kernel, segment_sum
    return fast_kernel.cell_launches, fast_kernel.launches, segment_sum.launches()


def drive(slam, frames, counted, track=None, sites=None):
    """Every frame through `track(frame)` (default `slam.track_rgbd`), each
    timed to a synchronize: (ms per frame, {frame: host syncs} for the
    frames in `counted`, counted in torch's sync debug mode, (fused, map,
    segment-sum) kernel launches of the path, peak device MiB). A dict
    `sites` fills with each counted frame's `sync_sites`."""
    track = track or (lambda f: slam.track_rgbd(f.image, f.depth_image, f.timestamp))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    """`got` = (fused, map, segment-sum) launches of a phase's path: the
    fused kernel as often as the path asks for it, the map kernel never
    (the segment sum is checked over all paths at the end)."""
    if got[:2] != (n_fused, 0):
        raise AssertionError(
            f"{phase}: kernel launches (fused, map) = {got[:2]}, expected "
            f"({n_fused}, 0)")


def tracking_phase(cam, frames, world) -> int:
    """The tracking slice at full width (see the module docstring, step 4);
    returns the path's kernel launches."""
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
    if poses.shape != (TRACK_FRAMES, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"bad trajectory: shape {poses.shape}")
    ate = ate_rmse(ts, poses, gt_t, gt)
    POSE_HASHES["tracking"] = pose_hash(poses)
    statuses = [s.get("status", 1) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    inliers = [s["n_inliers"] for s in slam.stats if "n_inliers" in s]
    med = statistics.median(frame_ms[3:])
    print(f"slice: {TRACK_FRAMES} frames, median {med:.2f} ms/frame after the "
          f"first 3 ({1e3 / med:.1f} fps), first frame {frame_ms[0]:.1f} ms, "
          f"ATE {ate:.5f} m, keyframes {n_kfs}, mean inliers "
          f"{np.mean(inliers):.1f}, lost frames {statuses.count(2)}, "
          f"kernel launches (fused, map, segment sum) {got}, peak memory {peak_mb:.0f} MiB, "
          f"host syncs per frame {list(syncs.values())}")
    check_launches("tracking phase", got, TRACK_FRAMES)
    if 2 in statuses:
        raise AssertionError(f"tracking lost: statuses {statuses}")
    if n_kfs < 2:
        raise AssertionError(f"only {n_kfs} keyframes")
    if not ate < ATE_BAR_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_BAR_M} m")
    return got


def dynamic_phase(cam, frames, world, name="dynamic"):
    """The per-frame dynamic pipeline at full width (see the module
    docstring, step 5); returns (the path's kernel launches, its mean
    ms/frame after the first frame, its trajectory, its keyframe log)."""
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
    POSE_HASHES[name] = pose_hash(poses)
    statuses = [s.get("status", 1) for s in slam.stats]
    is_kf = [bool(s.get("need_kf")) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    kf_ms = [t for t, kf in zip(frame_ms[3:], is_kf[3:]) if kf]
    other_ms = [t for t, kf in zip(frame_ms[3:], is_kf[3:]) if not kf]
    kf_at = [k for k in range(3, DYN_FRAMES) if is_kf[k]]
    other_at = [k for k in range(3, DYN_FRAMES) if not is_kf[k]]
    last = slam.stats[-1]
    med = statistics.median(frame_ms[3:])
    print(f"{name} [{card_line()}]: {DYN_FRAMES} frames, median {med:.2f} "
          f"ms/frame after the first 3 (keyframe frames {statistics.median(kf_ms):.2f} "
          f"over {len(kf_ms)}, other frames {statistics.median(other_ms):.2f} over "
          f"{len(other_ms)}), mean of frames 1-{DYN_FRAMES - 1} {np.mean(frame_ms[1:]):.2f}, "
          f"first frame {frame_ms[0]:.1f} ms")
    print(f"{name}: ATE {ate:.5f} m (JAX reference on the same frames, CPU: "
          f"{REF_DYN_ATE_M:.5f} m), keyframes {n_kfs}, lost frames "
          f"{statuses.count(2)}, mapping_step calls {slam.n_mapping_steps}, "
          f"crf_step calls {slam.n_crf_steps}, kernel launches (fused, map, segment sum) {got}, "
          f"peak memory {peak_mb:.0f} MiB")
    print(f"{name}: host syncs on keyframe frame {kf_at[0]}: {syncs[kf_at[0]]}, on "
          f"non-keyframe frame {other_at[0]}: {syncs[other_at[0]]}; per frame "
          f"from the 4th {list(syncs.values())}")
    print(f"{name}: last frame n_dynamic {last['n_dynamic']}, n_tracks "
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
    return got, float(np.mean(frame_ms[1:])), poses, slam.kf_log


def gba_slices(slam) -> int:
    """The system's global-BA slices so far: its `global_ba_slice` spans."""
    return slam.timer.count("global_ba_slice")


def chunk_phases(slam, n_frames: int) -> str:
    """The chunked path's phases so far (its `chunk.<phase>` spans), host
    ms a frame over `n_frames`."""
    return ", ".join(f"{name} {s * 1e3 / n_frames:.2f}"
                     for name, (_, s) in slam.timer.span_totals("chunk.").items())


def count_chunks(slam) -> list:
    """Wrap `slam._track_chunk` so that every chunk runs in torch's sync
    debug mode and is timed to a synchronize; the returned list fills with
    (frames, host syncs, ms, (loop candidates verified, relocalisation
    attempts), the chunk's last frame if it closed a loop else None) per
    chunk."""
    chunks = []
    inner = slam._track_chunk
    # one sampler per relocalisation attempt: count the attempts
    attempts = [0]
    reloc_sampler = slam._reloc_sampler

    def counted_sampler():
        attempts[0] += 1
        return reloc_sampler()

    slam._reloc_sampler = counted_sampler

    def rare():
        return slam.n_verify_loops, len(slam.loop_log), attempts[0]

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
    docstring, step 6); returns (the path's kernel launches, its
    ms/frame, its poses, its keyframe log)."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem

    cfg = SLAMConfig()          # loop detection on
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True,
                      device="cuda")
    grays = np.stack([f.image for f in frames]).astype(np.float32)
    depths = np.stack([f.depth_image for f in frames]).astype(np.float32)
    stamps = [f.timestamp for f in frames]

    chunks = count_chunks(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    POSE_HASHES["sequence"] = pose_hash(poses)
    n_lost = sum(s.get("lost_frames", 0) for s in slam.stats
                 if s.get("event") == "chunk_lost")
    n_kfs = int(slam.map.n_kfs)
    in_chunk_kfs = len(slam.kf_log)
    ms_frame = sum(c[2] for c in chunks) / n_seq
    phases = slam.timer.span_totals("chunk.")
    total = sum(s for _, s in phases.values())
    print(f"sequence: {n_seq} chunked frames in {n_chunks} chunks of {SEQ_CHUNK}: "
          f"{ms_frame:.2f} ms/frame (chunks {[round(c[2], 1) for c in chunks]} ms); "
          f"the same world per frame through track_rgbd (dynamic phase, loop "
          f"detection off): {dyn_ms:.2f} ms/frame")
    print(f"sequence: chunk phases, host ms/frame: {chunk_phases(slam, n_seq)} (sum "
          f"{total * 1e3 / n_seq:.2f})")
    print(f"sequence: ATE {ate:.5f} m, keyframes {n_kfs} ({in_chunk_kfs} in chunks), "
          f"lost frames {n_lost}, mapping_step calls {slam.n_mapping_steps}, "
          f"detect_loop calls {slam.n_detect_loops}, crf_step calls "
          f"{slam.n_crf_steps}, kernel launches (fused, map, segment sum) {got}, host syncs per "
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
    return got, ms_frame, poses_tcw, slam.kf_log


def keyframe_ate(kf_Tcw, kf_time, which, gt_times, gt_twc) -> float:
    """ATE of the keyframes `which` (bool mask) against the ground truth
    at their timestamps."""
    Twc = np.linalg.inv(kf_Tcw[which].astype(np.float64))
    return ate_rmse(kf_time[which], Twc, gt_times, gt_twc)


def loop_world(cam):
    """The reference's default-config loop world (a 1.2-turn pan over a
    textured wall with depth noise, tests/test_loop_throughput_e2e.py:
    34-43) at the camera's size: (world, its LOOP_FRAMES rendered frames)."""
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    t0 = time.perf_counter()
    world = SyntheticWorld(cam=cam, n_frames=LOOP_FRAMES, **LOOP_WORLD)
    frames = [world.frame(k, render=True) for k in range(LOOP_FRAMES)]
    print(f"loop: rendered {LOOP_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    return world, frames


@contextlib.contextmanager
def timed_stages():
    """Inside the block every closure stage of the system module
    (`verify_loop`, `correct_loop`, `global_ba`, `search_and_fuse`) runs
    timed to a synchronize on both sides, outside torch's sync debug mode
    (the timers' own device reads stay out of the sync counts). Yields
    ({stage: [ms]}, {} that fills with the keyframes just before the first
    `correct_loop`: Tcw, time, alive, their poses after it and after each
    `global_ba` slice of its budget: "after" [(stage, Tcw)], and the map
    the first slice is handed: "ba_map" (`ba_map_arrays`), [] that fills
    with every `correct_loop`'s keyframes just before it and after it:
    {Tcw, time, alive, Tcw_after})."""
    from lc_crf_slam_torch.models import system

    stage_ms = {"verify_loop": [], "correct_loop": [], "global_ba": [],
                "search_and_fuse": []}
    before = {}
    closures = []

    def timed(name):
        inner = getattr(system, name)

        def stage(*args):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            if name == "correct_loop":
                m = args[2]
                n = int(m.n_kfs)
                closures.append(dict(Tcw=m.kf_Tcw[:n].cpu().numpy(),
                                     time=m.kf_time[:n].cpu().numpy(),
                                     alive=m.kf_alive[:n].cpu().numpy()))
                if not before:
                    before.update(closures[-1])
            if name == "global_ba" and before and "ba_map" not in before:
                before["ba_map"] = ba_map_arrays(args[2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "correct_loop":
                closures[-1]["Tcw_after"] = out.kf_Tcw[:n].cpu().numpy()
            if name in ("correct_loop", "global_ba") and before \
                    and len(before.setdefault("after", [])) < 4:
                n0 = len(before["alive"])
                before["after"].append((name, out.kf_Tcw[:n0].cpu().numpy()))
            torch.cuda.set_sync_debug_mode(mode)
            return out

        setattr(system, name, stage)
        return inner

    originals = {name: timed(name) for name in stage_ms}
    try:
        yield stage_ms, before, closures
    finally:
        for name, fn in originals.items():
            setattr(system, name, fn)


def stale_obs_counts(m) -> int:
    """Live points whose observation count differs from the weighted
    recount of the live keyframes' observation table (a depth-backed entry
    counts 2)."""
    kf_alive = m.kf_alive.cpu().numpy()
    obs = m.kf_obs.cpu().numpy()[kf_alive]
    valid = m.kf_valid.cpu().numpy()[kf_alive] & (obs >= 0)
    w = 1 + (m.kf_ur.cpu().numpy()[kf_alive] >= 0).astype(np.int64)
    P = m.capacity_points
    recount = np.bincount(obs[valid].ravel(), weights=w[valid].ravel(),
                          minlength=P)[:P].astype(np.int64)
    return int((m.p_alive.cpu().numpy() & (m.p_n_obs.cpu().numpy() != recount)).sum())


def ba_map_arrays(m) -> dict:
    """The fields of map `m` that global BA reads, cut to its used
    keyframe and point slots, as numpy arrays."""
    nk, n_pts = int(m.n_kfs), int(m.n_points)
    out = {f: getattr(m, f)[:nk].cpu().numpy() for f in BA_MAP_KF_FIELDS}
    out.update({f: getattr(m, f)[:n_pts].cpu().numpy() for f in BA_MAP_P_FIELDS})
    return out


def load_ba_map(cfg, path: str = BA_MAP_FILE):
    """(an empty map of cfg's capacities on the CPU holding the slots of
    the file written from `ba_map_arrays`, the file's arrays)."""
    from lc_crf_slam_torch.convert import map_from_slots

    z = dict(np.load(path))
    slots = {f: z[f] for f in BA_MAP_KF_FIELDS + BA_MAP_P_FIELDS}
    return map_from_slots(cfg, dict(slots, n_kfs=np.int32(len(z["kf_Tcw"])),
                                    n_points=np.int32(len(z["p_xyz"])))), z


def ba_map_diff(a: dict, b) -> float:
    """The largest difference of two `ba_map_arrays` maps' float fields
    (inf where a shape or an integer or boolean field differs)."""
    worst = 0.0
    for f in BA_MAP_KF_FIELDS + BA_MAP_P_FIELDS:
        x, y = np.asarray(a[f]), np.asarray(b[f])
        if x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        if x.dtype.kind == "f":
            worst = max(worst, float(np.abs(x - y).max(initial=0.0)))
        elif not np.array_equal(x, y):
            return float("inf")
    return worst


def closure_kf_ates(before, m, gt_times, gt):
    """(keyframes compared, their ATE just before the first correct_loop,
    now, [ATE after correct_loop and after each global_ba slice]): the
    keyframes alive then and still alive."""
    n0 = len(before["alive"])
    same = before["alive"] & m.kf_alive.cpu().numpy()[:n0]
    ate = lambda Tcw: keyframe_ate(Tcw, before["time"], same, gt_times, gt)  # noqa: E731
    return (int(same.sum()), ate(before["Tcw"]), ate(m.kf_Tcw[:n0].cpu().numpy()),
            [ate(Tcw) for _, Tcw in before.get("after", [])])


def loop_reference_line(card, loop_log, n_lost, ate) -> str:
    """The card's first closure, lost frames and ATE beside the
    reference's own runs of the same world (LOOP_REFERENCE)."""
    closure = (loop_log[0]["kf"], loop_log[0]["cand"], loop_log[0]["inliers"])
    ref = "; ".join(f"{name} closure {c}, {lost} lost, ATE {a} m"
                    for name, (c, lost, a) in LOOP_REFERENCE.items())
    return (f"loop [{card}]: closure (kf, cand, inliers) {closure}, {n_lost} lost, ATE "
            f"{ate:.5f} m; the reference on the CPU: {ref}")


def loop_phase(cam, world, frames):
    """Loop closing at full width (see the module docstring, step 7);
    returns (the path's kernel launches, its final map copied to the
    host, the tracker's frame index)."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models import system

    grays = np.stack([f.image for f in frames]).astype(np.float32)
    depths = np.stack([f.depth_image for f in frames]).astype(np.float32)
    stamps = [f.timestamp for f in frames]
    gt_times, gt = world.groundtruth()
    card = card_line()

    slam = system.SLAMSystem(cam, SLAMConfig(), enable_mapping=True, enable_crf=True,
                             device="cuda")
    with timed_stages() as (stage_ms, before, _):
        chunks = count_chunks(slam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        poses_tcw = slam.track_sequence(grays, depths, stamps, chunk=SEQ_CHUNK)
        torch.cuda.synchronize()
        got = path_launches()
        slices_in_run = gba_slices(slam)
        slam.flush_stats()
        ts, poses = slam.get_trajectory()       # finishes a pending global BA
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    n_seq = LOOP_FRAMES - 1
    n_chunks = -(-n_seq // SEQ_CHUNK)
    if poses.shape != (LOOP_FRAMES, 4, 4) or not np.all(np.isfinite(poses)) \
            or poses_tcw.shape != (n_seq, 4, 4) or not np.all(np.isfinite(poses_tcw)):
        raise AssertionError(f"loop phase: bad trajectory, shapes {poses.shape} "
                             f"{poses_tcw.shape}")
    ate = ate_rmse(ts, poses, gt_times, gt)
    POSE_HASHES["loop"] = pose_hash(poses)
    n_lost = sum(s.get("lost_frames", 0) for s in slam.stats
                 if s.get("event") == "chunk_lost")
    m = slam.map
    n_kfs = int(m.n_kfs)
    ms_frame = sum(c[2] for c in chunks) / n_seq
    print(f"loop [{card}]: {n_seq} chunked frames in {n_chunks} chunks of {SEQ_CHUNK}: "
          f"{ms_frame:.2f} ms/frame (chunks {[round(c[2], 1) for c in chunks]} ms)")
    print(f"loop [{card}]: chunk phases, host ms/frame: {chunk_phases(slam, n_seq)}")
    for name, ms in stage_ms.items():
        print(f"loop [{card}]: {name} x{len(ms)}: ms {[round(t, 1) for t in ms]}")
    print(f"loop [{card}]: loop_log {slam.loop_log}, verified candidates {slam.n_verify_loops}, "
          f"global-BA slices {gba_slices(slam)} ({slices_in_run} inside the run), "
          f"keyframes {n_kfs}, lost frames {n_lost}, kernel launches (fused, map, "
          f"segment sum) {got}, host syncs per chunk {[c[1] for c in chunks]} with "
          f"{[c[3] for c in chunks]} (verified candidates, relocalisation attempts), "
          f"peak memory {peak_mb:.0f} MiB")
    failures = []
    try:
        # a relocalisation attempt at a chunk boundary builds its frame
        check_launches("loop phase", got, 1 + n_chunks + sum(c[3][1] for c in chunks))
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
    if gba_slices(slam) < 1 or slam._gba_pending is not None:
        failures.append(f"{gba_slices(slam)} global-BA slices, pending "
                        f"{slam._gba_pending}")
    if len(chunks) != n_chunks:
        failures.append(f"{len(chunks)} chunks, expected {n_chunks}")
    for n, syncs, _, (verified, relocs), _ in chunks:
        allowed = n + 1 + verified + 3 * relocs
        if syncs > allowed:
            failures.append(f"{syncs} host syncs in a chunk of {n} frames with "
                            f"{verified} verified candidates and {relocs} "
                            f"relocalisation attempts, at most {allowed} allowed")
    stale = stale_obs_counts(m)
    if stale:
        failures.append(f"{stale} live points whose observation count differs from "
                        f"the recount")
    if not before:
        raise AssertionError("loop phase: " + "; ".join(failures))
    n_same, ate_before, ate_after, steps = closure_kf_ates(before, m, gt_times, gt)
    print(f"loop [{card}]: ATE {ate:.5f} m over {LOOP_FRAMES} frames; the {n_same} "
          f"keyframes alive at the first closure: ATE {ate_before:.5f} m just before "
          f"it, {[round(a, 5) for a in steps]} m after correct_loop and each global-BA "
          f"slice, {ate_after:.5f} m at the end; {int(m.p_alive.sum())} live points")
    # the reference's bar over the frames the re-anchoring has not touched
    ate_upto = ate_rmse(ts[:first_closure + 1], poses[:first_closure + 1], gt_times, gt)
    print(f"loop [{card}]: ATE {ate_upto:.5f} m over frames 0-{first_closure} (up to the "
          f"end of the closing chunk)")
    print(loop_reference_line(card, slam.loop_log, n_lost, ate))
    if not ate_upto < LOOP_ATE_BAR_M:
        failures.append(f"ATE {ate_upto} m over frames 0-{first_closure} >= "
                        f"{LOOP_ATE_BAR_M} m")
    if not steps[0] <= LOOP_KF_ATE_FACTOR * ate_before:
        failures.append(f"keyframe ATE {steps[0]} m after correct_loop > "
                        f"{LOOP_KF_ATE_FACTOR} x {ate_before} m before")
    if failures:
        raise AssertionError("loop phase: " + "; ".join(failures))
    return got, type(m)(*(t.cpu() for t in m)), int(slam.ts.frame_idx)


def stereo_phase(cam):
    """`track_stereo` at full width (see the module docstring, step 8);
    returns the path's kernel launches."""
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
    POSE_HASHES["stereo"] = pose_hash(poses)
    statuses = [s.get("status", 1) for s in slam.stats]
    is_kf = [bool(s.get("need_kf")) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    other_at = [k for k in range(3, STEREO_FRAMES) if not is_kf[k]]
    print(f"stereo [{card_line()}]: {STEREO_FRAMES} pairs, median "
          f"{statistics.median(frame_ms[3:]):.2f} ms/frame after the first 3, first "
          f"frame {frame_ms[0]:.1f} ms; ATE {ate:.5f} m, keyframes {n_kfs}, lost frames "
          f"{statuses.count(2)}, mapping_step calls {slam.n_mapping_steps}, kernel "
          f"launches (fused, map, segment sum) {got}, peak memory {peak_mb:.0f} MiB, host syncs per "
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
    return got


def stereo_sequence_phase(cam, frames, rights, world, seq_ms: float):
    """`track_sequence_stereo` at full width (see the module docstring,
    step 9); returns the path's kernel launches."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem

    slam = SLAMSystem(cam, SLAMConfig(), enable_mapping=True, enable_crf=True,
                      device="cuda")
    lefts = np.stack([f.image for f in frames]).astype(np.float32)
    chunks = count_chunks(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    POSE_HASHES["stereo_sequence"] = pose_hash(poses)
    n_lost = sum(s.get("lost_frames", 0) for s in slam.stats
                 if s.get("event") == "chunk_lost")
    n_kfs = int(slam.map.n_kfs)
    ms_frame = sum(c[2] for c in chunks) / n_seq
    print(f"stereo sequence [{card_line()}]: {n_seq} chunked pairs in {n_chunks} chunks "
          f"of {SEQ_CHUNK}: {ms_frame:.2f} ms/frame (chunks "
          f"{[round(c[2], 1) for c in chunks]} ms); the RGB-D sequence phase on the same "
          f"left frames: {seq_ms:.2f} ms/frame")
    print(f"stereo sequence: chunk phases, host ms/frame: {chunk_phases(slam, n_seq)}")
    print(f"stereo sequence: ATE {ate:.5f} m, keyframes {n_kfs}, lost frames {n_lost}, "
          f"mapping_step calls {slam.n_mapping_steps}, crf_step calls "
          f"{slam.n_crf_steps}, kernel launches (fused, map, segment sum) {got}, host syncs per "
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
    return got


def mono_phase(cam):
    """`track_monocular` at full width (see the module docstring, step
    10); returns (the path's kernel launches, the system)."""
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
    POSE_HASHES["mono"] = pose_hash(poses)
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
          f"(fused, map, segment sum) {got}, peak memory {peak_mb:.0f} MiB; host syncs on the frames "
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
    return got, slam


def sim3_closure_stage(slam):
    """`correct_loop_sim3` handed a closure on the monocular map, on the
    card and on a CPU copy (see the module docstring, step 11); returns the
    kernel launches of the two calls on the card."""
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
    torch.cuda.synchronize()
    reset_counts()
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
    got = path_launches()
    POSE_HASHES["sim3_closure"] = pose_hash(out.kf_Tcw.cpu().numpy())
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
          f"host syncs {syncs}, kernel launches (fused, map, segment sum) {got}; card "
          f"vs CPU: kf_Tcw max abs diff {d_kf:.2e}, live "
          f"p_xyz max abs diff {d_p:.2e} m, live points {int(alive.sum())} vs "
          f"{int(alive_cpu.sum())}; the closing keyframe moved {moved:.4f}")
    if syncs != [0, 0]:
        raise AssertionError(f"sim3 closure: {syncs} host syncs inside correct_loop_sim3")
    if not (d_kf <= SIM3_TOL and d_p <= SIM3_TOL and torch.equal(alive, alive_cpu)):
        raise AssertionError(f"sim3 closure: card vs CPU kf_Tcw {d_kf}, p_xyz {d_p}, "
                             f"live points {int(alive.sum())} vs {int(alive_cpu.sum())}")
    if not (np.isfinite(d_kf) and moved > 0):
        raise AssertionError("sim3 closure: the closing keyframe did not move")
    return got


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
    (exit code, summary dict, its standard error, (fused, map, segment-sum)
    launches,
    seconds)."""
    from lc_crf_slam_torch import run_slam

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_slam.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return rc, json.loads(out.getvalue().splitlines()[-1]), err.getvalue(), \
        path_launches(), seconds


def tum_phase(cam, world, frames) -> dict:
    """The command line on a TUM-format sequence (see the module
    docstring, step 12); returns the kernel launches of its four
    paths."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
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
                  f"lines; kernel launches (fused, map, segment sum) {got}")
            if summary["frames"] != TUM_FRAMES or summary["lost_frames"] != 0:
                failures.append(f"{name}: frames {summary['frames']}, lost "
                                f"{summary['lost_frames']}")
            if not ate < ATE_BAR_M:
                failures.append(f"{name}: ATE {ate} m >= {ATE_BAR_M} m")
            if not (len(kf_t) >= 2 and kf_off <= KF_TIME_TOL_S):
                failures.append(f"{name}: keyframe times up to {kf_off} s off a frame time")
            if len(records) != n_records:
                failures.append(f"{name}: {len(records)} JSONL lines, {n_records} records")
            if got[:2] != (n_fused, 0):
                failures.append(f"{name}: kernel launches (fused, map, segment sum) {got}, expected "
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
        launches["tum"] = got

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
        launches["tum_throughput"] = got

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
              f"launches (fused, map, segment sum) {got}")
        if rc != 0 or summary["frames"] != TUM_PROFILE_FRAMES or not named \
                or got[:2] != (2, 0):
            failures.append(f"profiled: exit {rc}, {summary['frames']} frames, kernel "
                            f"named {named}, launches {got}")
        launches["tum_profiled"] = got

        # resumed from the per-frame run's checkpoint: 4 more frames
        slam = SLAMSystem(cam, SLAMConfig(), device="cuda")
        m, ts, meta = load_checkpoint(out["ck.npz"], device="cuda")
        slam.restore(m, ts, meta["trajectory"], meta["kf_log"])
        more = frames[TUM_FRAMES:TUM_FRAMES + TUM_RESUME_FRAMES]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for f in more:
            slam.track_rgbd(f.image, f.depth_image, TUM_OFFSET_S + f.timestamp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(more)
        got = path_launches()
        slam.flush_stats()
        ts_all, poses = slam.get_trajectory()
        POSE_HASHES["tum_resume"] = pose_hash(poses)
        w_t, w_gt = world.groundtruth()
        ate = ate_rmse(ts_all, poses, w_t + TUM_OFFSET_S, w_gt)
        statuses = [s.get("status") for s in slam.stats]
        print(f"tum resume [{card}]: checkpoint of {len(meta['trajectory'])} frames on "
              f"{m.p_xyz.device}, {len(more)} more frames at {ms:.2f} ms/frame, statuses "
              f"{statuses}, ATE over all {len(ts_all)} frames {ate:.5f} m, kernel launches "
              f"(fused, map, segment sum) {got}")
        if statuses != [1] * len(more) or len(ts_all) != TUM_FRAMES + len(more):
            failures.append(f"resume: statuses {statuses}, {len(ts_all)} frames")
        if not ate < ATE_BAR_M:
            failures.append(f"resume: ATE {ate} m >= {ATE_BAR_M} m")
        if got[:2] != (len(more), 0):
            failures.append(f"resume: kernel launches (fused, map, segment sum) {got}")
        launches["tum_resume"] = got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("tum phase: " + "; ".join(failures))
    return launches


def localization_phase(cam):
    """Localisation mode and relocalisation at full width (see the module
    docstring, step 13); returns the path's kernel launches."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    card = card_line()
    world = SyntheticWorld(cam=cam, n_frames=LOC_FRAMES, n_static=900, n_dynamic=0,
                           seed=5, trajectory="orbit", pixel_noise=0.0, depth_noise=0.0)
    frames = [world.frame(k, render=True) for k in range(LOC_FRAMES)]
    slam = SLAMSystem(cam, SLAMConfig(), device="cuda")
    seen, frame_ms = [], []
    torch.cuda.synchronize()
    reset_counts()
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
    POSE_HASHES["localization"] = pose_hash(poses)
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
          f"(fused, map, segment sum) {got}")
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
    if got[:2] != (LOC_FRAMES, 0):
        failures.append(f"kernel launches (fused, map, segment sum) {got}, expected ({LOC_FRAMES}, 0)")
    if failures:
        raise AssertionError("localization phase: " + "; ".join(failures))
    return got


def direct_descriptor_stage(cam, frames, world):
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
    POSE_HASHES["direct_descriptor"] = pose_hash(poses)
    print(f"direct descriptor [{card_line()}]: {DIRECT_FRAMES} frames, median "
          f"{statistics.median(frame_ms[1:]):.2f} ms/frame after the first, ATE "
          f"{ate:.5f} m, keyframes {int(slam.map.n_kfs)}, lost frames "
          f"{statuses.count(2)}, kernel launches (fused, map, segment sum) {got}, peak memory "
          f"{peak_mb:.0f} MiB; the stage took {time.perf_counter() - t_stage:.1f} s")
    check_launches("direct descriptor", got, DIRECT_FRAMES)
    if 2 in statuses:
        raise AssertionError(f"direct descriptor: tracking lost: statuses {statuses}")
    if not ate < ATE_BAR_M:
        raise AssertionError(f"direct descriptor: ATE {ate} m >= {ATE_BAR_M} m")
    return got


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (+0 and -0 apart)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.dtype]), b.contiguous().view(ints[b.dtype]))


def segment_sum_cases(cam, cfg, loop_map) -> dict:
    """{shape: (targets, idx, values)} on the card: the shapes of the port's
    edge sums (see the module docstring, step 16)."""
    from lc_crf_slam_torch.models.loopclosing import _essential_edges, _map_ba_problem
    from lc_crf_slam_torch.models.mapping import _build_problem, _select_window
    from lc_crf_slam_torch.models.mapstate import covisibility
    from lc_crf_slam_torch.ops.schur import _edge_residuals, _robust_weights

    m = type(loop_map)(*(t.to("cuda") for t in loop_map))
    rng = np.random.default_rng(8)

    def blocks(prob):
        """BA's per-edge (Hcc, g_c, Hpp, g_p, W, B) blocks, as ops/schur.py
        forms them, and the edges' cameras and points."""
        r, J_cam, J_pt, z_ok = _edge_residuals(cam, prob.cam_Tcw, prob.p_xyz, prob)
        active = prob.e_valid & z_ok & prob.p_valid[prob.e_pt]
        _, w, _ = _robust_weights(r, prob.e_w, active, cfg.local_ba.huber_delta)
        J_cam = J_cam * (~prob.cam_fixed[prob.e_cam]).to(J_cam.dtype)[:, None, None]
        wJc, wJp = w[:, None, None] * J_cam, w[:, None, None] * J_pt
        B = torch.einsum("eij,eik->ejk", wJc, J_pt)
        return (torch.einsum("eij,eik->ejk", wJc, J_cam), torch.einsum("eij,ei->ej", wJc, r),
                torch.einsum("eij,eik->ejk", wJp, J_pt), torch.einsum("eij,ei->ej", wJp, r),
                B, prob.e_cam.long(), prob.e_pt.long())

    # the whole map: C = 320 keyframes, P = 32768 points, 327680 edge slots
    prob = _map_ba_problem(cfg, m)
    C, P = m.kf_Tcw.shape[0], m.p_xyz.shape[0]
    Hcc, g_c, Hpp, _, B, e_cam, e_pt = blocks(prob)
    # solve_ba_cg's matvec halves over it, on random x (C, 6) and v (P, 3)
    x = torch.as_tensor(rng.normal(0, 1, (C, 6)), dtype=torch.float32, device="cuda")
    v = torch.as_tensor(rng.normal(0, 1, (P, 3)), dtype=torch.float32, device="cuda")
    # local BA's window of the newest keyframe at its capacity: 32 cameras
    # of 1024 slots, 4096 points
    kf = torch.full((), int(m.n_kfs) - 1, dtype=torch.int32, device="cuda")
    lprob = _build_problem(cfg, m, *_select_window(cfg, m, kf))
    lC, lP = lprob.cam_Tcw.shape[0], lprob.p_xyz.shape[0]
    lHcc, lg_c, lHpp, lg_p, lB, l_cam, l_pt = blocks(lprob)
    # the pose graphs' ends: the essential graph of a closure of the newest
    # keyframe on keyframe 0; random Jacobian blocks from a seed (all live
    # for D; the gradient and matvec weighted by the edges' validity, as
    # models/posegraph.py sums them)
    e_i, e_j, _, e_valid = _essential_edges(cfg, m, covisibility(m), kf,
                                            torch.zeros_like(kf))
    ends = torch.cat([e_i, e_j]).long()
    w_ends = torch.cat([e_valid, e_valid]).to(torch.float32)[:, None]

    def rand(shape, dtype=torch.float32):
        return torch.as_tensor(rng.normal(0, 1, shape), dtype=dtype, device="cuda")

    def jtj(d, dtype):
        J = rand((ends.shape[0], d, d), dtype)
        return torch.einsum("eik,eil->ekl", J, J)

    return {
        "Hcc": (C, e_cam, Hcc),
        "Hpp": (P, e_pt, Hpp),
        "W": (P * C, e_pt * C + e_cam, B),
        "se3_D": (C, ends, jtj(6, torch.float32)),
        "sim3_D": (C, ends, jtj(7, torch.float32)),
        "sim3_D_float64": (C, ends, jtj(7, torch.float64)),
        "empty": (C, e_cam[:0], g_c[:0]),
        "one_target": (C, torch.full_like(e_cam, 5), g_c),
        "local_Hcc": (lC, l_cam, lHcc),
        "local_g_c": (lC, l_cam, lg_c),
        "local_Hpp": (lP, l_pt, lHpp),
        "local_g_p": (lP, l_pt, lg_p),
        "local_W": (lP * lC, l_pt * lC + l_cam, lB),
        "to_points": (P, e_pt, torch.einsum("eji,ej->ei", B, x[e_cam])),
        "to_cameras": (C, e_cam, torch.einsum("eab,eb->ea", B, v[e_pt])),
        "se3_grad": (C, ends, rand((ends.shape[0], 6)) * w_ends),
        "se3_matvec": (C, ends, rand((ends.shape[0], 6)) * w_ends),
    }


def device_kernels(fn, *args, calls: int = 4, windows: int = 3) -> list:
    """The names of the device kernels one call of fn(*args) runs: a
    torch.profiler window around `calls` calls (after one outside it),
    its device events divided among them; a window that shows no device
    activity is tried again, up to `windows` times ([] if none shows any)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        names = sorted(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if names:
            return names[::calls] if len(names) % calls == 0 else names
    return []


def check_segment_kernel(cam, cfg, loop_map) -> dict:
    """`segment_sum` on the card against its plain version on CPU copies
    of the same inputs, bitwise, and times (see the module docstring, step
    16). Returns {shape: report row}."""
    from lc_crf_slam_torch.ops import segment_sum as ss

    card = card_line()
    rows = {}
    for name, (n, idx, vals) in segment_sum_cases(cam, cfg, loop_map).items():
        E = idx.shape[0]
        flat = vals.reshape(E, int(np.prod(vals.shape[1:]))).contiguous()
        plan = ss.segment_plan(idx, n)
        out = ss.segment_sum(vals, plan)
        ref = ss.segment_sum_plain(n, idx.cpu(), vals.cpu())
        torch.cuda.synchronize()
        out = out.cpu()
        err = float((out - ref).abs().max()) if out.numel() else 0.0
        if not same_bits(out, ref):
            raise AssertionError(f"segment_sum kernel != plain version on {name}: max abs "
                                 f"err {err}")
        k = flat.shape[1]
        ms, host_ms = cuda_ms(ss.segment_sum_cuda, flat, plan.kernel)
        plan_ms, _ = cuda_ms(ss.segment_plan, idx, n)
        plain_ms, plain_host_ms = cuda_ms(ss.segment_sum_plain, n, idx, flat)
        torch.use_deterministic_algorithms(True)
        try:
            det_ms, _ = cuda_ms(ss.segment_sum_plain, n, idx, flat, batches=3, reps=2)
        finally:
            torch.use_deterministic_algorithms(False)
        kernels = device_kernels(ss.segment_sum_cuda, flat, plan.kernel)
        plain_kernels = device_kernels(ss.segment_sum_plain, n, idx, flat)
        size = vals.element_size()
        n_bytes = E * idx.element_size() + E * k * size + n * k * size
        b_ms = n_bytes / PEAK_BYTES_S * 1e3
        live = int((flat != 0).any(dim=1).sum())
        rows[name] = {"n": n, "E": E, "k": k, "dtype": str(vals.dtype).split(".")[-1],
                      "live_rows": live, "max_abs_err": err, "ms": ms, "host_ms": host_ms,
                      "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
                      "bound_ms": b_ms, "bound_by": "bytes", "library_ms": plain_ms,
                      "deterministic_ms": det_ms, "plan_ms": plan_ms,
                      "device_kernels": len(kernels), "kernel_names": sorted(set(kernels)),
                      "plain_device_kernels": len(plain_kernels)}
        seen = (f"{len(kernels)} device kernel(s) a call {sorted(set(kernels))}, "
                f"index_add_ {len(plain_kernels)}" if kernels or plain_kernels else
                "the profiler shows no device activity")
        print(f"segment_sum {name} [{card}] ({E} edges, {live} with a non-zero row, "
              f"{n} targets, {k} columns, {rows[name]['dtype']}): bitwise equal; kernel "
              f"{ms:.4f} ms ({host_ms:.4f} host-bound), index_add_ {plain_ms:.4f} ms "
              f"({plain_host_ms:.4f} host-bound; float atomics), deterministic "
              f"{det_ms:.4f} ms; plan {plan_ms:.4f} ms; bound {b_ms:.5f} ms by bytes; {seen}")
    slower = [n for n, r in rows.items() if r["E"] and r["ms"] > r["plain_ms"]]
    if slower:
        print(f"segment_sum: slower than index_add_ at {slower}")
    return rows


def loop_per_frame_phase(cam, world, frames):
    """Loop closing one frame at a time (see the module docstring, step
    17): the loop world's frames, then the same world on to frame
    TWO_LOOP_FRAMES - 1 ("two loops per frame"); returns the path's kernel
    launches."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem

    card = card_line()
    t0 = time.perf_counter()
    frames = frames + [world.frame(k, render=True)
                       for k in range(len(frames), TWO_LOOP_FRAMES)]
    render_s = time.perf_counter() - t0
    gt_times = np.array([f.timestamp for f in frames])
    gt = np.stack([world.gt_pose_twc(k) for k in range(TWO_LOOP_FRAMES)])
    cfg = SLAMConfig()
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cuda")
    rows = []   # per frame: ms, host syncs, budget pending before it, slices, closed
    failures = []
    with timed_stages() as (stage_ms, before, closures):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for k, f in enumerate(frames):
            if k == LOOP_FRAMES:
                # step 17 as it was: the first LOOP_FRAMES frames' result
                at_loop_end = loop_world_result(slam, before, gt_times, gt, failures)
                verified_then = slam.n_verify_loops
            pending = slam._gba_pending is not None
            slices, loops = gba_slices(slam), len(slam.loop_log)
            verified = slam.n_verify_loops
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    slam.track_rgbd(f.image, f.depth_image, f.timestamp)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            rows.append((ms, count_syncs(caught), pending, gba_slices(slam) - slices,
                         len(slam.loop_log) > loops, slam.n_verify_loops - verified))
        got = path_launches()
        slam.flush_stats()
        ts, poses = slam.get_trajectory()       # finishes a pending global BA
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    POSE_HASHES["two_loops"] = pose_hash(poses)
    ate = ate_rmse(ts, poses, gt_times, gt)
    m = slam.map
    is_kf = [bool(s.get("need_kf")) for s in slam.stats]
    lost = sum(1 for s in slam.stats if s.get("status", 1) != 1)
    closing = [k for k, row in enumerate(rows) if row[4]]
    budget = [k for k, row in enumerate(rows) if row[2] or row[4]]
    quiet = [k for k in range(3, len(rows)) if not (is_kf[k] or rows[k][2] or rows[k][4])]
    quiet_syncs = sorted({rows[k][1] for k in quiet})
    print(f"loop per frame [{card}]: {len(frames)} frames through track_rgbd (the last "
          f"{TWO_LOOP_FRAMES - LOOP_FRAMES} rendered in {render_s:.1f} s), median "
          f"{statistics.median(r[0] for r in rows[3:]):.2f} ms/frame after the first 3, "
          f"mean {np.mean([r[0] for r in rows[1:]]):.2f} over frames 1-{len(rows) - 1}; "
          f"closing frames {closing} at {[round(rows[k][0], 1) for k in closing]} ms; "
          f"frames with a budget pending {budget} at "
          f"{[round(rows[k][0], 1) for k in budget]} ms, slices "
          f"{[rows[k][3] for k in budget]}")
    for name, ms in stage_ms.items():
        print(f"loop per frame [{card}]: {name} x{len(ms)}: ms {[round(t, 1) for t in ms]}")
    for i, (k, c) in enumerate(zip(closing, closures)):
        ate_kf = lambda Tcw: keyframe_ate(Tcw, c["time"], c["alive"], gt_times, gt)  # noqa: E731
        print(f"two loops per frame [{card}]: closure {i + 1} on frame {k} "
              f"({rows[k][0]:.1f} ms), loop_log {slam.loop_log[i]}: the "
              f"{int(c['alive'].sum())} live keyframes' ATE {ate_kf(c['Tcw']):.5f} m "
              f"just before correct_loop, {ate_kf(c['Tcw_after']):.5f} m after it")
    t_end = (TWO_LOOP_FRAMES - 1) / (LOOP_FRAMES - 1)     # the world's time at the end
    turns = world.pan_turns * (t_end - world.pan_leadin) / (1 - world.pan_leadin)
    print(f"two loops per frame [{card}]: over {TWO_LOOP_FRAMES} frames ({turns:.4f} "
          f"turns) loop_log {slam.loop_log}, verified candidates {slam.n_verify_loops} "
          f"({slam.n_verify_loops - verified_then} after frame {LOOP_FRAMES - 1}, by frame "
          f"{ {k: r[5] for k, r in enumerate(rows) if k >= LOOP_FRAMES and r[5]} }), detect_loop "
          f"calls {slam.n_detect_loops}, global-BA slices {gba_slices(slam)}, keyframes "
          f"{len(slam.kf_log)} ({int(m.n_kfs)} in the map), lost frames {lost}, ATE "
          f"{ate:.5f} m, kernel launches (fused, map, segment sum) {got}, host syncs on the "
          f"{len(quiet)} non-keyframe frames without a budget: {quiet_syncs}, on keyframe "
          f"frames {sorted({rows[k][1] for k in range(3, len(rows)) if is_kf[k]})}, peak "
          f"memory {peak_mb:.0f} MiB; at frame {LOOP_FRAMES - 1}: {at_loop_end}")
    try:
        check_launches("loop per frame phase", got, len(frames))
    except AssertionError as e:
        failures.append(str(e))
    kf_ids = {int(k) for _, k in slam.kf_log}
    kfs = [e["kf"] for e in slam.loop_log]
    if not kfs or any(k not in kf_ids for k in kfs):
        failures.append(f"loop_log {slam.loop_log}: closing keyframes not all in kf_log")
    if any(b < a + cfg.loop.min_kfs_since_last for a, b in zip(kfs, kfs[1:])):
        failures.append(f"closing keyframes {kfs} closer than min_kfs_since_last "
                        f"{cfg.loop.min_kfs_since_last}")
    if slam.n_verify_loops <= verified_then:
        failures.append(f"no loop candidate verified after frame {LOOP_FRAMES - 1}, on the "
                        f"corrected map")
    if not ate < PF_LOOP_ATE_BAR_M:
        failures.append(f"ATE {ate} m over {TWO_LOOP_FRAMES} frames >= {PF_LOOP_ATE_BAR_M} m")
    if lost:
        failures.append(f"{lost} lost frames")
    wrong = [k for k, row in enumerate(rows) if row[3] != int(row[2] or row[4])]
    if wrong or slam._gba_pending is not None:
        failures.append(f"global-BA slices {[rows[k][3] for k in wrong]} on frames {wrong}, "
                        f"pending at the end {slam._gba_pending}")
    if quiet_syncs != [1]:
        failures.append(f"host syncs {quiet_syncs} on non-keyframe frames without a budget")
    stale = stale_obs_counts(m)
    if stale:
        failures.append(f"{stale} live points whose observation count differs from "
                        f"the recount")
    if failures:
        raise AssertionError("loop per frame phase: " + "; ".join(failures))
    return got


def loop_world_result(slam, before, gt_times, gt, failures) -> str:
    """Step 17's checks on the loop world's LOOP_FRAMES frames, from the
    system just after them (`get_trajectory()` reads only, no budget being
    pending then): its pose hash, and its failures appended to `failures`.
    Returns what it measured, for the phase's line."""
    card = card_line()
    if slam._gba_pending is not None:
        failures.append(f"global-BA budget pending at frame {LOOP_FRAMES - 1}: "
                        f"{slam._gba_pending}")
        return "budget pending"
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    POSE_HASHES["loop_per_frame"] = pose_hash(poses)
    ate = ate_rmse(ts, poses, gt_times[:LOOP_FRAMES], gt[:LOOP_FRAMES])
    m = slam.map
    lost = sum(1 for s in slam.stats if s.get("status", 1) != 1)
    if not slam.loop_log or not slam.loop_log[0]["kf"] < len(slam.kf_log):
        failures.append(f"loop_log {slam.loop_log} with {len(slam.kf_log)} keyframes "
                        f"after {LOOP_FRAMES} frames")
    if not ate < PF_LOOP_ATE_BAR_M:
        failures.append(f"ATE {ate} m >= {PF_LOOP_ATE_BAR_M} m over {LOOP_FRAMES} frames")
    if lost:
        failures.append(f"{lost} lost frames in {LOOP_FRAMES}")
    if len(slam.kf_log) < PF_LOOP_MIN_KFS:
        failures.append(f"{len(slam.kf_log)} keyframes < {PF_LOOP_MIN_KFS}")
    if not before:
        failures.append(f"no closure in {LOOP_FRAMES} frames")
        return f"ATE {ate:.5f} m, no closure"
    n_same, ate_before, ate_after, steps = closure_kf_ates(before, m, gt_times, gt)
    print(f"loop per frame [{card}]: after {LOOP_FRAMES} frames loop_log {slam.loop_log}, "
          f"verified candidates {slam.n_verify_loops}, global-BA slices "
          f"{gba_slices(slam)}, keyframes {len(slam.kf_log)}, lost frames {lost}, ATE "
          f"{ate:.5f} m; the {n_same} keyframes alive at the first closure: ATE "
          f"{ate_before:.5f} m just before it, {[round(a, 5) for a in steps]} m after "
          f"correct_loop and each global-BA slice, {ate_after:.5f} m at frame "
          f"{LOOP_FRAMES - 1}; {int(m.p_alive.sum())} live points")
    # the closure itself (correct_loop) must not make the keyframes worse;
    # its global BA must hold them as the reference's global BA does on
    # the same map, after each slice and at the loop world's end
    if not steps[0] <= LOOP_KF_ATE_FACTOR * ate_before:
        failures.append(f"keyframe ATE {steps[0]} m after correct_loop > "
                        f"{LOOP_KF_ATE_FACTOR} x {ate_before} m before")
    failures += check_global_ba_against_reference(card, before, ate_after, gt_times, gt)
    return f"ATE {ate:.5f} m, keyframe ATE {ate_after:.5f} m"


def check_global_ba_against_reference(card, before, ate_end, gt_times, gt) -> list:
    """The per-frame loop phase's global BA against the reference's on
    the same map (BA_MAP_FILE): the map the first slice was handed must be
    the file's (to BA_MAP_TOL; else this run's is written to BA_MAP_OUT),
    and the file's keyframes' ATE after each slice, and the closure's
    keyframes' at the end, at most LOOP_KF_ATE_FACTOR x the reference's
    after the same slice and after its last. Returns the failures."""
    ref = np.load(BA_MAP_FILE)
    got = before.get("ba_map")
    if got is None:
        return ["no global-BA slice after the first closure"]
    diff = ba_map_diff(got, ref)
    if not diff <= BA_MAP_TOL:
        os.makedirs(os.path.dirname(BA_MAP_OUT), exist_ok=True)
        np.savez_compressed(BA_MAP_OUT, **got, ate_kfs=before["alive"])
        return [f"the map handed to the first global-BA slice differs from "
                f"{os.path.relpath(BA_MAP_FILE, HERE)} by {diff}; this run's is in "
                f"{os.path.relpath(BA_MAP_OUT, HERE)}"]
    which, ref_ates = ref["ate_kfs"], [float(a) for a in ref["ref_kf_ate"]]
    ates = [keyframe_ate(Tcw, before["time"], which, gt_times, gt)
            for stage, Tcw in before["after"] if stage == "global_ba"]
    print(f"loop per frame [{card}]: the map before global BA is the committed one "
          f"(max diff {diff:.3e}); the {int(which.sum())} keyframes' ATE after each "
          f"global-BA slice {[round(a, 5) for a in ates]} m, the reference's on that "
          f"map {[round(a, 5) for a in ref_ates]} m")
    if len(ates) != len(ref_ates) or not all(
            a <= LOOP_KF_ATE_FACTOR * r for a, r in zip(ates, ref_ates)) \
            or not ate_end <= LOOP_KF_ATE_FACTOR * ref_ates[-1]:
        return [f"keyframe ATE after the global-BA slices {ates} and at the end "
                f"{ate_end} m against {LOOP_KF_ATE_FACTOR} x the reference's "
                f"{ref_ates} m on the same map"]
    return []


def mover_revisit_phase():
    """The revisit with a mover in the start sector (see the module
    docstring, step 18); returns the path's kernel launches."""
    from lc_crf_slam_torch.config import LoopConfig, SLAMConfig
    from lc_crf_slam_torch.models.mapstate import covisibility
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    card = card_line()
    cam = qvga()
    t0 = time.perf_counter()
    world = SyntheticWorld(cam=cam, n_frames=MOVER_FRAMES, n_static=1600, n_dynamic=0,
                           seed=3, trajectory="sweep", billboard=True, bb_speed=0.012,
                           bb_center0=(-0.5, 0.0, 2.4), bb_size=(0.9, 1.2))
    frames = [world.frame(k, render=True) for k in range(MOVER_FRAMES)]
    render_s = time.perf_counter() - t0
    cfg = SLAMConfig(loop=LoopConfig(min_total_matches=25))
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, fuse_reverse_neighbors=0, interrupt_fuse_reverse_neighbors=0))
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cuda")
    frame_ms, syncs, got, peak_mb = drive(slam, frames, range(3, MOVER_FRAMES))
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    POSE_HASHES["mover_revisit"] = pose_hash(poses)
    gt_t, gt = world.groundtruth()
    ate = ate_rmse(ts, poses, gt_t, gt)
    lost = sum(1 for s in slam.stats if s.get("status", 1) != 1)
    m = slam.map
    alive = m.p_alive.cpu().numpy()
    gtd = world.bb_gt_dynamic(m.p_xyz.cpu().numpy(), n=MOVER_FRAMES) & alive
    judged = gtd & (m.p_visible.cpu().numpy() >= 4)
    n_kfs = int(m.n_kfs)
    W = covisibility(m).cpu().numpy()[:n_kfs, :n_kfs]
    early_late = float(W[:4, n_kfs - 4:].max()) if n_kfs >= 8 else 0.0
    is_kf = [bool(s.get("need_kf")) for s in slam.stats]
    print(f"mover revisit [{card}]: {MOVER_FRAMES} QVGA frames (rendered in "
          f"{render_s:.1f} s) through track_rgbd, median "
          f"{statistics.median(frame_ms[3:]):.2f} ms/frame after the first 3; loop_log "
          f"{slam.loop_log}, verified candidates {slam.n_verify_loops}, global-BA slices "
          f"{gba_slices(slam)}, keyframes {len(slam.kf_log)} ({n_kfs} in the map), "
          f"early-late covisibility {early_late:.0f}, lost frames {lost}, ATE {ate:.5f} m; "
          f"live points {int(alive.sum())}, mover points {int(gtd.sum())} (judged "
          f"{int(judged.sum())}); kernel launches (fused, map, segment sum) {got}; host "
          f"syncs on non-keyframe frames "
          f"{sorted({syncs[k] for k in syncs if not is_kf[k]})}, on keyframe frames "
          f"{sorted({syncs[k] for k in syncs if is_kf[k]})}; peak memory {peak_mb:.0f} MiB")
    failures = []
    try:
        check_launches("mover revisit phase", got, MOVER_FRAMES)
    except AssertionError as e:
        failures.append(str(e))
    if not slam.loop_log and not (n_kfs >= 10 and early_late >= MOVER_RECONNECT):
        failures.append(f"the revisit neither closed a loop nor reconnected "
                        f"(early-late covisibility {early_late})")
    if not ate < PF_LOOP_ATE_BAR_M:
        failures.append(f"ATE {ate} m >= {PF_LOOP_ATE_BAR_M} m")
    if lost > MOVER_MAX_LOST:
        failures.append(f"{lost} lost frames > {MOVER_MAX_LOST}")
    n_alive = max(int(alive.sum()), 1)
    if judged.sum() > MOVER_JUDGED_SHARE * n_alive or gtd.sum() > MOVER_ALL_SHARE * n_alive:
        failures.append(f"mover points {int(gtd.sum())} (judged {int(judged.sum())}) of "
                        f"{n_alive} live")
    if alive.sum() < MOVER_MIN_LIVE:
        failures.append(f"{int(alive.sum())} live points < {MOVER_MIN_LIVE}")
    if failures:
        raise AssertionError("mover revisit phase: " + "; ".join(failures))
    return got


@contextlib.contextmanager
def counted_recycling():
    """Within the block, every `add_points` of the pipeline (tracking's,
    the system's, mapping's) adds to device counters, read at the end (no
    host read per call): {"reused": slots below the high-water mark handed
    out again, "condemned": keyframe references those reuses turned to -2,
    "left": references to a reused slot still in the table after the call
    (a keyframe entry that would alias the new point)}. On a card the
    counting of mapping's calls is captured into the mapping step's CUDA
    graphs, and every replay adds: the block starts with no captured step
    and puts back the ones from before it on exit, so no graph that counts
    outlives it."""
    from lc_crf_slam_torch.models import mapping, mapstate, system, tracking

    counts = {k: torch.zeros((), dtype=torch.int64, device="cuda")
              for k in ("reused", "condemned", "left")}
    original = mapstate.add_points

    def counted(m, *args, **kwargs):
        out, ids = original(m, *args, **kwargs)
        P = m.capacity_points
        reused = (ids >= 0) & (ids < m.n_points)
        hit = torch.zeros(P + 1, dtype=torch.bool, device=ids.device)
        hit.index_fill_(0, torch.where(reused, ids, P).long(), True)   # no host tensor: capturable
        counts["reused"] += torch.sum(reused)
        counts["condemned"] += torch.sum((m.kf_obs >= 0) & (out.kf_obs == -2))
        counts["left"] += torch.sum(
            (out.kf_obs >= 0) & hit[:P][torch.clamp(out.kf_obs, min=0).long()])
        return out, ids

    modules = (mapping, system, tracking)
    graphs, mapping._GRAPHS = mapping._GRAPHS, {}
    for mod in modules:
        mod.add_points = counted
    try:
        yield counts
    finally:
        for mod in modules:
            mod.add_points = original
        mapping._GRAPHS = graphs


def dead_slot_refs(m) -> int:
    """Live keyframes' valid observations naming a point slot that is not
    alive: references to culled points, which the pipeline keeps (for
    covisibility and to keep the feature from being triangulated again)
    until `add_points` hands the slot out again, as the reference does."""
    alive = m.kf_alive[:, None] & m.kf_valid & (m.kf_obs >= 0)
    dead = ~m.p_alive[torch.clamp(m.kf_obs, min=0).long()]
    return int((alive & dead).sum())


def capacity_run(cam, frames, cfg):
    """The frames through `track_rgbd` with cfg: (system, ms per frame,
    launches, the frame that filled the keyframe table (None without a
    fill), peak MiB up to that frame and after it, peak MiB of the run,
    the first frame whose high-water mark reached `cfg.map.max_points`
    (None if none did))."""
    from lc_crf_slam_torch.models.system import SLAMSystem

    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    frame_ms, peaks, filled, marked = [], [0.0, 0.0], None, None
    for k, f in enumerate(frames):
        t0 = time.perf_counter()
        slam.track_rgbd(f.image, f.depth_image, f.timestamp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if filled is None and slam._capacity_warned:
            filled = k
        after = filled is not None and k > filled
        peaks[after] = max(peaks[after], torch.cuda.max_memory_allocated() / 2**20)
        torch.cuda.reset_peak_memory_stats()
        if marked is None and int(slam.map.n_points) >= cfg.map.max_points:
            marked = k
    return slam, frame_ms, path_launches(), filled, peaks, max(peaks), marked


def capacity_phase():
    """Full keyframe and point tables, per frame (see the module
    docstring, step 20); returns the path's kernel launches."""
    from lc_crf_slam_torch.config import MapConfig, SLAMConfig
    from lc_crf_slam_torch.geometry.camera import TUM3
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    card = card_line()
    world = SyntheticWorld(cam=TUM3, n_frames=N_FRAMES, n_static=600, n_dynamic=0, seed=0)
    frames = [world.frame(k, render=True) for k in range(CAPACITY_FRAMES)]
    gt_times = np.array([f.timestamp for f in frames])
    gt = np.stack([world.gt_pose_twc(k) for k in range(CAPACITY_FRAMES)])
    cfg = SLAMConfig(map=MapConfig(max_points=CAPACITY_POINTS, max_keyframes=CAPACITY_KFS))
    with counted_recycling() as recycling:
        slam, frame_ms, got, filled, peaks, _, marked = capacity_run(TUM3, frames, cfg)
    reused, condemned, left = (int(recycling[k]) for k in ("reused", "condemned",
                                                           "left"))
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    POSE_HASHES["capacity"] = pose_hash(poses)
    ate = ate_rmse(ts, poses, gt_times, gt)
    lost = sum(1 for s in slam.stats if s.get("status", 1) != 1)
    events = [(i, e["event"]) for i, e in enumerate(slam.stats) if "event" in e]
    full_at = [i for i, e in events if e == "capacity_full"]
    frame_recs = [s for s in slam.stats if "event" not in s or s["event"] == "init"]
    dropped = sum(1 for s in frame_recs[filled + 1:] if s.get("need_kf")) \
        if filled is not None else 0
    m = slam.map
    stale, dead_refs = stale_obs_counts(m), dead_slot_refs(m)
    # the same frames at the default capacity (320 keyframes), up to the
    # fill: its peak memory beside the full table's
    upto = CAPACITY_FRAMES if filled is None else filled + 1
    default, default_ms, _, _, _, default_peak, _ = capacity_run(TUM3, frames[:upto],
                                                                 SLAMConfig())
    print(f"capacity [{card}]: {CAPACITY_FRAMES} frames of the tracking world's orbit "
          f"through track_rgbd with {CAPACITY_KFS} keyframe slots and {CAPACITY_POINTS} "
          f"point slots, median {statistics.median(frame_ms[3:]):.2f} ms/frame after the "
          f"first 3; events {events}, the keyframe table filled on frame {filled}, "
          f"{dropped} keyframe decisions after it (inserts dropped, mapping on keyframe "
          f"{CAPACITY_KFS - 1}), keyframes {len(slam.kf_log)} ({int(m.n_kfs)} in the map), "
          f"lost frames {lost}, ATE {ate:.5f} m, kernel launches (fused, map, segment sum) "
          f"{got}; point table: the high-water mark reached {CAPACITY_POINTS} on frame "
          f"{marked}, {reused} slots reused, {condemned} keyframe references condemned, "
          f"{left} references to a reused slot left behind, tomb_n {int(m.tomb_n)}, "
          f"{int(m.p_alive.sum())} live points, {stale} live points whose observation "
          f"count differs from the recount, {dead_refs} live references to a culled slot "
          f"not yet reused; peak memory {peaks[0]:.0f} MiB up to the fill, "
          f"{peaks[1]:.0f} MiB after it; frames 0-{upto - 1} at the default capacity "
          f"({SLAMConfig().map.max_points} points, {SLAMConfig().map.max_keyframes} "
          f"keyframes): peak {default_peak:.0f} MiB, median "
          f"{statistics.median(default_ms[3:]):.2f} ms/frame, {len(default.kf_log)} "
          f"keyframes")
    failures = []
    try:
        check_launches("capacity phase", got, CAPACITY_FRAMES)
    except AssertionError as e:
        failures.append(str(e))
    if len(full_at) != 1 or len(events) != 1 + len(full_at):
        failures.append(f"events {events}: expected one capacity_full")
    if int(m.n_kfs) != CAPACITY_KFS:
        failures.append(f"{int(m.n_kfs)} keyframes in the map, expected "
                        f"{CAPACITY_KFS}")
    if lost:
        failures.append(f"{lost} lost frames")
    if not ate < DYN_ATE_BAR_M:
        failures.append(f"ATE {ate} m >= {DYN_ATE_BAR_M} m")
    if got[2] < 1:
        failures.append("no segment-sum launch")
    if marked is None or reused < 1 or condemned < 1:
        failures.append(f"the point table did not recycle: high-water mark at "
                        f"{CAPACITY_POINTS} on frame {marked}, {reused} slots reused, "
                        f"{condemned} references condemned")
    if stale or left:
        failures.append(f"{stale} live points whose observation count differs from the "
                        f"recount, {left} references to a reused slot left behind")
    if failures:
        raise AssertionError("capacity phase: " + "; ".join(failures))
    return got


def chunk_reloc_phase():
    """Relocalisation at a chunk boundary (see the module docstring, step
    19); returns the path's kernel launches."""
    from lc_crf_slam_torch.config import SLAMConfig, TrackingConfig
    from lc_crf_slam_torch.models import system
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    card = card_line()
    cam = qvga()
    world = SyntheticWorld(cam=cam, n_frames=96, n_static=1600, n_dynamic=0, seed=5,
                           trajectory="sweep", pixel_noise=0.0, depth_noise=0.0)
    rendered = {k: world.frame(k, render=True) for k in set(RELOC_FRAMES) if k >= 0}
    black = np.zeros_like(rendered[0].image, dtype=np.float32)
    grays = np.stack([rendered[k].image if k >= 0 else black
                      for k in RELOC_FRAMES]).astype(np.float32)
    depths = np.stack([rendered[k].depth_image if k >= 0 else black
                       for k in RELOC_FRAMES]).astype(np.float32)
    stamps = np.arange(len(RELOC_FRAMES)) / 30.0
    cfg = SLAMConfig(tracking=TrackingConfig(max_frames_between_kf=4))
    slam = system.SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True,
                             device="cuda")
    # each tracked frame's status, as it runs
    statuses = []
    track_step = system.track_step

    def tracked(*args):
        out = track_step(*args)
        statuses.append(out[0].status)
        return out

    system.track_step = tracked
    try:
        chunks = count_chunks(slam)
        torch.cuda.synchronize()
        reset_counts()
        slam.track_sequence(grays, depths, stamps, chunk=RELOC_CHUNK)
        torch.cuda.synchronize()
        got = path_launches()
    finally:
        system.track_step = track_step
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    POSE_HASHES["chunk_reloc"] = pose_hash(poses)
    status = torch.stack(statuses).cpu().numpy()
    lost_at = [int(k) + 1 for k in np.flatnonzero(status == 2)]    # frame 0 initialises
    ends = np.cumsum([c[0] for c in chunks])                   # last frame of each chunk
    boundary = int(ends[np.searchsorted(ends, RELOC_BLACK_AT + 1)])
    events = [(s["event"], round(s["t"] * 30.0), s.get("lost_frames", s.get("inliers")))
              for s in slam.stats if s.get("event", "").startswith("chunk_")]
    T_true = np.linalg.inv(world.gt_pose_twc(RELOC_REVISIT))
    err = float(np.linalg.norm(slam.ts.Tcw.cpu().numpy()[:3, 3] - T_true[:3, 3]))
    n_chunks = len(chunks)
    ms_frame = sum(c[2] for c in chunks) / (len(RELOC_FRAMES) - 1)
    per_chunk_attempts = [c[3][1] for c in chunks]
    print(f"chunk reloc [{card}]: {len(RELOC_FRAMES)} QVGA frames (sweep 0-35, black "
          f"36-37, frames 0-7 again) in 1 + {n_chunks} chunks of {RELOC_CHUNK}: "
          f"{ms_frame:.2f} ms/frame (chunks {[round(c[2], 1) for c in chunks]} ms); events "
          f"{events}; lost frames {lost_at}, the next chunk boundary after the black "
          f"frames {boundary}; relocalisation attempts per chunk {per_chunk_attempts}; "
          f"host syncs per chunk {[c[1] for c in chunks]}; final status "
          f"{int(slam.ts.status)}, camera {err:.4f} m from frame {RELOC_REVISIT}'s ground "
          f"truth; keyframes {int(slam.map.n_kfs)}; kernel launches (fused, map, segment "
          f"sum) {got}")
    failures = []
    try:
        # a relocalisation attempt at a chunk boundary builds its frame
        check_launches("chunk reloc phase", got, 1 + n_chunks + sum(per_chunk_attempts))
    except AssertionError as e:
        failures.append(str(e))
    kinds = [e[0] for e in events]
    if "chunk_lost" not in kinds or "chunk_reloc" not in kinds:
        failures.append(f"events {events}")
    if not lost_at or min(lost_at) < RELOC_BLACK_AT or max(lost_at) > boundary:
        failures.append(f"lost frames {lost_at}, expected within {RELOC_BLACK_AT}-{boundary}")
    if int(slam.ts.status) != 1:
        failures.append(f"final status {int(slam.ts.status)}")
    for (n, syncs, *_), tries in zip(chunks, per_chunk_attempts):
        if syncs > n + 1 + RELOC_SYNCS * tries:
            failures.append(f"{syncs} host syncs in a chunk of {n} frames with {tries} "
                            f"relocalisation attempts")
    if not err < RELOC_POS_BAR_M:
        failures.append(f"final camera {err} m from the revisited frame's ground truth")
    if failures:
        raise AssertionError("chunk reloc phase: " + "; ".join(failures))
    return got


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_phase(cam, frames, world, seq_ms, seq_poses, seq_kf_log, loop_map,
                      loop_frame_idx):
    """The multi-device layer on the card (see the module docstring, step
    15); returns the path's kernel launches."""
    import torch.distributed as dist

    from lc_crf_slam_torch._ops import stable_topk
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.models import crf
    from lc_crf_slam_torch.models.capacities import CRF_TRACKS, RECENCY_WINDOW
    from lc_crf_slam_torch.models.loopclosing import _map_ba_problem
    from lc_crf_slam_torch.models.system import SLAMSystem
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
    # mesh=None, with the default algorithms: the edge sums run in a fixed
    # order (ops/segment_sum.py), so the two runs and the sequence phase
    # must agree bit for bit
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
        reset_counts()
        poses_tcw = slam.track_sequence(grays, depths, [f.timestamp for f in frames],
                                        chunk=SEQ_CHUNK)
        torch.cuda.synchronize()
        got = path_launches()
        slam.flush_stats()
        runs[name] = (poses_tcw, slam.kf_log, chunks, got)
        del slam
    poses_tcw, kf_log, chunks, got = runs["mesh"]
    for name, (p, *_) in runs.items():
        POSE_HASHES[f"distributed {name}"] = pose_hash(p)
    POSE_HASHES["sequence (chunked poses)"] = pose_hash(seq_poses)

    def centre(T):
        """Camera centres of poses Tcw (N, 4, 4)."""
        return np.einsum("nji,nj->ni", T[:, :3, :3], -T[:, :3, 3])

    dpos = float(np.abs(centre(poses_tcw) - centre(runs["mesh=None"][0])).max())
    spread = float(np.abs(centre(poses_tcw) - centre(seq_poses)).max())
    same = {"mesh vs mesh=None": np.array_equal(poses_tcw, runs["mesh=None"][0]),
            "mesh vs sequence phase": np.array_equal(poses_tcw, seq_poses),
            "mesh=None vs sequence phase": np.array_equal(runs["mesh=None"][0], seq_poses)}
    n_fused = 1 + sum(min(fmesh.size, c[0]) for c in chunks)
    ms = {k: sum(c[2] for c in v[2]) / n_seq for k, v in runs.items()}
    print(f"distributed [{card}]: frames mesh {[str(d) for d in fmesh.devices]}, "
          f"default algorithms: {n_seq} chunked frames, {ms['mesh']:.2f} ms/frame "
          f"(chunks {[round(c[2], 1) for c in chunks]} ms), mesh=None {ms['mesh=None']:.2f} "
          f"(the sequence phase: {seq_ms:.2f}); keyframes in chunks {len(kf_log)}, "
          f"mesh=None {len(runs['mesh=None'][1])}, the sequence phase {len(seq_kf_log)} "
          f"(equal: {kf_log == runs['mesh=None'][1] == seq_kf_log}); poses bitwise equal "
          f"{same}; camera centres vs mesh=None max {dpos:.3e} m, vs the sequence phase "
          f"{spread:.3e} m; kernel launches (fused, map, segment sum) {got}; host syncs "
          f"per chunk {[c[1] for c in chunks]} for {[c[0] for c in chunks]} frames")
    try:
        check_launches("distributed phase", got, n_fused)
    except AssertionError as e:
        failures.append(str(e))
    if not kf_log == runs["mesh=None"][1] == seq_kf_log:
        failures.append(f"keyframes {kf_log}, mesh=None's {runs['mesh=None'][1]}, the "
                        f"sequence phase's {seq_kf_log}")
    if not all(same.values()):
        failures.append(f"poses not bitwise equal: {same}")
    for n, syncs, *_ in chunks:
        if syncs > n + 1:
            failures.append(f"{syncs} host syncs in a chunk of {n} frames")

    # (c) the loop phase's final map: the whole-map BA three ways, timed
    # and compared with the default algorithms (one rank sums the same
    # edges in the same order as one device: bitwise)
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
    kf_live, p_live = m.kf_alive.cpu().numpy(), m.p_alive.cpu().numpy()
    P = p_live.shape[0]
    (ref, ms_s) = timed["solve_ba"]
    for name in ("dist_solve_ba", "dist_solve_ba_blocks"):
        out, ms_d = timed[name]
        bitwise = torch.equal(out[0], ref[0]) and torch.equal(out[1][:P], ref[1])
        dc = float(np.abs((out[0] - ref[0])[:, :3, 3].cpu().numpy()[kf_live]).max())
        dp = float(np.abs((out[1][:P] - ref[1]).cpu().numpy()[p_live]).max())
        print(f"distributed [{card}]: {name} on the loop map (C={m.kf_Tcw.shape[0]}, "
              f"P={P}, {int(out[2].n_edges)} edges, {int(kf_live.sum())} live keyframes, "
              f"{int(p_live.sum())} live points), {DIST_BA_ITERS} iterations: "
              f"{ms_d:.1f} ms (solve_ba {ms_s:.1f} ms); cost {float(out[2].cost):.6g} "
              f"(solve_ba {float(ref[2].cost):.6g}); bitwise equal to solve_ba {bitwise} "
              f"(max diff: cameras {dc:.3e} m, live points {dp:.3e})")
        if not bitwise:
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
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    if sys.argv[1:] == ["--segment-sum"]:
        # step 16 alone, on the map of tests/data/loop_per_frame_ba_map.npz
        rows = check_segment_kernel(TUM3, SLAMConfig(), load_ba_map(SLAMConfig())[0])
        os.makedirs(os.path.dirname(BA_MAP_OUT), exist_ok=True)
        with open(os.path.join(os.path.dirname(BA_MAP_OUT), "segment_sum.json"), "w") as f:
            json.dump({"card": card_line(), "shapes": rows}, f, indent=1)
        return 0
    if sys.argv[1:2] == ["--phases"]:
        # the self-contained phases named (comma-separated), alone
        solo = {"loop_per_frame": lambda: loop_per_frame_phase(TUM3, *loop_world(TUM3)),
                "capacity": capacity_phase,
                "mover": mover_revisit_phase, "chunk_reloc": chunk_reloc_phase}
        for name in sys.argv[2].split(","):
            got = phase(name, solo[name])
            print(f"{name}: kernel launches (fused, map, segment sum) {got}")
        print(f"pose hashes: {json.dumps(POSE_HASHES)}")
        print(f"seconds per phase: {json.dumps(PHASE_S)}")
        return 0

    # ---- worlds ------------------------------------------------------------
    cam = TUM3
    cfg = SLAMConfig()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    world = SyntheticWorld(cam=cam, n_frames=N_FRAMES, n_static=600,
                           n_dynamic=0, seed=0)
    # the tracking phase's frames, and the TUM phase's resumed ones
    frames = [world.frame(k, render=True)
              for k in range(max(TRACK_FRAMES, TUM_FRAMES + TUM_RESUME_FRAMES))]
    dyn_world = SyntheticWorld(cam=cam, n_frames=60, n_static=1400, n_dynamic=0,
                               seed=7, trajectory="line", billboard=True,
                               bb_speed=0.04)
    dyn_frames = [dyn_world.frame(k, render=True) for k in range(DYN_FRAMES)]
    dyn_rights = [dyn_world.right_eye(k) for k in range(DYN_FRAMES)]
    print(f"rendered {len(frames)} + {DYN_FRAMES} frames and {DYN_FRAMES} right eyes "
          f"{cam.width}x{cam.height} in {time.perf_counter() - t0:.1f} s")

    # ---- kernels vs plain --------------------------------------------------
    levels = build_pyramid(torch.as_tensor(frames[0].image, device=dev),
                           cfg.orb.n_levels, cfg.orb.scale_factor)
    rng = np.random.default_rng(0)
    images = [(f"level{l}", img) for l, img in enumerate(levels)]
    for shape in ((200, 300), (256, 256)):
        images.append((f"random{shape[0]}x{shape[1]}", torch.as_tensor(
            (rng.random(shape) * 255).astype(np.float32), device=dev)))
    chunk_grays = torch.as_tensor(
        np.stack([f.image for f in dyn_frames[1:1 + SEQ_CHUNK]]).astype(np.float32),
        device=dev)
    # the map kernel's batches: the tracking frame whose levels are checked
    # above, then the chunk's first 14 frames
    nms_rows = check_fast_kernel(images, torch.cat([levels[0][None],
                                                    chunk_grays[:SEQ_CHUNK - 1]]), cfg)
    cells_b1 = check_cell_kernel("one frame", chunk_grays[:1], cfg)
    cells_b8 = check_cell_kernel("a chunk of 8", chunk_grays[:TUM_CHUNK], cfg)
    cells_b15 = check_cell_kernel("one chunk", chunk_grays, cfg)
    stereo_grays = torch.cat([chunk_grays, torch.as_tensor(
        np.stack(dyn_rights[1:1 + SEQ_CHUNK]).astype(np.float32), device=dev)])
    cells_b2 = check_cell_kernel("a stereo pair", stereo_grays[::SEQ_CHUNK], cfg)
    cells_b30 = check_cell_kernel("one stereo chunk", stereo_grays, cfg)

    # ---- the phases at full width -------------------------------------------
    # path -> its (fused, map, segment-sum) launches
    by_path = {"tracking": phase("tracking", tracking_phase, cam, frames[:TRACK_FRAMES],
                                 world)}
    by_path["dynamic"], dyn_ms, dyn_poses, dyn_kf_log = phase(
        "dynamic", dynamic_phase, cam, dyn_frames, dyn_world)
    by_path["dynamic_repeat"], _, dyn_poses_2, dyn_kf_log_2 = phase(
        "dynamic repeat", dynamic_phase, cam, dyn_frames, dyn_world, "dynamic repeat")
    dyn_same = np.array_equal(dyn_poses, dyn_poses_2)
    print(f"repeatability [{card_line()}]: two runs of the dynamic phase: trajectories "
          f"bitwise equal {dyn_same}, keyframes {len(dyn_kf_log)} and "
          f"{len(dyn_kf_log_2)} (equal logs: {dyn_kf_log == dyn_kf_log_2})")
    if not (dyn_same and dyn_kf_log == dyn_kf_log_2):
        raise AssertionError("the dynamic phase did not repeat bit for bit")
    by_path["sequence"], seq_ms, seq_poses, seq_kf_log = phase(
        "sequence", sequence_phase, cam, dyn_frames, dyn_world, dyn_ms)
    loop_w, loop_frames = phase("loop world", loop_world, cam)
    by_path["loop"], loop_map, loop_frame_idx = phase("loop", loop_phase, cam, loop_w,
                                                      loop_frames)
    seg_rows = phase("segment sum check", check_segment_kernel, cam, cfg, loop_map)
    by_path["loop_per_frame"] = phase("loop per frame", loop_per_frame_phase, cam, loop_w,
                                      loop_frames)
    del loop_frames
    by_path["mover_revisit"] = phase("mover revisit", mover_revisit_phase)
    by_path["chunk_reloc"] = phase("chunk reloc", chunk_reloc_phase)
    by_path["capacity"] = phase("capacity", capacity_phase)
    by_path["stereo"] = phase("stereo", stereo_phase, cam)
    by_path["stereo_sequence"] = phase("stereo sequence", stereo_sequence_phase, cam,
                                       dyn_frames, dyn_rights, dyn_world, seq_ms)
    by_path["mono"], mono = phase("mono", mono_phase, cam)
    by_path["sim3_closure"] = phase("sim3 closure", sim3_closure_stage, mono)
    by_path.update(phase("tum", tum_phase, cam, world, frames))
    by_path["localization"] = phase("localization", localization_phase, cam)
    by_path["direct_descriptor"] = phase("direct descriptor", direct_descriptor_stage,
                                         cam, frames, world)
    by_path["distributed"] = phase("distributed", distributed_phase, cam, dyn_frames,
                                   dyn_world, seq_ms, seq_poses, seq_kf_log, loop_map,
                                   loop_frame_idx)
    print(f"pose hashes: {json.dumps(POSE_HASHES)}")
    print(f"seconds per phase: {json.dumps(PHASE_S)}")
    # every path but the handed-in Sim(3) closure goes through the fused
    # kernel; the segment sum on every path that runs local BA or a pose
    # graph (the profiled CLI run's 3 frames and the 4 resumed ones make
    # no keyframe that maps, so they may count 0)
    no_fused = [p for p, got in by_path.items() if got[0] < 1 and p != "sim3_closure"]
    may_skip = NO_SEGMENT_SUM + ("tum_profiled", "tum_resume")
    no_sum = [p for p, got in by_path.items() if got[2] < 1 and p not in may_skip]
    sum_off = [p for p in NO_SEGMENT_SUM if by_path[p][2] != 0]
    if no_fused or no_sum or sum_off:
        raise AssertionError(f"paths that never launched the fused kernel {no_fused}, "
                             f"never the segment sum {no_sum}, launched it without "
                             f"local BA or a pose graph {sum_off}: {by_path}")

    # ---- report ------------------------------------------------------------
    report = {"kernels": [{
        "name": "fast_cell_best",
        "route": "cuda",
        "source": "lc_crf_slam_torch/csrc/fast_cells.cu",
        "replaces": "lc_crf_slam_tpu/ops/pallas_fast.py:143",
        # the paths' own launches, each counted from 0 (no launch of
        # the kernel checks above is among them)
        "launches": sum(got[0] for got in by_path.values()),
        "launches_by_path": {p: got[0] for p, got in by_path.items()},
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
        "launches": sum(got[1] for got in by_path.values()),
        "max_abs_err": max(r["max_abs_err"] for r in nms_rows.values()),
        # one frame's 8 levels in one launch
        **{k: nms_rows["B=1"][k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                            "bound_by")},
        "library_ms": None,     # no single PyTorch call computes it
        # level 0 alone (one 640x480 level, a one-level table), a stereo
        # pair and a chunk of 15 in one launch
        "level0": nms_rows["level0"],
        "pair": nms_rows["B=2"],
        "chunk_of_15": nms_rows["B=15"],
    }, {
        "name": "segment_sum",
        "route": "cuda",
        "source": "lc_crf_slam_torch/csrc/segment_sum.cu",
        # the port's own edge sums: no Pallas kernel did them (XLA's
        # scatter-add in the reference)
        "replaces": None,
        "launches": sum(got[2] for got in by_path.values()),
        "launches_by_path": {p: got[2] for p, got in by_path.items()},
        "max_abs_err": max(r["max_abs_err"] for r in seg_rows.values()),
        # the headline shape: the point blocks Hpp of the loop map's BA
        # (32768 targets, the invalid edges' run of ~315k on point 0);
        # plain_ms and library_ms are the same call, `index_add_` with
        # float atomics, the plain version on the card
        **{k: seg_rows["Hpp"][k] for k in ("ms", "host_ms", "plain_ms", "plain_host_ms",
                                           "bound_ms", "bound_by", "library_ms",
                                           "deterministic_ms", "plan_ms",
                                           "device_kernels")},
        "shapes": seg_rows,
    }]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in the script")
    print(card_line())
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
