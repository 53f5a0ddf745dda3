"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch build.
2. Builds the FAST+NMS CUDA kernel from lc_crf_slam_torch/csrc/ (nvcc).
3. Holds the kernel bit for bit against its plain PyTorch version on the
   8 pyramid levels of a rendered TUM3 frame and on two random images
   (200x300, not a multiple of the tile; 256x256), and times both with
   CUDA events (median of 20 batches of 10 calls).
4. Tracking phase: SLAMSystem.track_rgbd with mapping and the CRF off on
   31 rendered 640x480 frames of a 600-point static world, default map
   capacities (32768 points, 320 keyframes, 1024 features). Checks that
   every frame's FAST went through the kernel, that tracking never got
   lost, that keyframes were made, and that the ATE against ground truth
   (Umeyama-aligned) is under 1 cm.
5. Dynamic phase: the per-frame dynamic pipeline (mapping and the CRF
   on, loop closing off) on bench.py's billboard world (a rigid textured
   mover crossing a 1400-point static scene), frames 0-30 at 640x480,
   default capacities. Checks FAST launches = 8 x 31, no frame lost,
   >= 2 keyframes, one counted mapping_step per keyframe and one counted
   crf_step per frame after the first, finite poses, ATE < 2 cm, and
   1 host sync on a non-keyframe frame (torch's sync debug mode). Prints
   the reference's ATE on the same frames beside the port's, ms/frame
   (median after the first 3, keyframe and non-keyframe frames apart),
   host syncs, peak device memory, and the last frame's CRF counts.
6. Prints the kernel report as one JSON line, the card line again, and
   last `{"ok": true, "device": {...}}`.

Any failure raises, and the exit code is then non-zero. Without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 31
ATE_BAR_M = 0.01
DYN_FRAMES = 31
DYN_ATE_BAR_M = 0.02      # the reference's bar for its full pipeline
# The JAX reference on the same 31 frames, measured on the CPU with
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dynamic_slice.py \
#       -m slow -k full_size -s
# (this script imports no jax, so the number is a constant here)
REF_DYN_ATE_M = 0.00169054956667069


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
    for _ in range(3):
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


def check_fast_kernel(images):
    """Kernel vs plain version on each image: bitwise equality, times."""
    from lc_crf_slam_torch.ops.fast import fast_score_dual
    from lc_crf_slam_torch.ops.fast_kernel import fast_score_dual_cuda

    rows = []
    for name, img in images:
        hi, lo = fast_score_dual_cuda(img, 20.0, 7.0)
        ph, pl = fast_score_dual(img, 20.0, 7.0)
        torch.cuda.synchronize()
        err = max(float((hi - ph).abs().max()), float((lo - pl).abs().max()))
        if not (torch.equal(hi, ph) and torch.equal(lo, pl)):
            raise AssertionError(f"FAST kernel != plain version on {name}: "
                                 f"max abs err {err}")
        ms, host_ms = cuda_ms(fast_score_dual_cuda, img, 20.0, 7.0)
        plain_ms, plain_host_ms = cuda_ms(fast_score_dual, img, 20.0, 7.0)
        rows.append((name, tuple(img.shape), err, ms, plain_ms))
        print(f"fast_nms {name:>13} {tuple(img.shape)}: bitwise equal; device "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; host-bound kernel "
              f"{host_ms:.4f} ms, plain {plain_host_ms:.4f} ms")
    return rows


def ate_rmse(est_twc: np.ndarray, gt_twc: np.ndarray) -> float:
    from lc_crf_slam_torch.geometry.align import umeyama_alignment

    src = torch.as_tensor(est_twc[:, :3, 3], dtype=torch.float64)
    dst = torch.as_tensor(gt_twc[:, :3, 3], dtype=torch.float64)
    s, R, t = umeyama_alignment(src, dst)
    err = torch.linalg.norm(s * (src @ R.T) + t - dst, dim=-1)
    return float(torch.sqrt(torch.mean(err ** 2)))


def drive(slam, frames, counted):
    """Every frame through `slam.track_rgbd`, each timed to a synchronize:
    (ms per frame, {frame: host syncs} for the frames in `counted`, counted
    in torch's sync debug mode, FAST kernel launches, peak device MiB)."""
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
            slam.track_rgbd(f.image, f.depth_image, f.timestamp)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        if k in counted:
            syncs[k] = sum("synchronizing CUDA operation" in str(w.message)
                           for w in caught)
    return (frame_ms, syncs, fast_kernel.launches,
            torch.cuda.max_memory_allocated() / 2**20)


def dynamic_phase(cam) -> int:
    """The per-frame dynamic pipeline at full width (see the module
    docstring, step 5); returns the FAST launches of the phase."""
    from lc_crf_slam_torch.config import LoopConfig, SLAMConfig
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    world = SyntheticWorld(cam=cam, n_frames=60, n_static=1400, n_dynamic=0,
                           seed=7, trajectory="line", billboard=True,
                           bb_speed=0.04)
    frames = [world.frame(k, render=True) for k in range(DYN_FRAMES)]
    cfg = SLAMConfig(loop=LoopConfig(enabled=False))
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True,
                      device="cuda")
    # from the 4th frame on, count every frame's host syncs
    frame_ms, syncs, launches, peak_mb = drive(slam, frames, range(3, DYN_FRAMES))

    slam.flush_stats()
    _, poses = slam.get_trajectory()
    _, gt = world.groundtruth()
    if poses.shape != (DYN_FRAMES, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"dynamic phase: bad trajectory, shape {poses.shape}")
    ate = ate_rmse(poses, gt[:DYN_FRAMES])
    statuses = [s.get("status", 1) for s in slam.stats]
    is_kf = [bool(s.get("need_kf")) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    kf_ms = [t for t, kf in zip(frame_ms[3:], is_kf[3:]) if kf]
    other_ms = [t for t, kf in zip(frame_ms[3:], is_kf[3:]) if not kf]
    kf_at = [k for k in range(3, DYN_FRAMES) if is_kf[k]]
    other_at = [k for k in range(3, DYN_FRAMES) if not is_kf[k]]
    last = slam.stats[-1]
    print(f"dynamic: {DYN_FRAMES} frames, median {statistics.median(frame_ms[3:]):.2f} "
          f"ms/frame after the first 3 (keyframe frames {statistics.median(kf_ms):.2f} "
          f"over {len(kf_ms)}, other frames {statistics.median(other_ms):.2f} over "
          f"{len(other_ms)}), first frame {frame_ms[0]:.1f} ms")
    print(f"dynamic: ATE {ate:.5f} m (JAX reference on the same frames, CPU: "
          f"{REF_DYN_ATE_M:.5f} m), keyframes {n_kfs}, lost frames "
          f"{statuses.count(2)}, mapping_step calls {slam.n_mapping_steps}, "
          f"crf_step calls {slam.n_crf_steps}, FAST launches {launches}, peak "
          f"memory {peak_mb:.0f} MiB")
    print(f"dynamic: host syncs on keyframe frame {kf_at[0]}: {syncs[kf_at[0]]}, on "
          f"non-keyframe frame {other_at[0]}: {syncs[other_at[0]]}; per frame "
          f"from the 4th {list(syncs.values())}")
    print(f"dynamic: last frame n_dynamic {last['n_dynamic']}, n_tracks "
          f"{last['crf_tracks']}")
    if launches != cfg.orb.n_levels * DYN_FRAMES:
        raise AssertionError(f"dynamic phase: FAST kernel launched {launches} "
                             f"times, expected {cfg.orb.n_levels * DYN_FRAMES}")
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from lc_crf_slam_torch.config import LoopConfig, SLAMConfig
    from lc_crf_slam_torch.geometry.camera import TUM3
    from lc_crf_slam_torch.kernels import build
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.ops.pyramid import build_pyramid
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load("fast_nms")
    print(f"build fast_nms (nvcc, then load): {time.perf_counter() - t0:.2f} s")

    # ---- kernel vs plain ---------------------------------------------------
    cam = TUM3
    world = SyntheticWorld(cam=cam, n_frames=N_FRAMES, n_static=600,
                           n_dynamic=0, seed=0)
    t0 = time.perf_counter()
    frames = [world.frame(k, render=True) for k in range(N_FRAMES)]
    print(f"rendered {N_FRAMES} frames {cam.width}x{cam.height} in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    cfg = SLAMConfig(loop=LoopConfig(enabled=False))
    levels = build_pyramid(torch.as_tensor(frames[0].image, device=dev),
                           cfg.orb.n_levels, cfg.orb.scale_factor)
    rng = np.random.default_rng(0)
    images = [(f"level{l}", img) for l, img in enumerate(levels)]
    for shape in ((200, 300), (256, 256)):
        images.append((f"random{shape[0]}x{shape[1]}", torch.as_tensor(
            (rng.random(shape) * 255).astype(np.float32), device=dev)))
    rows = check_fast_kernel(images)

    # ---- the tracking slice at full width ----------------------------------
    slam = SLAMSystem(cam, cfg, enable_mapping=False, enable_crf=False,
                      device="cuda")
    # frames 10-11 count their host syncs (the design has one: the
    # keyframe decision fetch)
    frame_ms, syncs, fast_launches, peak_mb = drive(slam, frames, (10, 11))

    slam.flush_stats()
    _, poses = slam.get_trajectory()
    _, gt = world.groundtruth()
    if poses.shape != (N_FRAMES, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"bad trajectory: shape {poses.shape}")
    ate = ate_rmse(poses, gt)
    statuses = [s.get("status", 1) for s in slam.stats]
    n_kfs = int(slam.map.n_kfs)
    inliers = [s["n_inliers"] for s in slam.stats if "n_inliers" in s]
    med = statistics.median(frame_ms[3:])
    print(f"slice: {N_FRAMES} frames, median {med:.2f} ms/frame after the "
          f"first 3 ({1e3 / med:.1f} fps), first frame {frame_ms[0]:.1f} ms, "
          f"ATE {ate:.5f} m, keyframes {n_kfs}, mean inliers "
          f"{np.mean(inliers):.1f}, lost frames {statuses.count(2)}, "
          f"FAST launches {fast_launches}, peak memory {peak_mb:.0f} MiB, "
          f"host syncs per frame {list(syncs.values())}")
    if fast_launches != cfg.orb.n_levels * N_FRAMES:
        raise AssertionError(
            f"FAST kernel launched {fast_launches} times, expected "
            f"{cfg.orb.n_levels * N_FRAMES}")
    if 2 in statuses:
        raise AssertionError(f"tracking lost: statuses {statuses}")
    if n_kfs < 2:
        raise AssertionError(f"only {n_kfs} keyframes")
    if not ate < ATE_BAR_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_BAR_M} m")

    # ---- the per-frame dynamic pipeline at full width ----------------------
    dyn_launches = dynamic_phase(cam)

    # ---- report ------------------------------------------------------------
    level_rows = [r for r in rows if r[0].startswith("level")]
    report = {"kernels": [{
        "name": "fast_nms_dual",
        "route": "cuda",
        "source": "lc_crf_slam_torch/csrc/fast_nms.cu",
        "replaces": "lc_crf_slam_tpu/ops/pallas_fast.py:143",
        "launches": fast_launches + dyn_launches,
        "max_abs_err": max(r[2] for r in rows),
        # one frame's FAST: the sum over the 8 pyramid level shapes
        "ms": sum(r[3] for r in level_rows),
        "plain_ms": sum(r[4] for r in level_rows),
    }]}
    print(card_line())
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
