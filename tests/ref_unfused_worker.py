"""The JAX reference one frame at a time with XLA's backend optimisations
off, so that its float arithmetic runs op for op, as the port's does: the
reference side of the port's per-frame runs against it
(tests/test_torch_loop_close.py, test_torch_pan_steps.py,
test_torch_capacity.py). The caller starts it in a fresh process
with XLA_FLAGS=--xla_backend_optimization_level=0 (JAX reads the flag at
start-up) and reads the npz it writes:

    python tests/ref_unfused_worker.py OUT.npz N_FRAMES [--world NAME]
        [--states DIR --first K] [--run M]

`--world`: "pan" (`torch_parity.PAN_WORLD`, QVGA, the default
configuration), "pan4096" (the same with 4096 point slots, so that the
point table recycles) or "orbit16" (`ORBIT_WORLD` at 640x480 with
`ORBIT_CFG`'s 16 keyframe slots and 4096 point slots), as
`torch_parity.UNFUSED_RUNS` lists them. `--run M`:
the world's first M frames (past N_FRAMES its trajectory goes on).
`--states DIR`: after each frame k >= K the whole system state goes to
DIR/state_{k:03d}.npz (`save_state`), so that a test can start the port
from the reference's own state at any of those frames and compare one
step; from the frame after K on, each state also holds how far the
reference's own step moves when its previous pose moves by 1e-7 to 1e-6 m
(`pose_spread`).

"loop640" (`torch_parity.LOOP_WORLD` at 640x480, the default
configuration) runs through `track_sequence` in chunks of
`torch_parity.CHUNKED_RUNS[name]` frames instead, jitted unless the
caller turns XLA's optimisations off. There `--states DIR --first K`
(K a chunk boundary: the frame that ends a chunk) writes the state after
frame K and after each later chunk, each with the chunk's outcome
("chunk/<field>", `chunk_record`). Every step's keyframe terms come out
of the chunk program through `jax.debug.callback` (`record_steps`).
"""

import argparse
import functools
import os
import sys
from types import SimpleNamespace

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lc_crf_slam_tpu.models.system import SLAMSystem  # noqa: E402
from lc_crf_slam_tpu.utils.evaluate import evaluate_ate  # noqa: E402
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld  # noqa: E402

from lc_crf_slam_tpu.models import system as ref_system  # noqa: E402
from torch_parity import (CHUNKED_RUNS, STEP_TERMS, UNFUSED_RUNS, cameras,  # noqa: E402
                          keyframe_terms, render)

SPREAD_MOVES_M = (1e-7, 3e-7, 1e-6)
SPREAD_DRAWS = 8                       # per move size


def pose_spread(slam: SLAMSystem, gray, depth, seed: int) -> float:
    """How far the reference's own `track_step` moves the next frame's pose
    when the tracker's pose moves by a few float32 steps: the largest
    change of Tcw over SPREAD_DRAWS random moves of its translation by
    each of SPREAD_MOVES_M, from the system's present state. A port step
    from this state that lands this far from the reference's does no more
    than the reference does with its own rounding."""
    frame = slam._build_frame(slam.cam, slam.cfg, jnp.asarray(gray, jnp.float32),
                              jnp.asarray(depth, jnp.float32))
    track = lambda ts: np.asarray(slam._track(slam.cfg, slam.cam, slam.map, ts,  # noqa: E731
                                              frame)[0].Tcw)
    base = track(slam.ts)
    rng = np.random.default_rng(seed)
    moves = []
    for move in SPREAD_MOVES_M:
        for _ in range(SPREAD_DRAWS):
            T = np.array(slam.ts.Tcw)
            T[:3, 3] += rng.normal(0, move, 3)
            moves.append(float(np.abs(track(slam.ts._replace(Tcw=jnp.asarray(
                T, jnp.float32))) - base).max()))
    return max(moves)


def save_state(path: str, slam: SLAMSystem, spread: float = -1.0, rec=None,
               extra=None) -> None:
    """The system's state after its last frame, in one compressed npz:
    "map/<field>" (the keyframe fields cut to n_kfs slots, the point fields
    to n_points: the slots past them are as the empty map leaves them),
    "ts/<field>", the loop glue's host state ("consistent_masks" (G, F),
    "consistent_streaks", "last_loop_kf", "gba_left" and "gba_kf" (-1: no
    budget pending), "gba_slices_run"), "reloc_key" (the key the next
    relocalisation or verification splits), the frame's own record
    ("rec/<stat>" of `rec`, by default the last of the system's stats,
    with "rec/pose_spread": `pose_spread` from the state before the
    frame, -1 where not measured), and the arrays of `extra` as they are."""
    m, n_kfs, n_pts = slam.map, int(slam.map.n_kfs), int(slam.map.n_points)
    out = {}
    for f in m._fields:
        a = np.asarray(getattr(m, f))
        out[f"map/{f}"] = a[:n_kfs] if f.startswith("kf_") else \
            a[:n_pts] if f.startswith("p_") else a
    out.update({f"ts/{f}": np.asarray(getattr(slam.ts, f)) for f in slam.ts._fields})
    groups = slam._consistent_groups
    out["consistent_masks"] = np.array([np.asarray(g, bool) for g, _ in groups],
                                       bool).reshape(len(groups), m.capacity_kfs)
    out["consistent_streaks"] = np.array([s for _, s in groups], np.int64)
    out["last_loop_kf"] = np.int64(slam._last_loop_kf)
    pending = slam._gba_pending or {"left": -1, "kf": -1}
    out["gba_left"], out["gba_kf"] = np.int64(pending["left"]), np.int64(pending["kf"])
    out["gba_slices_run"] = np.int64(slam._gba_slices_run)
    out["reloc_key"] = np.asarray(slam._reloc_key)
    rec = slam.stats[-1] if rec is None else rec
    for key in ("n_inliers", "need_kf", "status"):
        out[f"rec/{key}"] = np.asarray(rec.get(key, -1))
    out["rec/pose_spread"] = np.float64(spread)
    out.update(extra or {})
    np.savez_compressed(path, **out)


_MAP_TERMS = ("kf_obs", "kf_valid", "p_alive", "p_n_obs", "n_kfs")
_TS_TERMS = ("ref_kf", "frame_idx", "n_since_kf", "status", "Tcw")
_INFO_TERMS = ("n_inliers", "n_tracked_close", "n_untracked_close", "need_kf")


def record_steps() -> list:
    """Make the reference's chunk program report each step to the host,
    one dict a step in scan order, padded steps included: its keyframe
    terms (`torch_parity.keyframe_terms`), "Tcw" and "ref_kf" after it.
    The system module's `track_step` is wrapped before the program is
    traced. Returns the list it fills."""
    log = []
    orig = ref_system.track_step
    pick = lambda t, fields: {f: getattr(t, f) for f in fields}  # noqa: E731

    def sink(cfg, *parts):
        m, ts, ts2, info = (SimpleNamespace(**{k: np.asarray(v) for k, v in d.items()})
                            for d in parts)
        log.append(dict(keyframe_terms(cfg, m, ts, ts2, info), Tcw=ts2.Tcw,
                        ref_kf=int(ts2.ref_kf)))

    def wrapped(cfg, cam, m, ts, fr):
        ts2, m2, info = orig(cfg, cam, m, ts, fr)
        jax.debug.callback(functools.partial(sink, cfg), pick(m2, _MAP_TERMS),
                           pick(ts, _TS_TERMS), pick(ts2, _TS_TERMS),
                           pick(info, _INFO_TERMS), ordered=True)
        return ts2, m2, info

    ref_system.track_step = wrapped
    return log


def record_loop_glue(slam: SLAMSystem) -> dict:
    """Log the loop glue of `slam`: each keyframe's detection as the chunk
    handed it over (kf, valid, candidates) and each verification (kf,
    cand, accepted, inliers)."""
    log = {"detected": [], "verified": []}
    close, verify = slam._try_close_loop, slam._verify_loop

    def close_logged(pre=None):
        log["detected"].append((int(pre[0]), bool(pre[1]), np.asarray(pre[2]).copy()))
        return close(pre)

    def verify_logged(cfg, cam, m, kf, cand, key):
        ver = verify(cfg, cam, m, kf, cand, key)
        log["verified"].append((int(kf), int(cand), int(ver.accepted), int(ver.n_inliers)))
        return ver

    slam._try_close_loop, slam._verify_loop = close_logged, verify_logged
    return log


def chunk_record(steps, glue, events) -> dict:
    """A chunk's outcome as "chunk/<field>" arrays: its steps' keyframe
    terms (STEP_TERMS, by name: `need_kf` is the keyframe flag, as the
    chunk program inserts), "Tcw" and "ref_kf"; the detections its
    keyframes handed the loop glue ("detected_kf",
    "detected_valid", "detected_cands"), the verifications they ran
    ("verified": (kf, cand, accepted, inliers) rows) and its events
    ("events": (kind, lost frames or inliers) rows)."""
    out = {f"chunk/{t}": np.array([s[t] for s in steps])
           for t in STEP_TERMS + ("Tcw", "ref_kf")}
    det = glue["detected"]
    out["chunk/detected_kf"] = np.array([d[0] for d in det], np.int64)
    out["chunk/detected_valid"] = np.array([d[1] for d in det], bool)
    out["chunk/detected_cands"] = (np.array([d[2] for d in det], np.int64) if det
                                   else np.zeros((0, 0), np.int64))
    out["chunk/verified"] = np.array(glue["verified"], np.int64).reshape(-1, 4)
    out["chunk/events"] = np.array(
        [(e["event"], str(e.get("lost_frames", e.get("inliers", -1)))) for e in events],
        dtype=str).reshape(-1, 2)
    return out


def chunk_spread(slam: SLAMSystem, frames, ks, chunk: int, draws: int, seed: int):
    """How far the reference's own chunk program moves over frames `ks`
    when the tracker's pose moves by a few float32 steps, from the
    system's present state: the largest change of each frame's Tcw over
    `draws` random moves of the translation by each of SPREAD_MOVES_M,
    and each draw's keyframe flags ((draws * 3, len(ks)) bool)."""
    take = len(ks)
    pad = [ks[-1]] * (chunk - take)
    g = jnp.asarray(np.stack([frames[k][0] for k in list(ks) + pad]))
    d = jnp.asarray(np.stack([frames[k][1] for k in list(ks) + pad]))
    valid = jnp.asarray(np.arange(chunk) < take)
    tst = jnp.asarray(np.array([k / 30.0 for k in ks] + [0.0] * len(pad), np.float32))
    run = lambda ts: jax.device_get(slam._scan_chunk_fn(  # noqa: E731
        slam.map, ts, g, d, valid, tst, jnp.asarray(True), jnp.asarray(slam._last_gray))[2])
    base = run(slam.ts)[0][:take]
    rng = np.random.default_rng(seed)
    worst, flags = np.zeros(take), []
    for move in SPREAD_MOVES_M:
        for _ in range(draws):
            T = np.array(slam.ts.Tcw)
            T[:3, 3] += rng.normal(0, move, 3)
            out = run(slam.ts._replace(Tcw=jnp.asarray(T, jnp.float32)))
            worst = np.maximum(worst, np.abs(out[0][:take] - base).max(axis=(1, 2)))
            flags.append(out[2][:take])
    return worst, np.array(flags, bool)


def run_chunked(slam: SLAMSystem, world, n: int, chunk: int, states, first: int,
                move: float = 0.0, move_at: int = -1, seed: int = 0,
                spread_draws: int = 0) -> dict:
    """The reference's `track_sequence` over world frames 0..n-1 in chunks
    of `chunk`, with every step's record (`record_steps`) and the loop
    glue's (`record_loop_glue`). With `states`, the state after frame
    `first` (a chunk boundary) and after every later chunk goes to
    states/state_{k:03d}.npz, each with that chunk's `chunk_record`. With
    `move`, the tracker's translation moves by normal(0, move) per axis
    after frame `move_at` (a chunk boundary): the reference's own spread
    over the rest of the run. With `spread_draws`, each saved chunk after
    the first also holds the reference's own spread from the state before
    it (`chunk_spread`: "chunk/spread", "chunk/spread_kf"). Returns the
    run's verifications ((kf, cand, accepted, inliers) rows)."""
    steps = record_steps()
    glue = record_loop_glue(slam)
    frames = [render(world, k) for k in range(n)]
    ends = {n - 1}
    if states:
        ends |= {first, *range(first + chunk, n - 1, chunk)}
    if move:
        ends.add(move_at)
    assert all(e == n - 1 or e % chunk == 0 for e in ends), "chunk boundaries only"
    start = 0
    for end in sorted(ends):
        n_steps, n_stats = len(steps), len(slam.stats)
        n_det, n_ver = len(glue["detected"]), len(glue["verified"])
        seg = range(start, end + 1)
        spread = None
        if spread_draws and states and start > first and hasattr(slam, "_scan_chunk_fn"):
            spread = chunk_spread(slam, frames, seg, chunk, spread_draws, start)
            del steps[n_steps:]     # the spread's steps are not the run's
        if end == 0:    # the first frame alone: it initialises the map
            slam.track_rgbd(*frames[0], 0.0)
        else:
            slam.track_sequence(np.stack([frames[k][0] for k in seg]),
                                np.stack([frames[k][1] for k in seg]),
                                np.array([k / 30.0 for k in seg]), chunk=chunk)
        take = len(seg) - (start == 0)      # frame 0 initialises the map
        if states and end >= first:
            slam.flush_stats()
            extra = chunk_record(steps[n_steps:n_steps + take],
                                 {k: v[n0:] for (k, v), n0 in zip(glue.items(),
                                                                   (n_det, n_ver))},
                                 [e for e in slam.stats[n_stats:] if "event" in e]
                                 ) if take else {}
            if spread is not None:
                extra["chunk/spread"], extra["chunk/spread_kf"] = spread
            last = steps[n_steps + take - 1] if take else {}
            save_state(os.path.join(states, f"state_{end:03d}.npz"), slam, rec=last,
                       extra=extra)
        if move and end == move_at:
            T = np.array(slam.ts.Tcw)
            T[:3, 3] += np.random.default_rng(seed).normal(0, move, 3)
            slam.ts = slam.ts._replace(Tcw=jnp.asarray(T, jnp.float32))
        start = end + 1
    return {"verified": np.array(glue["verified"], np.int64).reshape(-1, 4)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("n", type=int)
    ap.add_argument("--world", default="pan", choices=sorted(UNFUSED_RUNS))
    ap.add_argument("--states")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--run", type=int)
    ap.add_argument("--move", type=float, default=0.0)
    ap.add_argument("--move-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spread-draws", type=int, default=0)
    args = ap.parse_args(argv)
    world_kw, cfg, cam = UNFUSED_RUNS[args.world]
    cam = cameras(cam)[0]
    world = SyntheticWorld(cam=cam, n_frames=args.n, **world_kw)
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True)
    chunk = CHUNKED_RUNS.get(args.world)
    run = {}
    if chunk:
        run = run_chunked(slam, world, args.run or args.n, chunk, args.states, args.first,
                          args.move, args.move_at, args.seed, args.spread_draws)
    for k in range(0 if chunk else args.run or args.n):
        gray, depth = render(world, k)
        saved = args.states and k >= args.first
        spread = pose_spread(slam, gray, depth, k) if saved and k > args.first else -1.0
        slam.track_rgbd(gray, depth, k / 30.0)
        if saved:
            slam.flush_stats()
            save_state(os.path.join(args.states, f"state_{k:03d}.npz"), slam, spread)
    slam.flush_stats()
    ts, poses = slam.get_trajectory()
    gt_t = np.arange(len(ts)) / 30.0       # frame k at k / 30 s, past n_frames too
    gt = np.stack([world.gt_pose_twc(k) for k in range(len(ts))])
    events = [(i, s["event"]) for i, s in enumerate(slam.stats) if "event" in s]
    stats = [s for s in slam.stats[1:] if "event" not in s]
    if not chunk:
        run = dict(n_inliers=np.array([s["n_inliers"] for s in stats]),
                   need_kf=np.array([bool(s["need_kf"]) for s in stats]),
                   status=np.array([s["status"] for s in stats]))
    np.savez(args.out, **run,
             poses=np.asarray(poses, np.float64),
             event_at=np.array([i for i, _ in events], np.int64),
             event=np.array([e for _, e in events]),
             event_n=np.array([slam.stats[i].get("lost_frames",
                                                 slam.stats[i].get("inliers", -1))
                               for i, _ in events], np.int64),
             kf_log=np.array([(t, int(k)) for t, k in slam.kf_log], dtype=np.float64),
             loop_log=np.array([(a["kf"], a["cand"], a["inliers"]) for a in slam.loop_log],
                               dtype=np.int64).reshape(-1, 3),
             ate=evaluate_ate(ts, np.asarray(poses), gt_t, gt).rmse)


if __name__ == "__main__":
    main()
