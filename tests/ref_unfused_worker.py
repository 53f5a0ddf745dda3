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
"""

import argparse
import os
import sys

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

from torch_parity import UNFUSED_RUNS, cameras, render  # noqa: E402

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


def save_state(path: str, slam: SLAMSystem, spread: float = -1.0) -> None:
    """The system's state after its last frame, in one compressed npz:
    "map/<field>" (the keyframe fields cut to n_kfs slots, the point fields
    to n_points: the slots past them are as the empty map leaves them),
    "ts/<field>", the loop glue's host state ("consistent_masks" (G, F),
    "consistent_streaks", "last_loop_kf", "gba_left" and "gba_kf" (-1: no
    budget pending), "gba_slices_run"), "reloc_key" (the key the next
    relocalisation or verification splits), and the frame's own record
    ("rec/<stat>", with "rec/pose_spread": `pose_spread` from the state
    before the frame, -1 where not measured)."""
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
    rec = slam.stats[-1]
    for key in ("n_inliers", "need_kf", "status"):
        out[f"rec/{key}"] = np.asarray(rec.get(key, -1))
    out["rec/pose_spread"] = np.float64(spread)
    np.savez_compressed(path, **out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("n", type=int)
    ap.add_argument("--world", default="pan", choices=sorted(UNFUSED_RUNS))
    ap.add_argument("--states")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--run", type=int)
    args = ap.parse_args(argv)
    world_kw, cfg, cam = UNFUSED_RUNS[args.world]
    cam = cameras(cam)[0]
    world = SyntheticWorld(cam=cam, n_frames=args.n, **world_kw)
    slam = SLAMSystem(cam, cfg, enable_mapping=True, enable_crf=True)
    for k in range(args.run or args.n):
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
    np.savez(args.out, n_inliers=np.array([s["n_inliers"] for s in stats]),
             need_kf=np.array([bool(s["need_kf"]) for s in stats]),
             status=np.array([s["status"] for s in stats]),
             poses=np.asarray(poses, np.float64),
             event_at=np.array([i for i, _ in events], np.int64),
             event=np.array([e for _, e in events]),
             kf_log=np.array([(t, int(k)) for t, k in slam.kf_log], dtype=np.float64),
             loop_log=np.array([(a["kf"], a["cand"], a["inliers"]) for a in slam.loop_log],
                               dtype=np.int64).reshape(-1, 3),
             ate=evaluate_ate(ts, np.asarray(poses), gt_t, gt).rmse)


if __name__ == "__main__":
    main()
