"""Readings that the limits of `correct` are set from, on the chip: the
program's sound runs over many seeds (the lower readings), and the
control and planted faults (`faults.py`) over a few (the upper readings).
The benchmark's own runs never run this.

    python3 slam_bench/calibrate.py --workload CELL --seeds 1,2,3 \
        [--variants tf32,stale_state --variant-seeds 4,5,6] \
        [--frames 64,80 | --seconds S] [--jobs J] \
        [--out build/slam_bench/calibrate.jsonl]

Each run is a whole run of the cell (set-up, window, comparison). With
`--frames` a window ends after so many frames (the list is taken in turn
over the runs), not after `--seconds`: a reading then does not depend on
the host's speed, so `--jobs` processes may share the card, each running
its share of the runs one after another (their times are not the
benchmark's). One JSON line a run goes to `--out`, with the compared
numbers and the diagnostics beside them; a summary per number (the
largest sound reading, each variant's smallest) ends standard output.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plan_of(args) -> list:
    frames = [int(f) for f in args.frames.split(",")] if args.frames else [None]
    plan = [(None, int(s)) for s in args.seeds.split(",")]
    for v in filter(None, args.variants.split(",")):
        plan += [(v, int(s)) for s in args.variant_seeds.split(",")]
    return [(v, s, frames[i % len(frames)]) for i, (v, s) in enumerate(plan)]


def run_part(args, plan: list, out_path: str) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from slam_bench import session

    with open(out_path, "a") as out:
        for variant, seed, frames in plan:
            t0 = time.perf_counter()
            row = {"workload": args.workload, "variant": variant, "seed": seed,
                   "frames": frames}
            try:
                r = session.run(ROOT, args.workload, seed, args.seconds or 0.0, False, t0,
                                variant=variant, frames=frames, diagnose=True,
                                log=lambda s: print(s, file=sys.stderr, flush=True))
                row.update(correct=r["correct"], attempted=r["attempted"],
                           failed=r["failed"],
                           checks={k: c["value"] for k, c in r["checks"].items()},
                           metrics={k: m["value"] for k, m in r["metrics"].items()},
                           diagnostics=r["diagnostics"])
            except Exception:          # a variant that crashes has failed
                row["error"] = traceback.format_exc(limit=3)
            row["seconds"] = time.perf_counter() - t0
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(json.dumps(row), flush=True)


def summary(rows: list) -> dict:
    out = {}
    for row in rows:
        for name, v in row.get("checks", {}).items():
            v = float("inf") if v is None or not math.isfinite(v) else v
            s = out.setdefault(name, {})
            key = row["variant"] or "sound_max"
            if key == "sound_max":
                s[key] = max(s.get(key, 0.0), v)
            else:
                s[key] = min(s.get(key, float("inf")), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--frames", default="")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="")
    ap.add_argument("--variant-seeds", default="")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--part", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join("build", "slam_bench", "calibrate.jsonl"))
    args = ap.parse_args(argv)
    if not args.frames and args.seconds is None:
        ap.error("give --frames or --seconds")
    if args.jobs > 1 and not args.frames:
        ap.error("--jobs needs --frames: runs that share the card end by frames")
    plan = plan_of(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.part is not None:
        run_part(args, plan[args.part::args.jobs], f"{args.out}.{args.part}")
        return 0
    if args.jobs == 1:
        parts = [args.out + ".0"]
        run_part(args, plan, parts[0])
    else:
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        argv = [a for a in (argv if argv is not None else sys.argv[1:])]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv,
                                   "--part", str(i)], env=env)
                 for i in range(args.jobs)]
        for p in procs:
            p.wait()
        parts = [f"{args.out}.{i}" for i in range(args.jobs)]
    rows = []
    for path in parts:
        if os.path.exists(path):
            with open(path) as fh:
                rows += [json.loads(line) for line in fh if line.strip()]
    print("summary " + json.dumps(summary(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
