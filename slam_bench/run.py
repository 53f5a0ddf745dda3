"""The benchmark of lc_crf_slam_torch on one NVIDIA card.

    python3 slam_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of BENCHMARK.json (found by name with its configuration,
traffic and metric readers, see `spec.py`) and prints, as the last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared with its limit; the same numbers end
standard error. Exits non-zero and prints no result without the cards the
cell asks for, or when jax or the JAX package is loaded after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules whose top-level name must not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "lc_crf_slam_tpu")


def process_start() -> float:
    """The host clock (perf_counter) at this process's start, from
    /proc; the time this module was first run where /proc has none."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 60 else T_START
    except (OSError, ValueError, IndexError):
        return T_START


def cache_dirs(root: str) -> None:
    """Every kernel cache inside the checkout, at fixed paths (the
    program's own nvcc output goes to its build/torch_kernels/)."""
    base = os.path.join(root, "build", "slam_bench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def loaded_forbidden() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    cache_dirs(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from slam_bench import session

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    try:
        result = session.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start, log=log)
    except session.NoCard as e:
        log(f"slam_bench: {e}")
        return 2
    bad = loaded_forbidden()
    if bad:
        log(f"slam_bench: loaded after the window: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
