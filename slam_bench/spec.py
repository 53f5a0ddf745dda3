"""Find a cell's pieces by name, from files alone: `BENCHMARK.json` at the
checkout's root names the cell, its configuration (a JSON file under
`slam_bench/configs/`) and its traffic (`slam_bench/traffic/<name>.json`,
parameters only); the traffic names the program's entry that its frames
go to, handed in by `slam_bench/entries/<entry>.py`; each metric is read
by `slam_bench/metrics/<name>.py`, a module with a `read(run)` function.
A new cell, configuration, mix, entry or metric is new files and entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = "slam_bench"


def root_of_checkout() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _named(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workloads")


def config(root: str, bench: dict, name: str) -> dict:
    return _json(os.path.join(root, _named(bench["configs"], name, "configs")["file"]))


# the keys every mix gives: the entry, the warm-up's keyframes (set-up runs
# the session's first hand-ins until so many keyframes have been taken, and
# one more) and the frames of a traced run's profiled slice
TRAFFIC_KEYS = {"entry": str, "warmup_keyframes": int, "trace_frames": int}


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(root: str, name: str):
    """`slam_bench/entries/<name>.py`: `PARAMS` (the mix's keys it takes,
    each with its type), `render(world, k)`, `steps(n, params)` and
    `hand_in(slam, frames, ks, params)`."""
    return _module(os.path.join(root, BENCH_DIR, "entries", f"{name}.py"),
                   f"slam_bench_entry_{name}")


def traffic(root: str, name: str) -> dict:
    """The mix's parameters, with its entry's module under `module`. A key
    that neither every mix nor the entry takes, or a value of another
    type, is refused: nothing in a mix goes unread."""
    mix = _json(os.path.join(root, BENCH_DIR, "traffic", f"{name}.json"))
    mod = entry(root, mix["entry"])
    keys = {**TRAFFIC_KEYS, **mod.PARAMS}
    for key, value in mix.items():
        if key not in keys:
            raise KeyError(f"traffic {name!r}: key {key!r} is read by nothing")
        if not isinstance(value, keys[key]) or isinstance(value, bool) != (keys[key] is bool):
            raise TypeError(f"traffic {name!r}: {key!r} is not {keys[key].__name__}")
    missing = set(keys) - set(mix)
    if missing:
        raise KeyError(f"traffic {name!r} lacks {sorted(missing)}")
    return {**mix, "module": mod}


def metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (`trace` false) or its per-layer ones:
    every entry whose `workloads`, where given, names the cell."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def reader(root: str, name: str) -> Callable:
    """`read` of `slam_bench/metrics/<name>.py`."""
    return _module(os.path.join(root, BENCH_DIR, "metrics", f"{name}.py"),
                   f"slam_bench_metric_{name}").read


def readers(root: str, entries: List[dict]) -> Dict[str, Callable]:
    return {m["name"]: reader(root, m["name"]) for m in entries}
