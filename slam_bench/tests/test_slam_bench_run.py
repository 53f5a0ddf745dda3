"""A whole run on the CPU at a tiny size (the look for a card skipped):
the result has exactly the contract's keys in order, a sound run is
correct, the control and each planted fault are not; and the command
refuses to run without a card and prints no result."""

import json
import os
import subprocess
import sys
import time

import pytest

from slam_bench import session
from slam_bench.reference import checks
from slam_bench.reference.frontend import reference_frame
from slam_bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 2**31 + 11


def run(tmp_path, trace=False, variant=None):
    """A window of one tiny session's 5 frames, whatever the CPU's speed."""
    root = tiny.make_root(str(tmp_path))
    return session.run(root, tiny.CELL, SEED, 0.0, trace, time.perf_counter(),
                       device="cpu", variant=variant, frames=5, log=lambda s: None)


def test_sound_run_is_correct_and_keys_are_the_contracts(tmp_path):
    r = run(tmp_path)
    assert list(r) == KEYS
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 3 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "frame_ms.p95", "setup_s"}   # no card: no peak
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_traced_run_keys(tmp_path):
    r = run(tmp_path, trace=True)
    assert list(r) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"frontend_ms", "track_ms"} <= set(r["metrics"])


@pytest.mark.parametrize("fault", ["stale_state", "half_batch", "altered_answer",
                                   "depth_scaled", "crf_off", "loop_off"])
def test_fault_is_not_correct(tmp_path, fault):
    r = run(tmp_path, variant=fault)
    assert r["attempted"] >= 3          # enough frames for a session's ATE
    assert r["correct"] is False, r["checks"]


def test_control_is_not_correct():
    """The control, the reference in TF32 put in the program's place,
    against the reference in float32 on a frame of the walking cell."""
    conf = tiny.tiny_config()
    with open(os.path.join(tiny.BENCH, "configs", "tum3_walking_rgbd.json")) as fh:
        walking = json.load(fh)
    gray, depth, _ = session.render(session.world_of(walking, SEED), 1)[0]
    orb = {k.split(".", 1)[1]: v for k, v in walking["slam"].items() if k.startswith("orb.")}

    def host(f):
        return {k: getattr(f, k).numpy() for k in ("uv", "level", "desc", "valid")}

    ref = host(reference_frame(gray, depth, orb, "cpu"))
    control = host(reference_frame(gray, depth, orb, "cpu", tf32=True))
    kp, bits, n = checks.keypoint_diff(control, ref)
    assert n > 900
    limits = walking["checks"]
    assert kp > limits["kp_diff"] or bits > limits["desc_bits"], (kp, bits)
    assert conf["checks"].items() <= limits.items()


def test_no_card_no_result(tmp_path):
    """The command in a checkout of BENCHMARK.json and slam_bench/ alone,
    on a machine without a card: non-zero, nothing on standard output."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command would run")
    shutil.copytree(tiny.BENCH, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "slam_bench/run.py", "--workload", "walking.perframe",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
