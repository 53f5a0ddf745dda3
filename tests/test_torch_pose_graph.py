"""The motion-only solve as a CUDA graph (models/ba.py `pose_optimize`).

On the CPU: the solve runs op by op and opens neither graph span, the
cache key separates what a capture bakes in, and the benchmark's reader
of the replay share reads the spans. On the card (`cuda`-marked, skipped
without one): the four solves of a tracked frame of `chip_smoke.py`'s
walking world, replayed, give the solve op by op bit for bit; a call's
returned tensors stay its own; each key captures once, with no host sync
and no second cuBLAS workspace in the allocated memory; a call made while
a stream is capturing runs op by op.

This file imports neither jax nor the JAX package, so its card tests run
where jax is not installed (without tests/conftest.py, which imports it):

    python3 -m pytest --noconftest -q tests/test_torch_pose_graph.py
"""

import dataclasses
import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

from lc_crf_slam_torch.config import LoopConfig, PoseOptConfig, SLAMConfig
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.geometry.se3 import exp_se3
from lc_crf_slam_torch.models import ba, tracking
from lc_crf_slam_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_SPANS = {"pose_optimize.capture", "pose_optimize.replay"}


def _problem(n=256, seed=0):
    """pose_optimize's inputs on the CPU: points 2-6 m ahead, observed
    with pixel noise, 15% outliers, 60% stereo, 5% invalid."""
    rng = np.random.default_rng(seed)
    T = exp_se3(torch.tensor([0.1, -0.05, 0.2, 0.03, -0.08, 0.02])).numpy()
    pw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1).astype(np.float32)
    pc = pw @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([TUM3.fx * pc[:, 0] / pc[:, 2] + TUM3.cx,
                   TUM3.fy * pc[:, 1] / pc[:, 2] + TUM3.cy], -1)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < 0.15
    uv[bad] += rng.normal(0, 30, (bad.sum(), 2))
    ur = np.where(rng.random(n) < 0.6, uv[:, 0] - TUM3.bf / pc[:, 2], -1.0)
    T0 = exp_se3(torch.tensor([0.02, 0.01, -0.03, 0.01, 0.0, -0.01])).numpy() @ T
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        T0.astype(np.float32), pw, uv.astype(np.float32), ur.astype(np.float32),
        rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.95))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _assert_same(got: ba.PoseOptResult, want: ba.PoseOptResult) -> None:
    for field, a, b in zip(ba.PoseOptResult._fields, got, want):
        assert _same_bits(a, b), field


# ---- on the CPU ---------------------------------------------------------------

def test_cpu_solve_is_eager_and_opens_no_graph_span():
    args = _problem()
    cfg = PoseOptConfig()
    graphs = dict(ba._GRAPHS)
    timer = profiling.StageTimer()
    with profiling.installed(timer):
        got = ba.pose_optimize(TUM3, *args, cfg, 1.2)
    assert {n: timer.count(n) for n in timer.samples} == {"pose_optimize": 1}
    assert ba._GRAPHS == graphs
    _assert_same(got, ba._lm_solve(TUM3, *args, cfg, 1.2))
    assert 0 < int(got.n_inliers) < len(args[1])


def test_graph_key_separates_what_a_capture_bakes_in():
    args = _problem(n=64)
    cfg = PoseOptConfig()
    key = ba._graph_key(TUM3, args, cfg, 1.2)
    assert key == ba._graph_key(TUM3, tuple(a.clone() for a in _problem(n=64, seed=1)),
                                cfg, 1.2)
    others = [
        ba._graph_key(TUM3, _problem(n=65), cfg, 1.2),                          # N
        ba._graph_key(TUM3, (args[0].double(),) + args[1:], cfg, 1.2),          # a dtype
        ba._graph_key(TUM3, args[:4] + (args[4].long(), args[5]), cfg, 1.2),   # level's
        ba._graph_key(TUM3._replace(fx=500.0), args, cfg, 1.2),                 # camera
        ba._graph_key(TUM3._replace(bf=20.0), args, cfg, 1.2),
        ba._graph_key(TUM3, args, dataclasses.replace(cfg, iters_per_round=5), 1.2),
        ba._graph_key(TUM3, args, dataclasses.replace(cfg, chi2_mono=6.0), 1.2),
        ba._graph_key(TUM3, args, cfg, 1.25),                                   # scale
        ba._graph_key(TUM3, tuple(a[None] for a in args), cfg, 1.2),            # shape
    ]
    assert len({key, *others}) == 1 + len(others)


def _reader(name):
    path = os.path.join(REPO, "slam_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Record:
    def __init__(self, spans):
        self.spans, self.frame_ms = spans, [1000.0] * 10


def test_replay_share_reader():
    read = _reader("pose_graph.replay_share")
    # the window's solves all replayed (the capture ran in the warm-up)
    assert read(_Record({"pose_optimize": (40, 0.1), "pose_optimize.capture": (0, 0.0),
                         "pose_optimize.replay": (40, 0.05)})) == 100.0
    assert read(_Record({"pose_optimize": (40, 0.1), "pose_optimize.capture": (1, 0.1),
                         "pose_optimize.replay": (10, 0.01)})) == 25.0
    # a graph that exists but did not run in the window
    assert read(_Record({"pose_optimize": (8, 1.0), "pose_optimize.capture": (0, 0.0)})) == 0.0
    # no solve in the window; a program without the graph
    assert read(_Record({"pose_optimize.replay": (0, 0.0), "track": (10, 1.0)})) is None
    assert read(_Record({"pose_optimize": (0, 0.0), "pose_optimize.replay": (0, 0.0)})) is None
    assert read(_Record({"pose_optimize": (40, 5.0), "pose_consensus": (10, 0.2)})) is None


# ---- on the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_calls():
    """The four `pose_optimize` calls `track_step` makes on frame 2 of
    `chip_smoke.py`'s walking world (TUM3 at 640x480, 1400 points, the
    billboard), as (args, cfg, scale_factor) with the args copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from lc_crf_slam_torch.kernels import build
    from lc_crf_slam_torch.models.system import SLAMSystem
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    build.build_all()
    for name in build.kernel_names():
        build.load(name)
    world = SyntheticWorld(cam=TUM3, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                           trajectory="line", billboard=True, bb_speed=0.04)
    slam = SLAMSystem(TUM3, SLAMConfig(loop=LoopConfig(enabled=False)), device="cuda")
    calls, real = [], tracking.pose_optimize

    def recording(cam, *args):
        calls.append((tuple(a.clone() for a in args[:6]), *args[6:]))
        return real(cam, *args)

    for k in range(3):
        f = world.frame(k, render=True)
        tracking.pose_optimize = recording if k == 2 else real
        try:
            slam.track_rgbd(f.image, f.depth_image, f.timestamp)
        finally:
            tracking.pose_optimize = real
    torch.cuda.synchronize()
    assert len(calls) == 4
    return calls


@pytest.fixture
def no_graphs(monkeypatch):
    monkeypatch.setattr(ba, "_GRAPHS", {})


def _host_syncs(fn):
    """(fn(), the host syncs torch's sync debug mode reports inside it)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


@pytest.mark.cuda
def test_replay_equals_the_solve_op_by_op(frame_calls, no_graphs):
    assert frame_calls[0][0][1].shape == (1024, 3)
    for args, cfg, sf in frame_calls:
        got = ba.pose_optimize(TUM3, *args, cfg, sf)
        _assert_same(got, ba._lm_solve(TUM3, *args, cfg, sf))
    assert len(ba._GRAPHS) == 1
    assert int(got.n_inliers) > 100


@pytest.mark.cuda
def test_returned_tensors_outlive_the_next_replay(frame_calls, no_graphs):
    (a1, cfg, sf), (a2, _, _) = frame_calls[0], frame_calls[2]
    first = ba.pose_optimize(TUM3, *a1, cfg, sf)
    kept = [t.clone() for t in first]
    second = ba.pose_optimize(TUM3, *a2, cfg, sf)
    torch.cuda.synchronize()
    _assert_same(first, ba.PoseOptResult(*kept))
    assert not _same_bits(first.Tcw, second.Tcw)
    _assert_same(second, ba._lm_solve(TUM3, *a2, cfg, sf))


@pytest.mark.cuda
def test_each_key_captures_once_without_a_host_sync(frame_calls, no_graphs):
    args, cfg, sf = frame_calls[3]
    timer = profiling.StageTimer()
    syncs = []
    with profiling.installed(timer):
        for n in (1024, 512, 1024, 512):
            sub = (args[0],) + tuple(a[:n] for a in args[1:])
            got, n_syncs = _host_syncs(lambda: ba.pose_optimize(TUM3, *sub, cfg, sf))
            syncs.append(n_syncs)
            _assert_same(got, ba._lm_solve(TUM3, *sub, cfg, sf))
    assert syncs == [0, 0, 0, 0]
    assert len(ba._GRAPHS) == 2
    counts = {n: timer.count(n) for n in timer.samples}
    assert counts == {"pose_optimize": 4, "pose_optimize.capture": 2,
                      "pose_optimize.replay": 4}
    for name in GRAPH_SPANS:
        assert dict(timer.parents[name]) == {"pose_optimize": counts[name]}


@pytest.mark.cuda
def test_a_capture_allocates_no_second_workspace(frame_calls, no_graphs):
    """The cuBLAS workspace of the capture's stream stays in the graph's
    private pool only: after a capture the allocated memory is the solve's
    op by op, plus the graph's static inputs and outputs (~30 KiB)."""
    args, cfg, sf = frame_calls[0]
    ba._lm_solve(TUM3, *args, cfg, sf)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = ba.pose_optimize(TUM3, *args, cfg, sf)
    _assert_same(got, ba._lm_solve(TUM3, *args, cfg, sf))
    del got
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - before) < 2**20


@pytest.mark.cuda
def test_a_call_inside_a_capture_runs_op_by_op(frame_calls, no_graphs):
    args, cfg, sf = frame_calls[1]
    static = tuple(a.clone() for a in args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ba._lm_solve(TUM3, *static, cfg, sf)
    torch.cuda.current_stream().wait_stream(side)
    timer = profiling.StageTimer()
    graph = torch.cuda.CUDAGraph()
    with profiling.installed(timer), torch.cuda.graph(graph):
        out = ba.pose_optimize(TUM3, *static, cfg, sf)
    assert not GRAPH_SPANS & set(timer.samples) and not ba._GRAPHS
    graph.replay()
    _assert_same(out, ba._lm_solve(TUM3, *args, cfg, sf))
