"""Local mapping as a CUDA graph (models/mapping.py `mapping_step`).

On the CPU: the step runs op by op and opens neither graph span, the
placeholders of the fields it never reads change nothing, the card's
state graph (with a rerun of the step in place of the graph) hands out
its own map while every map it returned keeps its values, the cache key
separates what a capture bakes in, and the benchmark's reader of the
replay share reads the spans. On the card (`cuda`-marked, skipped without
one): the first two keyframes' mapping steps of `chip_smoke.py`'s walking
world, replayed, give the step op by op bit for bit in every field of the
map (local BA sums 32 x 1024 edges there: the segment sum's look-back
path, which the second replay runs again from its zeroed scratch); a
capture reads nothing back and adds no cuBLAS workspace to the allocated
memory, and the card holds one map; a call made while a stream is
capturing runs op by op.

This file imports neither jax nor the JAX package, so its card tests run
where jax is not installed (without tests/conftest.py, which imports it):

    python3 -m pytest --noconftest -q tests/test_torch_mapping_graph.py
"""

import dataclasses
import importlib.util
import os

import pytest
import torch

from lc_crf_slam_torch.config import (CRFConfig, LocalBAConfig, LoopConfig, MapConfig,
                                      MappingConfig, MatcherConfig, ORBConfig, SLAMConfig)
from lc_crf_slam_torch.geometry.camera import TUM3, Pinhole
from lc_crf_slam_torch.models import mapping, system
from lc_crf_slam_torch.models.capacities import BA_CAMS
from lc_crf_slam_torch.models.mapstate import MapState, empty_map
from lc_crf_slam_torch.ops import segment_sum
from lc_crf_slam_torch.utils import cuda_graph, profiling
from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_SPANS = {"mapping.capture", "mapping.replay"}
QVGA = Pinhole(fx=268.0, fy=270.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
SMALL = SLAMConfig(map=MapConfig(max_points=4096, max_features=512, max_keyframes=16),
                   orb=ORBConfig(max_keypoints=512))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _assert_same(got: MapState, want: MapState, skip=()) -> None:
    for field, a, b in zip(MapState._fields, got, want):
        if field not in skip:
            assert _same_bits(a, b), field


def _record_mapping_calls(slam, frames, n_calls):
    """Hand `frames` (SyntheticWorld frames) to `slam.track_rgbd` until
    `n_calls` mapping steps have run; returns each step's (map, keyframe
    index), copied, with the step itself run op by op."""
    calls = []

    def recording(cfg, cam, m, kf_idx):
        calls.append((MapState(*(t.clone() for t in m)), kf_idx.clone()))
        return mapping._mapping_step(cfg, cam, m, kf_idx)

    real = system.mapping_step
    system.mapping_step = recording
    try:
        for f in frames:
            slam.track_rgbd(f.image, f.depth_image, f.timestamp)
            if len(calls) >= n_calls:
                break
    finally:
        system.mapping_step = real
    assert len(calls) == n_calls
    return calls


# ---- on the CPU ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_call():
    """The first mapping step of a short QVGA orbit with a billboard (the
    world of tests/test_torch_spans.py), its inputs copied."""
    torch.set_num_threads(2)
    world = SyntheticWorld(cam=QVGA, n_static=800, n_dynamic=0, n_frames=20, seed=5,
                           trajectory="orbit", billboard=True)
    slam = system.SLAMSystem(QVGA, SMALL, device="cpu")
    frames = (world.frame(k, render=True) for k in range(20))
    return _record_mapping_calls(slam, frames, 1)[0]


def test_cpu_step_is_eager_and_opens_no_graph_span(cpu_call):
    m, kf = cpu_call
    graphs = dict(mapping._GRAPHS)
    timer = profiling.StageTimer()
    with profiling.installed(timer):
        got = mapping.mapping_step(SMALL, QVGA, m, kf)
    assert not set(timer.samples)
    assert mapping._GRAPHS == graphs
    _assert_same(got, mapping._mapping_step(SMALL, QVGA, m, kf))
    assert not torch.equal(got.p_alive, m.p_alive)        # it culled


def test_the_fields_a_capture_leaves_out_are_never_read(cpu_call):
    """A capture copies in only the fields the step reads: with the
    others as meta placeholders the step gives the same map, and passes
    the placeholders through untouched."""
    m, kf = cpu_call
    static = MapState(*(torch.empty(t.shape, dtype=t.dtype, device="meta")
                        if i in mapping._UNREAD_AT else t for i, t in enumerate(m)))
    assert {n for n, t in zip(MapState._fields, static) if t.is_meta} == mapping._UNREAD
    got = mapping._mapping_step(SMALL, QVGA, static, kf)
    _assert_same(got, mapping._mapping_step(SMALL, QVGA, m, kf), skip=mapping._UNREAD)
    for name in mapping._UNREAD:
        assert getattr(got, name) is getattr(static, name)
    assert not any(t.is_meta for n, t in zip(MapState._fields, got)
                   if n not in mapping._UNREAD)


def test_graph_key_separates_what_a_capture_bakes_in():
    cfg = SLAMConfig(map=MapConfig(max_points=4096, max_features=1024, max_keyframes=16))
    m = empty_map(cfg, torch.device("cpu"))
    kf = torch.zeros((), dtype=torch.int32)
    key = mapping._graph_key(cfg, TUM3, m, kf)
    other_map = empty_map(cfg, torch.device("cpu"))
    assert key == mapping._graph_key(cfg, TUM3, other_map, kf.clone() + 3)
    wide = dataclasses.replace(cfg, map=MapConfig(max_points=4096, max_features=1200,
                                                  max_keyframes=16))
    others = [
        mapping._graph_key(cfg, TUM3._replace(fx=500.0), m, kf),                 # camera
        mapping._graph_key(cfg, TUM3._replace(bf=20.0), m, kf),
        mapping._graph_key(dataclasses.replace(
            cfg, mapping=MappingConfig(fuse_reverse_neighbors=1)), TUM3, m, kf),
        mapping._graph_key(dataclasses.replace(
            cfg, local_ba=LocalBAConfig(outer_iters_2=5)), TUM3, m, kf),
        mapping._graph_key(dataclasses.replace(
            cfg, matcher=MatcherConfig(th_low=40)), TUM3, m, kf),
        mapping._graph_key(dataclasses.replace(
            cfg, orb=ORBConfig(scale_factor=1.25)), TUM3, m, kf),
        mapping._graph_key(dataclasses.replace(cfg, orb=ORBConfig(n_levels=6)), TUM3, m, kf),
        mapping._graph_key(dataclasses.replace(
            cfg, crf=CRFConfig(enabled=not cfg.crf.enabled)), TUM3, m, kf),
        mapping._graph_key(dataclasses.replace(
            cfg, crf=CRFConfig(dynamic_threshold=0.6)), TUM3, m, kf),
        mapping._graph_key(wide, TUM3, empty_map(wide, torch.device("cpu")), kf),  # 1200
        mapping._graph_key(cfg, TUM3, m, kf.long()),                             # index dtype
    ]
    assert len({key, *others}) == 1 + len(others)
    # a setting the step does not read does not take a key of its own
    assert key == mapping._graph_key(
        dataclasses.replace(cfg, loop=LoopConfig(enabled=False)), TUM3, m, kf)


def test_the_float_settings_are_part_of_what_a_replay_looks_up():
    """A capture keeps its kernels' float settings (a TF32 matmul stays
    one), so `utils/cuda_graph.replay` looks a graph up by them too."""
    before = cuda_graph.precision()
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = cuda_graph.precision()
    finally:
        torch.set_float32_matmul_precision(before[0])
    assert tf32 != before and cuda_graph.precision() == before


class _Rerun:
    """A stand-in for a captured graph on the CPU: its replay runs the
    captured step again, over the same static buffers."""

    def __init__(self, run):
        self.replay = run


def _rerun_capture(run, device):
    run()
    return _Rerun(run), None


def test_the_state_graph_holds_the_map_once_and_every_returned_map_keeps_its_values(
        cpu_call, monkeypatch):
    """`utils/cuda_graph.replay_state`, the card's path of `mapping_step`,
    with its graph stood in for by a rerun of the step: the map it returns
    is the graph's own buffers (the unread fields the caller's), equal to
    the step op by op; a map handed back in copies nothing in for the
    fields it did not change; the maps of earlier calls and the caller's
    keep their values as later calls overwrite the buffers; a view of a
    returned field held across a call that would overwrite it raises; a
    map made elsewhere moves into the buffers at once (`hand_in`)."""
    monkeypatch.setattr(cuda_graph, "capture", _rerun_capture)
    m, kf = cpu_call
    graphs = {}

    def call(state):
        return cuda_graph.replay_state(
            graphs, "k", "mapping", lambda *t: mapping._mapping_step(
                SMALL, QVGA, MapState(*t[:-1]), t[-1]), (*state, kf),
            unread=mapping._UNREAD_AT)

    kept_m = MapState(*(t.clone() for t in m))
    first = call(m)
    _assert_same(first, mapping._mapping_step(SMALL, QVGA, m, kf))
    _assert_same(m, kept_m)
    (step,) = graphs.values()
    for i, name in enumerate(MapState._fields):
        if name in mapping._UNREAD:
            assert getattr(first, name) is getattr(m, name)
        else:
            assert getattr(first, name).data_ptr() == step.bufs[i].data_ptr(), name
    kept_first = MapState(*(t.clone() for t in first))
    second = call(first)
    _assert_same(second, mapping._mapping_step(SMALL, QVGA, kept_first, kf))
    _assert_same(first, kept_first)
    for i, name in enumerate(MapState._fields):
        if name in mapping._UNREAD:
            continue
        if i in step.written:
            assert getattr(first, name).data_ptr() != step.bufs[i].data_ptr(), name
        else:
            assert getattr(second, name) is getattr(first, name), name
    assert MapState._fields.index("kf_obs") in step.written
    assert MapState._fields.index("kf_desc") not in step.written
    view = second.kf_obs[0]
    with pytest.raises(RuntimeError, match="view"):
        call(second)
    del view
    kept_second = MapState(*(t.clone() for t in second))
    third = call(second)
    _assert_same(third, mapping._mapping_step(SMALL, QVGA, kept_second, kf))
    _assert_same(second, kept_second)
    # a map made elsewhere (a new session's) moves into the buffers at once
    kept_third = MapState(*(t.clone() for t in third))
    new = cuda_graph.hand_in(graphs, "k", "mapping", (*m, kf))
    _assert_same(new, m)
    _assert_same(third, kept_third)
    for i, name in enumerate(MapState._fields):
        if name not in mapping._UNREAD:
            assert getattr(new, name).data_ptr() == step.bufs[i].data_ptr(), name
    assert cuda_graph.hand_in(graphs, "another key", "mapping", (*m, kf)) is None
    assert mapping.adopt(SMALL, QVGA, m, kf) is m          # the CPU keeps no graph


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
    read = _reader("mapping_graph.replay_share")
    # the window's steps all replayed (the capture ran in the warm-up)
    assert read(_Record({"mapping": (4, 0.02), "mapping.capture": (0, 0.0),
                         "mapping.replay": (4, 0.01)})) == 100.0
    assert read(_Record({"mapping": (4, 0.5), "mapping.capture": (1, 0.4),
                         "mapping.replay": (1, 0.01)})) == 25.0
    # a graph that exists but did not run in the window
    assert read(_Record({"mapping": (2, 0.4), "mapping.capture": (0, 0.0)})) == 0.0
    # no keyframe in the window; a program without the graph (the bare record)
    assert read(_Record({"mapping": (0, 0.0), "mapping.replay": (0, 0.0)})) is None
    assert read(_Record({"mapping.replay": (0, 0.0), "track": (10, 1.0)})) is None
    assert read(_Record({"mapping": (3, 0.6), "insert_kf": (3, 0.02)})) is None


# ---- on the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def keyframe_calls():
    """The first two `mapping_step` calls (keyframes) on `chip_smoke.py`'s
    walking world (TUM3 at 640x480, 1400 points, the billboard), with the
    default capacities, as (map, keyframe index) copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from lc_crf_slam_torch.kernels import build

    build.build_all()
    for name in build.kernel_names():
        build.load(name)
    world = SyntheticWorld(cam=TUM3, n_frames=60, n_static=1400, n_dynamic=0, seed=7,
                           trajectory="line", billboard=True, bb_speed=0.04)
    slam = system.SLAMSystem(TUM3, SLAMConfig(loop=LoopConfig(enabled=False)), device="cuda")
    calls = _record_mapping_calls(slam, (world.frame(k, render=True) for k in range(60)), 2)
    torch.cuda.synchronize()
    return calls


CFG = SLAMConfig(loop=LoopConfig(enabled=False))


@pytest.fixture
def no_graphs(monkeypatch):
    monkeypatch.setattr(mapping, "_GRAPHS", {})


@pytest.mark.cuda
def test_replay_equals_the_step_op_by_op(keyframe_calls, no_graphs):
    (m1, kf1), (m2, kf2) = keyframe_calls
    assert BA_CAMS * m1.kf_obs.shape[1] > segment_sum.SMALL_EDGES   # local BA's look-back path
    before = segment_sum.launches()
    mapping._mapping_step(CFG, TUM3, m1, kf1)
    per_step = segment_sum.launches() - before       # the sums of one step, counted on the card
    timer = profiling.StageTimer()
    with profiling.installed(timer):
        first = mapping.mapping_step(CFG, TUM3, m1, kf1)
        kept = MapState(*(t.clone() for t in first))
        second = mapping.mapping_step(CFG, TUM3, m2, kf2)
    assert len(mapping._GRAPHS) == 1
    # the eager run before the capture and the two replays launch the sums
    assert per_step > 0
    assert segment_sum.launches() - before == 4 * per_step
    assert {n: timer.count(n) for n in timer.samples} == {"mapping.capture": 1,
                                                          "mapping.replay": 2}
    torch.cuda.synchronize()
    _assert_same(first, mapping._mapping_step(CFG, TUM3, m1, kf1))
    _assert_same(second, mapping._mapping_step(CFG, TUM3, m2, kf2))
    # a call's map outlives the next replay; the fields the step never
    # reads are the caller's own, the others the graph's buffers
    _assert_same(first, kept)
    (step,) = mapping._GRAPHS.values()
    for i, name in enumerate(MapState._fields):
        if name in mapping._UNREAD:
            assert getattr(second, name) is getattr(m2, name), name
        else:
            assert getattr(second, name).data_ptr() == step.bufs[i].data_ptr(), name
    assert not torch.equal(first.kf_obs, m1.kf_obs) and not torch.equal(second.kf_obs, m2.kf_obs)


@pytest.mark.cuda
def test_a_capture_reads_nothing_back(keyframe_calls, no_graphs):
    m, kf = keyframe_calls[1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mapping.mapping_step(CFG, TUM3, m, kf)
        again = mapping.mapping_step(CFG, TUM3, m, kf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_same(got, mapping._mapping_step(CFG, TUM3, m, kf))
    _assert_same(again, got)


def _storage_bytes(tensors) -> int:
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if t is not None and not t.is_meta}
    return sum(storages.values())


@pytest.mark.cuda
def test_the_card_holds_one_map_and_no_second_workspace(keyframe_calls, no_graphs):
    """After a capture the allocated memory grows by the graph's map alone
    (~21 MB at these capacities), not by a copy of its outputs beside it,
    nor by the 32 MiB of the capture stream's cuBLAS workspace, which
    stays in the graph's private pool; the map a call returns is that
    map, and handing it back in for the next call adds nothing, nor does
    a new session's map handed in (`mapping.adopt`)."""
    m, kf = keyframe_calls[0]
    mapping._mapping_step(CFG, TUM3, m, kf)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = mapping.mapping_step(CFG, TUM3, m, kf)
    _assert_same(got, mapping._mapping_step(CFG, TUM3, m, kf))
    (step,) = mapping._GRAPHS.values()
    graph_bytes = _storage_bytes(step.bufs)
    assert graph_bytes > 20 * 2**20
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - before - graph_bytes) < 2**20
    got = mapping.mapping_step(CFG, TUM3, got, kf)
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - before - graph_bytes) < 2**20
    # a new session's map moves into the graph's buffers: only the fields
    # the step never reads stay the map's own
    got = mapping.adopt(CFG, TUM3, MapState(*(t.clone() for t in m)), kf)
    _assert_same(got, m)
    own = _storage_bytes(getattr(got, name) for name in mapping._UNREAD)
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - before - graph_bytes - own) < 2**20


@pytest.mark.cuda
def test_a_call_inside_a_capture_runs_op_by_op(keyframe_calls, no_graphs):
    m, kf = keyframe_calls[0]
    static, static_idx = MapState(*(t.clone() for t in m)), kf.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mapping._mapping_step(CFG, TUM3, static, static_idx)
    torch.cuda.current_stream().wait_stream(side)
    timer = profiling.StageTimer()
    graph = torch.cuda.CUDAGraph()
    with profiling.installed(timer), torch.cuda.graph(graph):
        out = mapping.mapping_step(CFG, TUM3, static, static_idx)
    assert not GRAPH_SPANS & set(timer.samples) and not mapping._GRAPHS
    graph.replay()
    _assert_same(out, mapping._mapping_step(CFG, TUM3, m, kf))


@pytest.mark.cuda
def test_a_change_of_float_settings_captures_anew(keyframe_calls, no_graphs):
    """Under TF32 matmuls (the benchmark's control enters them after its
    warm-up has captured) the step takes a graph of its own, and the graph
    of float32 is replayed again once they are back."""
    m, kf = keyframe_calls[0]
    want = mapping.mapping_step(CFG, TUM3, m, kf)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        mapping.mapping_step(CFG, TUM3, m, kf)
    finally:
        torch.set_float32_matmul_precision(before)
    assert len(mapping._GRAPHS) == 2
    _assert_same(mapping.mapping_step(CFG, TUM3, m, kf), want)
    assert len(mapping._GRAPHS) == 2
