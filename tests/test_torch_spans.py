"""The spans of the port's per-frame path on the CPU (utils/profiling.py,
models/system.py PER_FRAME_SPANS).

A short QVGA `track_rgbd` run with the CRF and loop detection on (frames
0-2 of an orbit with a billboard: the map's first frame, a tracked frame
under `profiling.trace`, a keyframe), then a black frame that loses track
and relocalises, then three detections of keyframe 0 from the newest
keyframe, so that the consistency streak sends it to verification. Every
span lands under its documented parent; `track_step`'s sections cover its
body; the counts agree with the program's own counters. Outside a system
`track_step` records nothing; the timer opens a profiler annotation only
under an active profiler. The benchmark's readers of these spans, on a
hand-built record. Three QVGA pairs through `track_stereo` open the
stereo front end's two spans under `frontend`."""

import contextlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from lc_crf_slam_torch.config import MapConfig, ORBConfig, SLAMConfig
from lc_crf_slam_torch.geometry.camera import Pinhole
from lc_crf_slam_torch.models.frame import build_frame
from lc_crf_slam_torch.models.system import PER_FRAME_SPANS, SLAMSystem
from lc_crf_slam_torch.models.tracking import SECTIONS, track_step
from lc_crf_slam_torch.utils import profiling
from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QVGA = Pinhole(fx=268.0, fy=270.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
CFG = SLAMConfig(map=MapConfig(max_points=4096, max_features=512, max_keyframes=16),
                 orb=ORBConfig(max_keypoints=512))
# the spans the run must open: everything but a closure's
RUN_SPANS = {"track_rgbd", "upload", "frontend", "initialize_map", "track", *SECTIONS,
             "pose_optimize", "pose_consensus", "readback", "relocalize",
             "spawn_flow_dyn", "insert_kf", "mapping", "loop", "detect_loop",
             "verify_loop", "flow_evidence", "crf_step"}


def _counts(timer):
    return {name: timer.count(name) for name in timer.samples}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    world = SyntheticWorld(cam=QVGA, n_static=800, n_dynamic=0, n_frames=20, seed=5,
                           trajectory="orbit", billboard=True)
    frames = [world.frame(k, render=True) for k in range(4)]
    slam = SLAMSystem(QVGA, CFG, device="cpu")
    timer = slam.timer
    prof_dir = str(tmp_path_factory.mktemp("prof"))
    out = {"slam": slam, "next_frame": frames.pop()}
    for k, f in enumerate(frames):
        root_self = timer.self_s["track_rgbd"]
        with profiling.trace(prof_dir) if k == 1 else contextlib.nullcontext():
            slam.track_rgbd(f.image, f.depth_image, f.timestamp)
        if k:
            out.setdefault("root_self_s", []).append(timer.self_s["track_rgbd"] - root_self)
            out.setdefault("root_s", []).append(timer.samples["track_rgbd"][-1])
    with open(os.path.join(prof_dir, "trace.json")) as fh:
        out["trace"] = json.load(fh)
    out["after_frames"] = (_counts(timer), slam.n_crf_steps, len(slam.kf_log))
    # a black frame: tracking is lost and the map has two keyframes
    black = np.zeros_like(frames[0].image)
    slam.track_rgbd(black, np.zeros_like(frames[0].depth_image), frames[-1].timestamp + 0.1)
    out["black_status"] = slam.stats[-1]["status"]
    # keyframe 0 detected three times from the newest keyframe
    topk = CFG.loop.retrieval_topk
    cands = np.full((topk,), -1)
    cands[0] = 0
    groups = np.zeros((topk, CFG.map.max_keyframes), bool)
    groups[0, 0] = True
    kf = slam.kf_log[-1][1]
    with profiling.installed(timer), timer.stage("track_rgbd"), timer.stage("loop"):
        for _ in range(CFG.loop.consistency_needed):
            slam._try_close_loop(pre=(int(kf), True, cands, groups))
    return out


def test_every_span_under_its_documented_parent(run):
    timer = run["slam"].timer
    assert RUN_SPANS <= set(timer.samples), RUN_SPANS - set(timer.samples)
    for name, parents in timer.parents.items():
        assert set(parents) <= (PER_FRAME_SPANS.get(name) or {None}), (name, parents)
    assert run["black_status"] == 2
    assert run["slam"].n_verify_loops == timer.count("verify_loop") >= 1
    # each verification reads its verdict, each relocalisation its own
    assert timer.parents["readback"]["verify_loop"] == timer.count("verify_loop")
    assert timer.parents["readback"]["relocalize"] == timer.count("relocalize") == 1
    assert timer.parents["pose_optimize"]["relocalize"] > 0
    assert timer.parents["pose_optimize"]["verify_loop"] == 2 * timer.count("verify_loop")


def test_sections_cover_track_step_and_children_the_root(run):
    timer = run["slam"].timer
    assert tuple(n for n in timer.samples if n.startswith("track.")) == SECTIONS
    assert all(timer.count(n) == timer.count("track") for n in SECTIONS)
    sections = sum(sum(timer.samples[n]) for n in SECTIONS)
    assert sections >= 0.95 * sum(timer.samples["track"])
    assert timer.self_s["track"] <= 0.05 * sum(timer.samples["track"])
    # after the map's first frame, the root's children cover it
    assert sum(run["root_self_s"]) <= 0.05 * sum(run["root_s"])
    summary = timer.summary()
    assert summary["track.local_map"]["parents"] == {"track": timer.count("track")}
    assert summary["track"]["self_s"] == pytest.approx(timer.self_s["track"])
    report = timer.report()
    assert "track.local_map" in report and "self" in report.splitlines()[0]


def test_counts_match_the_programs_counters(run):
    counts, n_crf_steps, n_inserted = run["after_frames"]
    # consensus_hypotheses > 0: motion, fallback, final and the audit's polish
    assert CFG.pose_opt.consensus_hypotheses == 64
    assert counts["pose_optimize"] == 4 * counts["track"] == 4 * 2
    assert counts["pose_consensus"] == counts["track"]
    assert counts["crf_step"] == n_crf_steps == counts["track"]
    # every inserted keyframe (the map's first is made, not inserted) detects loops
    assert counts["loop"] == counts["insert_kf"] == counts["detect_loop"] == n_inserted >= 1
    # a frame's control scalars, and a keyframe's capacity check and detection fetch
    assert counts["readback"] == counts["track"] + 2 * counts["insert_kf"]
    assert counts["upload"] == 2 * counts["track_rgbd"] == 6


STEREO_SPANS = ("frontend.extract", "stereo_match")


@pytest.fixture(scope="module")
def stereo_run():
    """Three QVGA pairs through `track_stereo` (the map's first frame,
    then two tracked ones): the right eye is the left camera moved by the
    baseline bf / fx along its x axis."""
    world = SyntheticWorld(cam=QVGA, n_static=800, n_dynamic=0, n_frames=20, seed=5,
                           trajectory="orbit")
    shift = np.eye(4)
    shift[0, 3] = QVGA.bf / QVGA.fx
    slam = SLAMSystem(QVGA, CFG, device="cpu")
    for k in range(3):
        f = world.frame(k, render=True)
        right = world.frame(k, render=True, T_wc=world.gt_pose_twc(k) @ shift).image
        slam.track_stereo(f.image, right, f.timestamp)
    return slam


def test_stereo_spans_under_frontend_once_a_frame(run, stereo_run):
    """`frontend.extract` (both eyes' `build_frames`) and `stereo_match`
    (the row matches) run under `frontend`, once each a pair; every span
    of the stereo run lands under its documented parent; the RGB-D run
    opens neither."""
    timer = stereo_run.timer
    frames = timer.count("track_stereo")
    assert frames == timer.count("frontend") == 3
    for name in STEREO_SPANS:
        assert dict(timer.parents[name]) == {"frontend": frames}, name
    for name, parents in timer.parents.items():
        assert set(parents) <= (PER_FRAME_SPANS.get(name) or {None}), (name, parents)
    # the two spans cover the pair's front end
    inner = sum(sum(timer.samples[name]) for name in STEREO_SPANS)
    assert inner >= 0.9 * sum(timer.samples["frontend"])
    assert not set(STEREO_SPANS) & set(run["slam"].timer.samples)


def test_graph_spans_under_pose_optimize_and_none_on_the_cpu(run):
    """On a card each `pose_optimize` call replays its solve's CUDA graph
    (`pose_optimize.replay`), captured at a key's first call
    (`pose_optimize.capture`: tests/test_torch_pose_graph.py); on the CPU
    the solve runs op by op and opens neither."""
    graph_spans = {"pose_optimize.capture", "pose_optimize.replay"}
    assert all(PER_FRAME_SPANS[name] == {"pose_optimize"} for name in graph_spans)
    timer = run["slam"].timer
    assert timer.count("pose_optimize") >= 8
    assert not graph_spans & set(timer.samples)


def test_mapping_graph_spans_under_mapping_and_none_on_the_cpu(run):
    """On a card each `mapping_step` call replays the step's CUDA graph
    (`mapping.replay`), captured at a key's first call (`mapping.capture`:
    tests/test_torch_mapping_graph.py); on the CPU the step runs op by op
    and opens neither."""
    graph_spans = {"mapping.capture", "mapping.replay"}
    assert all(PER_FRAME_SPANS[name] == {"mapping"} for name in graph_spans)
    timer = run["slam"].timer
    assert timer.count("mapping") == run["slam"].n_mapping_steps >= 1
    assert not graph_spans & set(timer.samples)


def test_track_step_outside_a_system_records_nothing(run):
    slam = run["slam"]
    before = _counts(slam.timer)
    f = run["next_frame"]
    frame = build_frame(QVGA, CFG, torch.as_tensor(f.image, dtype=torch.float32),
                        torch.as_tensor(f.depth_image, dtype=torch.float32))
    ts, _, _ = track_step(CFG, QVGA, slam.map, slam.ts, frame, slam._sampler())
    assert ts.Tcw.shape == (4, 4)
    assert _counts(slam.timer) == before
    assert profiling._TIMER.get() is None


def test_trace_carries_the_stage_names(run):
    names = {e.get("name") for e in run["trace"]["traceEvents"]}
    assert {"track_rgbd", "track", "track.local_map", "pose_optimize", "crf_step"} <= names


def test_annotation_only_under_a_profiler(monkeypatch):
    opened = []
    real = profiling._autograd_profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", counting)
    timer = profiling.StageTimer()
    with timer.stage("a"), timer.stage("b"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timer.stage("a"):
            pass
    assert [n for n in opened if n in ("a", "b")] == ["a"]
    assert dict(timer.parents["b"]) == {"a": 1}
    assert dict(timer.parents["a"]) == {None: 2}


def test_span_and_sections_without_a_timer_do_nothing():
    assert profiling._TIMER.get() is None
    with profiling.span("x"), profiling.sections() as section:
        section("y")
    timer = profiling.StageTimer()
    with profiling.installed(timer):
        with profiling.span("x"), profiling.sections() as section:
            section("y")
            section("z")
    assert _counts(timer) == {"y": 1, "z": 1, "x": 1}
    assert dict(timer.parents["z"]) == {"x": 1}
    assert profiling._TIMER.get() is None


# ---- the benchmark's readers of these spans ---------------------------------

def _reader(name):
    path = os.path.join(REPO, "slam_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Record:
    """The fields of the harness's RunRecord the span readers read."""

    def __init__(self, spans, frames):
        self.spans, self.frame_ms = spans, [1000.0] * frames


def test_span_readers():
    spans = {"pose_optimize": (40, 0.30), "pose_consensus": (10, 0.05),
             "spawn_flow_dyn": (2, 0.02), "flow_evidence": (10, 0.10), "crf_step": (10, 0.08),
             "loop": (2, 0.04), "insert_kf": (2, 0.06), "readback": (14, 0.007)}
    run = _Record(spans, 10)
    assert _reader("pose_opt_ms")(run) == pytest.approx(35.0)
    assert _reader("crf_ms")(run) == pytest.approx(20.0)
    assert _reader("loop_ms")(run) == pytest.approx(20.0)
    assert _reader("readback_ms")(run) == pytest.approx(0.7)
    # a program without these spans (the CRF off; an older program) reads nothing
    static = _Record({k: v for k, v in spans.items()
                      if k not in ("spawn_flow_dyn", "flow_evidence", "crf_step")}, 10)
    assert _reader("crf_ms")(static) is None
    bare = _Record({"track": (10, 9.0), "insert_kf": (2, 0.5)}, 10)
    for name in ("pose_opt_ms", "crf_ms", "loop_ms", "readback_ms", "pose_graph.replay_share",
                 "mapping_graph.replay_share"):
        assert _reader(name)(bare) is None
    # on a card the graph's spans run inside `pose_optimize`'s: not counted twice
    graphed = _Record({**spans, "pose_optimize.replay": (40, 0.02)}, 10)
    assert _reader("pose_opt_ms")(graphed) == pytest.approx(35.0)



def test_stereo_span_readers():
    spans = {"frontend": (10, 0.30), "frontend.extract": (10, 0.25),
             "stereo_match": (10, 0.02), "track": (9, 0.5)}
    run = _Record(spans, 10)
    assert _reader("stereo_extract_ms")(run) == pytest.approx(25.0)
    assert _reader("stereo_match_ms")(run) == pytest.approx(2.0)
    # an RGB-D run, or a program without the stereo spans, reads nothing
    rgbd = _Record({k: v for k, v in spans.items() if k not in STEREO_SPANS}, 10)
    for name in ("stereo_extract_ms", "stereo_match_ms"):
        assert _reader(name)(rgbd) is None
