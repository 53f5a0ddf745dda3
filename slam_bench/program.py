"""The one module of the benchmark that touches the program under test,
`lc_crf_slam_torch`: it builds the system from a configuration's
settings, loads the CUDA kernels, and reads what the timed path produced
(the front end's output on chosen frames, the live map, the spans of
`slam.timer`) without changing it. Nothing is imported before a run asks
for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np


def slam_config(settings: Dict[str, object]):
    """The program's `SLAMConfig` from flat `section.key` settings."""
    from lc_crf_slam_torch.config import SLAMConfig

    cfg = SLAMConfig()
    sections: Dict[str, dict] = {}
    for key, val in settings.items():
        sec, name = key.split(".", 1)
        sections.setdefault(sec, {})[name] = val
    return cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kv)
                          for sec, kv in sections.items()})


def camera(cam: Dict[str, float]):
    """The program's `Pinhole` from the configuration's camera."""
    from lc_crf_slam_torch.geometry.camera import Pinhole

    return Pinhole(**cam)


def load_kernels() -> None:
    """Build (the first run of a checkout only: into its build/) and load
    every CUDA kernel of the program."""
    from lc_crf_slam_torch.kernels import build

    build.build_all()
    for name in build.kernel_names():
        build.load(name)


def make_system(cam: Dict[str, float], settings: Dict[str, object], device: str):
    from lc_crf_slam_torch.models.system import SLAMSystem

    return SLAMSystem(camera(cam), slam_config(settings), device=device)


class FrameTap:
    """Keeps the front end's output (`build_frame` and `build_frames`, as
    the entries call them) on the session frames in `frames`, for the
    first session and the newest one: the references stay on the device
    until the window has closed, so nothing is copied or synchronised
    inside it. A hand-in's frames are those `next_step` names: one for
    `build_frame`, as many as the batch for `build_frames` (the single
    frame a chunk's relocalisation builds again is not kept)."""

    def __init__(self, frames):
        self.frames = set(frames)
        self.session = 0
        self.ks: List[int] = []
        self.kept: Dict[int, Dict[int, object]] = {}

    def next_step(self, session: int, ks: List[int]) -> None:
        if session != self.session and self.session != 0:
            self.kept.pop(self.session, None)
        self.session, self.ks = session, list(ks)

    def _keep(self, ks, frames) -> None:
        for k, frame in zip(ks, frames):
            if k in self.frames:
                self.kept.setdefault(self.session, {})[k] = frame

    @contextlib.contextmanager
    def installed(self) -> Iterator[None]:
        from lc_crf_slam_torch.models import system

        one, many = system.build_frame, system.build_frames

        def tapped_one(*args, **kwargs):
            frame = one(*args, **kwargs)
            if len(self.ks) == 1:
                self._keep(self.ks, [frame])
            return frame

        def tapped_many(*args, **kwargs):
            frames = many(*args, **kwargs)
            if len(frames) == len(self.ks):
                self._keep(self.ks, frames)
            return frames

        system.build_frame, system.build_frames = tapped_one, tapped_many
        try:
            yield
        finally:
            system.build_frame, system.build_frames = one, many

    def to_host(self) -> list:
        """[(session frame index, {uv, level, desc, valid} numpy)]."""
        out = []
        for session in sorted(self.kept):
            for k, f in sorted(self.kept[session].items()):
                out.append((k, {"uv": f.uv.cpu().numpy(), "level": f.level.cpu().numpy(),
                                "desc": f.desc.cpu().numpy(),
                                "valid": f.valid.cpu().numpy()}))
        return out


def counters(slam) -> Tuple[int, int, int, bool]:
    """(keyframes inserted, loop detections, CRF steps) of the session so
    far, and whether the map is initialised: the program's own counts,
    read on the host."""
    return len(slam.kf_log), slam.n_detect_loops, slam.n_crf_steps, slam.initialized


def map_snapshot(slam) -> dict:
    """Device copies of the map's positions, liveness, P(dynamic), frames
    in view and high-water mark (dead slots below it keep their last
    position and label until reused), and its keyframe count: queued on
    the stream, read after the window."""
    m = slam.map
    return {"p_xyz": m.p_xyz.clone(), "p_alive": m.p_alive.clone(),
            "p_dyn": m.p_dyn.clone(), "p_visible": m.p_visible.clone(),
            "n_points": m.n_points.clone(), "n_kfs": m.n_kfs.clone()}


def snapshot_to_host(snap: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in snap.items()}


class AnnotatingTimer:
    """Stands in for `slam.timer` during a profiled slice: each stage runs
    in the program's own timer and, around it, a profiler annotation of
    the stage's name."""

    def __init__(self, timer):
        self.timer = timer

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        from torch.profiler import record_function

        with record_function(name), self.timer.stage(name):
            yield


def span_totals(timer) -> Dict[str, tuple]:
    """{stage: (calls, seconds)} of `slam.timer` so far."""
    return {name: (len(xs), float(np.sum(xs))) for name, xs in timer.samples.items()}


def dynamic_threshold(slam) -> float:
    return float(slam.cfg.crf.dynamic_threshold)
