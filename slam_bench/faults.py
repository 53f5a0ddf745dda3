"""Variants of a run that `correct` has to catch: the control (the program
with TF32, the precision below the float32 its configuration states) and
faults planted in the timed path. The benchmark's own runs use none of
them; `calibrate.py` reads the numbers they give on the chip, and the
tests under `tests/` see `correct` come out false under each.

Each variant is a function of the built system that returns a context
manager, entered for the window.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict


@contextlib.contextmanager
def patched(module_path: str, name: str, wrap: Callable):
    """`module_path.name` is `wrap(original)` inside the block."""
    mod = importlib.import_module(module_path)
    original = getattr(mod, name)
    setattr(mod, name, wrap(original))
    try:
        yield
    finally:
        setattr(mod, name, original)


@contextlib.contextmanager
def tf32(slam):
    """The control: every float32 matrix product of the program in TF32."""
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])


def stale_state(slam):
    """A step that returns its state unchanged: tracking hands back the
    tracker state it was given (the pose never moves)."""
    return patched("lc_crf_slam_torch.models.system", "track_step",
                   lambda f: lambda cfg, cam, m, ts, *a, **k: (ts, *f(cfg, cam, m, ts, *a, **k)[1:]))


def _frame_fault(change):
    def variant(slam):
        return patched("lc_crf_slam_torch.models.system", "build_frame",
                       lambda f: lambda *a, **k: change(f(*a, **k)))
    return variant


def _half(frame):
    import torch

    keep = torch.arange(frame.valid.shape[0], device=frame.valid.device) % 2 == 0
    return frame._replace(valid=frame.valid & keep)


def _flip_bit(frame):
    desc = frame.desc.clone()
    desc[:, 0] ^= 1
    return frame._replace(desc=desc)


def _deeper(frame, every: int = 1, scale: float = 1.05):
    """Every `every`-th keypoint's depth `scale` times as long."""
    import torch

    pick = torch.arange(frame.depth.shape[0], device=frame.depth.device) % every == 0
    has = (frame.depth > 0) & pick
    depth = torch.where(pick, frame.depth * scale, frame.depth)
    bf = (frame.uv[:, 0] - frame.u_right) * frame.depth    # the camera's baseline * fx
    return frame._replace(depth=depth, u_right=torch.where(
        has, frame.uv[:, 0] - bf / torch.where(has, depth, 1.0), frame.u_right))


# half of the batch left out: every second keypoint of each frame dropped
half_batch = _frame_fault(_half)
# an answer altered where it is produced: one bit of every descriptor
altered_answer = _frame_fault(_flip_bit)
# an answer altered where it is produced: every keypoint's depth 5% long
# (a depth scale off as by a wrong depth factor)
depth_scaled = _frame_fault(_deeper)
# a part of the map misplaced: every third keypoint's depth 10% long, so
# the points made from them lie 10% deep and the rest where they belong
depth_third = _frame_fault(lambda f: _deeper(f, every=3, scale=1.10))


@contextlib.contextmanager
def _flag_off(slam, attr: str):
    before = getattr(slam, attr)
    setattr(slam, attr, False)
    try:
        yield
    finally:
        setattr(slam, attr, before)


def crf_off(slam):
    """The CRF and its flow evidence never run."""
    return _flag_off(slam, "enable_crf")


def crf_stale(slam):
    """A step that returns its state unchanged: the CRF runs and hands
    back the map it was given, its labels dropped."""
    return patched("lc_crf_slam_torch.models.system", "crf_step",
                   lambda f: lambda cfg, m, *a, **k: (m, f(cfg, m, *a, **k)[1]))


@contextlib.contextmanager
def crf_shuffled(slam):
    """An answer altered where it is produced: after each CRF step the
    labels of the live points are handed to other live points."""
    import torch

    gen = torch.Generator(device=slam.device)
    gen.manual_seed(0)

    def wrap(f):
        def step(cfg, m, *a, **k):
            m, info = f(cfg, m, *a, **k)
            alive = torch.nonzero(m.p_alive).squeeze(1)
            perm = alive[torch.randperm(alive.shape[0], generator=gen, device=alive.device)]
            p_dyn = m.p_dyn.clone()
            p_dyn[alive] = m.p_dyn[perm]
            return m._replace(p_dyn=p_dyn), info
        return step

    with patched("lc_crf_slam_torch.models.system", "crf_step", wrap):
        yield


def flow_off(slam):
    """The flow evidence hands back the map it was given (LK never feeds
    the CRF)."""
    return patched("lc_crf_slam_torch.models.system", "flow_evidence",
                   lambda f: lambda cfg, cam, m, *a, **k: m)


def loop_off(slam):
    """Loop detection never runs on a new keyframe."""
    return _flag_off(slam, "enable_loop")


VARIANTS: Dict[str, Callable] = {
    "tf32": tf32, "stale_state": stale_state, "half_batch": half_batch,
    "altered_answer": altered_answer, "depth_scaled": depth_scaled,
    "depth_third": depth_third, "crf_off": crf_off, "crf_stale": crf_stale, "crf_shuffled": crf_shuffled,
    "flow_off": flow_off, "loop_off": loop_off,
}
