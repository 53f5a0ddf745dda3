"""Entry `track_stereo`: one rectified stereo pair a hand-in, to
`SLAMSystem.track_stereo(left, right, t)` as host numpy arrays (both
uploads are on the timed path, as for a camera driver's pairs); the
hand-in ends once the returned `Tcw` is on the host.

The comparison holds the pair's left eye to the plain front end: the
program's `build_frames` has to make a pair's left Frame in the call the
benchmark's frame tap sees (its right eye as `grays_right`). A program
without that cannot be judged here, and the run stops at once."""

from __future__ import annotations

import inspect
from typing import List

PARAMS: dict = {}
FPS = 20.0      # the rig's frame rate (EuRoC's cameras)


def _check_program() -> None:
    from lc_crf_slam_torch.models import frame

    if "grays_right" not in inspect.signature(frame.build_frames).parameters:
        raise RuntimeError("track_stereo: the program's build_frames takes no right eye, "
                           "so a pair's front end is not what the frame tap keeps")


_check_program()


def render(world, k: int) -> tuple:
    """Session pair k as the rig hands it: (left, depth [m], t, right).
    The left eye's true depth stays in place 1, where the benchmark's
    plain front end reads an RGB-D frame's; the program never sees it."""
    f = world.frame(k, render=True)
    return f.image, f.depth_image, k / FPS, world.right_eye(k)


def steps(n: int, params: dict) -> List[List[int]]:
    return [[k] for k in range(n)]


def hand_in(slam, frames: List[tuple], ks: List[int], params: dict):
    """([Tcw on the host], [tracking status]) of the hand-in's pair."""
    left, _, ts, right = frames[ks[0]]
    Tcw = slam.track_stereo(left, right, ts).cpu().numpy()
    return [Tcw], [int(slam.stats[-1].get("status", 1))]
