"""Entry `track_rgbd`: one RGB-D frame a hand-in, to
`SLAMSystem.track_rgbd(gray, depth, t)` as host numpy arrays (the upload
is on the timed path, as for a camera driver's frames); the hand-in ends
once the returned `Tcw` is on the host."""

from __future__ import annotations

from typing import List

PARAMS: dict = {}


def render(world, k: int) -> tuple:
    """Session frame k as the camera hands it: (gray, depth [m], t)."""
    f = world.frame(k, render=True)
    return f.image, f.depth_image, f.timestamp


def steps(n: int, params: dict) -> List[List[int]]:
    return [[k] for k in range(n)]


def hand_in(slam, frames: List[tuple], ks: List[int], params: dict):
    """([Tcw on the host], [tracking status]) of the hand-in's frame."""
    gray, depth, ts = frames[ks[0]]
    Tcw = slam.track_rgbd(gray, depth, ts).cpu().numpy()
    return [Tcw], [int(slam.stats[-1].get("status", 1))]
