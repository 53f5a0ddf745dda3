"""Entry `track_sequence`: a session's first frame to
`SLAMSystem.track_rgbd` (as `track_sequence` itself hands it on an empty
map), then chunks of `chunk` RGB-D frames to
`SLAMSystem.track_sequence(grays, depths, timestamps, chunk)` as host
numpy stacks; a hand-in ends once the chunk's poses are on the host
(the call returns them there). Each frame of a chunk counts the chunk's
time as its latency: its pose reaches the host with the chunk's."""

from __future__ import annotations

from typing import List

import numpy as np

from slam_bench.entries.track_rgbd import render  # noqa: F401  (the same frames)

PARAMS = {"chunk": int}


def steps(n: int, params: dict) -> List[List[int]]:
    c = params["chunk"]
    return [[0]] + [list(range(a, min(a + c, n))) for a in range(1, n, c)]


def hand_in(slam, frames: List[tuple], ks: List[int], params: dict):
    """([Tcw on the host] a frame, [tracking status] a frame). The chunk
    path records its lost frames as a count a chunk, so the statuses
    carry the count, not which frames it was."""
    if len(ks) == 1 and not slam.initialized:
        gray, depth, ts = frames[ks[0]]
        Tcw = slam.track_rgbd(gray, depth, ts).cpu().numpy()
        return [Tcw], [1]
    n_stats = len(slam.stats)
    poses = slam.track_sequence(np.stack([frames[k][0] for k in ks]),
                                np.stack([frames[k][1] for k in ks]),
                                np.array([frames[k][2] for k in ks]), chunk=len(ks))
    lost = sum(r.get("lost_frames", 0) for r in slam.stats[n_stats:]
               if r.get("event") == "chunk_lost")
    return list(poses), [2] * lost + [1] * (len(ks) - lost)
