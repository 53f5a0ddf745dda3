"""State converters between the JAX reference and the port.

The system has no learned weights; its state is the map, the tracking
state and the frame. These helpers turn a reference `MapState` /
`TrackState` / `Frame` / `BAProblem` / `LoopCandidate` / `LoopVerification` /
`PoseGraph` / `Sim3Graph` / `MonoInit` (any NamedTuple of arrays, read
with `np.asarray`; a map state at any point of the pipeline, mapping
included) into the port's tensors, and a port state back into numpy
arrays, so a test can run the reference for a few frames, continue in
the port, and compare the next step array by array. Descriptor words
(uint32 in the reference) become int32 bit-views and back; bool and
int32 stay as they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._ops import i32_to_u32, u32_to_i32
from .models.frame import Frame
from .models.initializer import MonoInit
from .models.loopclosing import LoopCandidate, LoopVerification
from .models.mapstate import MapState
from .models.posegraph import PoseGraph, Sim3Graph
from .models.tracking import TrackState
from .ops.schur import BAProblem


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = u32_to_i32(a)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(state, cls, device):
    return cls(**{f: _to_tensor(getattr(state, f), device) for f in cls._fields})


def map_to_torch(m, device: str | torch.device = "cpu") -> MapState:
    """A reference map in the port's dtypes: as the reference's, but
    `kf_time` float64 (the reference keeps float32 seconds)."""
    out = _convert(m, MapState, device)
    return out._replace(kf_time=out.kf_time.to(torch.float64))


def map_from_slots(cfg, arrays: Dict[str, np.ndarray],
                   device: str | torch.device = "cpu") -> MapState:
    """A map of cfg's capacities from {field: array} (the reference's
    dtypes or the port's), each array filling the leading slots of its
    field: a field cut to the used keyframe or point slots, or left out,
    keeps the rest as `empty_map` makes it."""
    from .models.mapstate import empty_map

    out = empty_map(cfg, torch.device(device))._asdict()
    for f, a in arrays.items():
        a = _to_tensor(a, device).to(out[f].dtype)
        if out[f].dim() == 0:
            out[f] = a.reshape(())
        else:
            out[f][:a.shape[0]] = a
    return MapState(**out)


def track_to_torch(ts, device: str | torch.device = "cpu") -> TrackState:
    return _convert(ts, TrackState, device)


def frame_to_torch(frame, device: str | torch.device = "cpu") -> Frame:
    return _convert(frame, Frame, device)


def ba_problem_to_torch(prob, device: str | torch.device = "cpu") -> BAProblem:
    return _convert(prob, BAProblem, device)


def loop_candidate_to_torch(lc, device: str | torch.device = "cpu") -> LoopCandidate:
    return _convert(lc, LoopCandidate, device)


def loop_verification_to_torch(ver, device: str | torch.device = "cpu") -> LoopVerification:
    return _convert(ver, LoopVerification, device)


def pose_graph_to_torch(g, device: str | torch.device = "cpu") -> PoseGraph:
    return _convert(g, PoseGraph, device)


def sim3_graph_to_torch(g, device: str | torch.device = "cpu") -> Sim3Graph:
    return _convert(g, Sim3Graph, device)


def mono_init_to_torch(res, device: str | torch.device = "cpu") -> MonoInit:
    return _convert(res, MonoInit, device)


def consistent_groups_to_numpy(groups) -> list:
    """`SLAMSystem._consistent_groups` of either package ([(covisibility
    group mask (F,), streak)]) as host values; the streak state
    `track_sequence` carries between keyframes, with `_last_loop_kf` (a
    plain int in both)."""
    return [(np.asarray(mask, dtype=bool), int(streak)) for mask, streak in groups]


def to_numpy(state) -> Dict[str, np.ndarray]:
    """Port state -> {field: numpy array}, descriptor fields as uint32
    words (the reference's layout)."""
    out = {}
    for f in state._fields:
        a = getattr(state, f).detach().cpu().numpy()
        out[f] = i32_to_u32(a) if "desc" in f else a
    return out
