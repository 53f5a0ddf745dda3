"""Map checkpoint / resume (counterpart of lc_crf_slam_tpu/utils/checkpoint.py).

One .npz in the reference's layout: `map.<field>` and `ts.<field>` for
every MapState / TrackState field, `meta.<key>`, the per-frame trajectory
log (`traj.t`, `traj.Tcr`, `traj.ref`) and the keyframe log (`kflog.t`,
`kflog.idx`). Arrays carry the reference's dtypes (descriptors as uint32
words, `convert.to_numpy`), except `map.kf_time`, which the port keeps in
float64; the reference reads it back as its own float32. A checkpoint of
either package therefore loads in the other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import convert
from ..models.mapstate import MapState
from ..models.tracking import TrackState


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(path: str, m: MapState, ts: TrackState,
                    meta: dict | None = None,
                    trajectory: list | None = None,
                    kf_log: list | None = None) -> None:
    """Snapshot the map and tracking state, and the per-frame trajectory
    log (`SLAMSystem.trajectory`: (t, Tcr, ref_kf) entries, so a resumed
    run exports every frame, the earlier ones still moved by later loop
    corrections through their reference keyframes) and `kf_log`."""
    arrays = {f"map.{k}": v for k, v in convert.to_numpy(m).items()}
    arrays.update({f"ts.{k}": v for k, v in convert.to_numpy(ts).items()})
    for k, v in (meta or {}).items():
        arrays[f"meta.{k}"] = np.asarray(v)
    if trajectory:
        arrays["traj.t"] = np.asarray([t for t, _, _ in trajectory])
        arrays["traj.Tcr"] = np.stack([_host(T) for _, T, _ in trajectory])
        arrays["traj.ref"] = np.asarray([int(r) for _, _, r in trajectory], np.int32)
    if kf_log:
        arrays["kflog.t"] = np.asarray([t for t, _ in kf_log])
        arrays["kflog.idx"] = np.asarray([int(k) for _, k in kf_log], np.int32)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, device: str | torch.device = "cuda"
                    ) -> Tuple[MapState, TrackState, dict]:
    """(map, tracking state on `device`, meta): meta holds the `meta.*`
    arrays and, when saved, "trajectory" [(t, Tcr, ref_kf)] and "kf_log"
    [(t, kf index)] on the host."""
    with np.load(path) as data:
        part = {p: {k[len(p) + 1:]: data[k] for k in data.files if k.startswith(p + ".")}
                for p in ("map", "ts", "meta")}
        meta = part["meta"]
        if "traj.t" in data.files:
            meta["trajectory"] = [
                (float(t), T, int(r)) for t, T, r in
                zip(data["traj.t"], data["traj.Tcr"], data["traj.ref"])]
        if "kflog.t" in data.files:
            meta["kf_log"] = [(float(t), int(k))
                              for t, k in zip(data["kflog.t"], data["kflog.idx"])]
    m = convert.map_to_torch(MapState(**part["map"]), device)
    ts = convert.track_to_torch(TrackState(**part["ts"]), device)
    return m, ts, meta
