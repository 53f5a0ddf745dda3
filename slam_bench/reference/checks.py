"""The numbers that decide `correct`: each one compares what the timed
path produced with what the plain reference works out again from the
frames the benchmark rendered, or with the generator's ground truth.

- `kp_diff`: keypoints (level, position) that the program's front end and
  the plain front end do not both find, over the keypoints the plain one
  finds, on the sampled frames of the window.
- `desc_bits`: descriptor bits that differ on keypoints both find, over
  all their bits.
- `ate_m`: the largest ATE RMSE [m] of one session's per-frame poses, as
  the entry returned them, against the ground truth.
- `map_rel_q50`: the median relative depth error of the live map points
  off the mover in view of the last frame's true pose, each against the
  scene's splats drawn over its pixel (`splat_errors`): a map misplaced
  as a whole, or a third of it, moves it.
- `crf_contrast`: of the points made in the session and in view in `SEEN`
  frames or more, alive or culled since (a slot keeps its point and label
  until the map is full), the share off the mover that the CRF labelled
  dynamic over the share on the mover that it did, in the map of the
  first session the window ended, else the map at its close.
- `loop_missed`: keyframes inserted in the window whose loop detection
  did not run (the program's counts of keyframes and detections).
- `crf_missed`: hand-ins on an initialised map in which the CRF did not
  run (the program's count of CRF steps).

Imports nothing of the program; the map, the poses and the counts are the
program's outputs, read only to judge them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ate import ate_rmse

EDGE_PX = 2         # pixels a splat counts beyond its edge
SEEN = 2            # frames in view before a point counts for the CRF's labels
PATCH_M = 0.2       # a map point this near a scene point may lie on its patch


@dataclass
class Judged:
    """What the run hands the comparison. `frames` pairs a session frame
    index with the program's front-end output on it; `ref_frames` maps
    each such index to the plain front end's; `sessions` holds each
    session's `frames` and returned `Tcw`; `maps` pairs each map read
    (numpy: at the end of the first session, if the window ended one,
    and at its close) with the session frame last tracked into it;
    `counts` holds (keyframes, loop detections, CRF steps, initialised
    before) of each hand-in."""

    frames: List[tuple]
    ref_frames: Dict[int, dict]
    sessions: List[dict]
    maps: List[Tuple[dict, int]]
    counts: List[tuple]
    world: object
    n_frames: int
    dyn_threshold: float

_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def popcount(words: np.ndarray) -> int:
    """Set bits of an integer array, whatever its width."""
    return int(_POP8[np.ascontiguousarray(words).view(np.uint8)].sum())


def keypoint_diff(port: dict, ref: dict):
    """(kp_diff, desc_bits, keypoints compared) of one frame; each side a
    dict of numpy arrays uv (K, 2) float32, level (K,), desc (K, 8) int32,
    valid (K,) bool."""
    def keyed(side):
        v = side["valid"]
        keys = zip(side["level"][v].tolist(),
                   side["uv"][v].view(np.int32)[:, 0].tolist(),
                   side["uv"][v].view(np.int32)[:, 1].tolist())
        return dict(zip(keys, side["desc"][v]))

    p, r = keyed(port), keyed(ref)
    common = p.keys() & r.keys()
    n_diff = len(p.keys() ^ r.keys())
    bits = sum(popcount(np.bitwise_xor(p[k], r[k])) for k in common)
    return n_diff / max(len(r), 1), bits / max(256 * len(common), 1), len(r)


def sessions_ate(sessions: List[dict], world) -> float:
    """The largest ATE RMSE over the sessions that have at least 3 frames:
    each session a dict of `frames` (session frame indices) and `Tcw`
    ((n, 4, 4) poses as returned)."""
    worst = 0.0
    for s in sessions:
        ks = np.asarray(s["frames"])
        if len(ks) < 3:
            continue
        twc = np.linalg.inv(np.asarray(s["Tcw"], np.float64))
        gt = np.stack([world.gt_pose_twc(int(k)) for k in ks])
        ts = ks / 30.0
        if not np.all(np.isfinite(twc)):
            return float("inf")
        worst = max(worst, ate_rmse(ts, twc, ts, gt))
    return worst


def _in_gt_frame(world, p_xyz: np.ndarray) -> np.ndarray:
    """Map points (world = the first frame's camera) in the generator's
    world frame."""
    T = world.gt_pose_twc(0)
    return p_xyz.astype(np.float64) @ T[:3, :3].T + T[:3, 3]


def _live_off_mover(m: dict, world, k: int) -> np.ndarray:
    """Live map points in the generator's frame, those in the region the
    mover swept over frames 0..k left out."""
    p = _in_gt_frame(world, m["p_xyz"][m["p_alive"]])
    if world.billboard:
        p = p[~world.bb_gt_dynamic(p, n=k + 1)]
    return p


def splat_errors(m: dict, world, k: int, margin: int = None,
                 relative: bool = True) -> np.ndarray:
    """For each live map point off the mover in view of frame k's true
    pose: |its depth - the depth of the nearest in depth of the scene's
    splats drawn over its pixel| [m], inf where none is. A rendered point
    is a square patch of side 2 * _PATCH_R + 1 px at its own depth, facing
    the camera, so a map point found anywhere on it lies at that depth
    wherever the patch is hidden behind another: no point reads far
    because the view changed, only because it is misplaced. A patch
    counts `EDGE_PX` beyond its edge: a corner on the edge between two
    patches takes the depth of either side."""
    margin = EDGE_PX if margin is None else margin
    p = _live_off_mover(m, world, k)
    T_cw = np.linalg.inv(world.gt_pose_twc(k))
    cam = world.cam

    def project(x):
        xc = x @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = xc[:, 2]
        zs = np.where(z > 0.1, z, 1.0)
        return (np.round(cam.fx * xc[:, 0] / zs + cam.cx),
                np.round(cam.fy * xc[:, 1] / zs + cam.cy), z)

    u, v, z = project(p)
    seen = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    u, v, z = u[seen], v[seen], z[seen]
    us, vs, zs = project(world.p_static)
    front = zs > 0.1
    us, vs, zs = us[front], vs[front], zs[front]
    r = world._PATCH_R + margin
    out = []
    for i in range(0, len(z), 1024):
        cover = ((np.abs(u[i:i + 1024, None] - us[None]) <= r)
                 & (np.abs(v[i:i + 1024, None] - vs[None]) <= r))
        gap = np.where(cover, np.abs(z[i:i + 1024, None] - zs[None]), np.inf)
        if not gap.shape[1]:
            out.append(np.full(len(gap), np.inf))
            continue
        j = gap.argmin(axis=1)
        best = gap[np.arange(len(j)), j]
        out.append(best / zs[j] if relative else best)
    return np.concatenate(out) if out else np.zeros(0)


def _to_scene(world, p: np.ndarray) -> np.ndarray:
    """Distance [m] of each point (generator's frame) to the nearest point
    of the static scene, in blocks of points."""
    scene = world.p_static
    out = [np.sqrt(np.min(np.sum(np.square(p[i:i + 2048, None, :] - scene[None]), -1), 1))
           for i in range(0, len(p), 2048)]
    return np.concatenate(out) if out else np.zeros(0)


def _on_mover(world, p: np.ndarray, k: int) -> np.ndarray:
    """Points (generator's frame) on the mover: in the region it swept
    over frames 0..k, and not on the patch of a scene point that lies in
    that region (a patch reaches ~0.13 m from its point at the mover's
    depth)."""
    on = world.bb_gt_dynamic(p, n=k + 1)
    on[on] = _to_scene(world, p[on]) > PATCH_M
    return on


def map_rel_q50(m: dict, world, k: int) -> float:
    e = splat_errors(m, world, k)
    return float(np.percentile(e, 50)) if len(e) else float("inf")


def _labelled(m: dict, world, k: int, threshold: float, seen: int):
    """P(dynamic) over the threshold of the points made in the session and
    in view in `seen` frames or more, and which of them lie on the
    mover."""
    made = np.arange(len(m["p_alive"])) < int(m["n_points"])
    pick = made & (m["p_visible"] >= seen)
    on = _on_mover(world, _in_gt_frame(world, m["p_xyz"][pick]), k)
    return m["p_dyn"][pick] > threshold, on


def crf_contrast(m: dict, world, k: int, threshold: float, seen: int = None) -> float:
    """The share of the scene's points the CRF labelled dynamic over the
    share of the mover's it did: small where the labels follow the motion,
    about 1 where they do not, inf where no point of the mover was ever
    labelled."""
    lab, on = _labelled(m, world, k, threshold, SEEN if seen is None else seen)
    if not on.any() or not (~on).any() or not lab[on].any():
        return float("inf")
    return float(lab[~on].mean() / lab[on].mean())


def mover_used(m: dict, world, k: int, threshold: float) -> float:
    """Share of the live points tracking may use (P(dynamic) under the
    threshold) that lie on the mover."""
    used = m["p_alive"] & (m["p_dyn"] < threshold)
    if not used.any():
        return float("inf")
    return float(_on_mover(world, _in_gt_frame(world, m["p_xyz"][used]), k).mean())


def loop_missed(counts: List[tuple]) -> int:
    return int(sum(kfs - det for kfs, det, _, _ in counts))


def crf_missed(counts: List[tuple]) -> int:
    return int(sum(1 for _, _, crf, init in counts if init and crf == 0))


def evaluate(checks: List[str], j: Judged) -> Dict[str, Optional[float]]:
    """Every number the cell names in `checks`."""
    out: Dict[str, Optional[float]] = {}
    if "kp_diff" in checks or "desc_bits" in checks:
        kp, bits = [], []
        for k, port in j.frames:
            d, b, _ = keypoint_diff(port, j.ref_frames[k])
            kp.append(d)
            bits.append(b)
        out["kp_diff"] = max(kp) if kp else None
        out["desc_bits"] = max(bits) if bits else None
    if "ate_m" in checks:
        out["ate_m"] = sessions_ate(j.sessions, j.world)
    if "map_rel_q50" in checks:
        out["map_rel_q50"] = max(map_rel_q50(m, j.world, k) for m, k in j.maps)
    if "crf_contrast" in checks:
        m, k = j.maps[0]
        out["crf_contrast"] = crf_contrast(m, j.world, k, j.dyn_threshold)
    if "loop_missed" in checks:
        out["loop_missed"] = loop_missed(j.counts)
    if "crf_missed" in checks:
        out["crf_missed"] = crf_missed(j.counts)
    return {k: out[k] for k in checks}


def diagnostics(j: Judged) -> dict:
    """Readings beside the compared numbers, for the calibration: the
    size of each map read, quantiles of its errors, and the CRF's labels
    read in other ways."""
    out = {}
    for name, (m, k) in zip(("first", "close") if len(j.maps) == 2 else ("close",), j.maps):
        d = {"frames": k + 1, "live": int(m["p_alive"].sum()), "made": int(m["n_points"]),
             "keyframes": int(m["n_kfs"])}
        for margin in (0, 2, 4):
            rel = splat_errors(m, j.world, k, margin)
            d[f"judged{margin}"] = len(rel)
            for q in (50, 75, 90):
                d[f"rel{margin}_q{q}"] = float(np.percentile(rel, q)) if len(rel) else None
            for far in (0.03, 0.05, 0.08, 0.12):
                d[f"rel{margin}_far_{far}"] = float(np.mean(rel > far)) if len(rel) else None
        e = splat_errors(m, j.world, k, relative=False)
        for q in (50, 75):
            d[f"m_q{q}"] = float(np.percentile(e, q)) if len(e) else None
        if j.world.billboard:
            thr = j.dyn_threshold
            for seen in (1, 2, 3, 4):
                lab, on = _labelled(m, j.world, k, thr, seen)
                d[f"mover_labelled_{seen}"] = float(lab[on].mean()) if on.any() else None
                d[f"scene_labelled_{seen}"] = float(lab[~on].mean()) if (~on).any() else None
                d[f"crf_contrast_{seen}"] = crf_contrast(m, j.world, k, thr, seen)
                d[f"mover_points_{seen}"] = int(on.sum())
            d["mover_used"] = mover_used(m, j.world, k, thr)
        out[name] = d
    out["hand_ins"] = len(j.counts)
    out["keyframes"] = int(sum(c[0] for c in j.counts))
    return out
