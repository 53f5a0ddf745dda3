"""System facade: the user-facing SLAM object (counterpart of
lc_crf_slam_tpu/models/system.py).

`track_rgbd` runs the reference's per-frame pipeline (`_track_frame`):
tracking, relocalisation when tracking is lost and the map holds two
keyframes, keyframe insertion behind the backward-flow spawn gate, local
mapping and loop detection on every new keyframe, the forward-flow
evidence EMA and the CRF labeler on every frame.

`track_sequence` is the throughput entry point: frames go in chunks. A
chunk's front-end runs batched (`build_frames`: one FAST launch) and its
forward LK flow is hoisted ahead of the tracking loop; every frame that
asks for a keyframe inserts it, maps (on the shortened InterruptBA
schedule) and detects loops right there; the CRF labels once per chunk;
and the host reads one packed transfer per chunk. The reference fuses a
chunk into one device program with the keyframe branch as a device-side
conditional and pads the last chunk; eager PyTorch reads the keyframe
decision on the host (one device->host read per frame, nothing else
inside a chunk) and runs a ragged last chunk as it is.

Loop closing (`_try_close_loop`) runs on every new keyframe: detection,
the consecutive-detection consistency streak, verification of up to three
ready candidates, and on acceptance the pose-graph correction. Global BA
then runs off the hot path in budgeted slices (`_pump_gba`: one slice per
frame or per chunk), and the group-wide SearchAndFuse once the budget is
spent; exporting a trajectory or `shutdown` finishes a pending budget.
The three sensors of the reference run through its entry points, each of
which pins `cfg.sensor` before the first frame (`_set_sensor`):
- RGB-D: `track_rgbd`, `track_sequence`, `track_observations`;
- stereo: `track_stereo` and `track_sequence_stereo` build both eyes in
  one `build_frames` batch (one FAST launch a frame, or a chunk) and give
  the left eye depth by row matching (`ops/stereo.py`); everything after
  is the RGB-D pipeline;
- monocular: `track_monocular` and `track_observations_mono` bootstrap by
  two-view initialisation (`models/initializer.py`), map by triangulation
  only, and close loops over Sim(3) (`correct_loop_sim3`,
  `cfg.loop.fix_scale=False`).
With a "frames" mesh (`SLAMSystem(mesh=parallel.mesh.make_mesh(...,
axis="frames"))`) a chunk's images split over the mesh's devices in
contiguous shards: each device builds its shard's frames (one FAST launch
a shard) and runs its shard's forward flow, and the products gather to
the system's device, where the tracking loop runs as without a mesh.

`track_rgbd` reads the device once per frame (the keyframe decision and
the tracking status), and so does a stereo or monocular frame once the
map exists; a keyframe frame reads it once more for the capacity warning
and once for the loop detection, a relocalisation attempt twice more, and
every verified loop candidate once (its verdict). Before the monocular
map exists a frame reads it once while it waits for a reference frame
(its feature count), twice on a failed initialisation attempt (the
eight-point solver's status; the verdict with the match count) and three
times on success (and the map's point count). Tables made on the host and
cached per device (the front-end's, triangulation's K^-1) cost one more
read each at their first use in a process.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._ops import scatter_set, take_row
from ..config import SLAMConfig
from ..geometry.camera import Pinhole
from ..geometry.se3 import se3_inverse
from ..ops.lk_flow import FlowResult, lk_track, lk_track_batch
from ..ops.match import hamming_matrix, match_nn, projection_gate
from ..ops.pnp import uniform_sampler
from ..ops.ransac import multinomial_sampler
from ..ops.stereo import stereo_match
from ..parallel.mesh import Mesh
from ..utils.io_tum import write_trajectory_tum
from ..utils.profiling import StageTimer
from .ba import draw_consensus
from .crf import crf_step
from .frame import Frame, build_frame, build_frames, frame_from_observations
from .initializer import SAMPLE as MONO_SAMPLE, initialize_mono
from .loopclosing import (correct_loop, correct_loop_sim3, detect_loop, global_ba,
                          relocalize, search_and_fuse, verify_loop)
from .mapping import mapping_step
from .mapstate import MapState, add_keyframe, add_points, empty_map
from .tracking import (
    TrackState,
    empty_track_state,
    initialize_map,
    insert_keyframe,
    track_step,
)


_AUDIT_SEED = 17   # the reference keys its audit draws with PRNGKey(17)
_RELOC_SEED = 7    # ... and its relocalisation draws with PRNGKey(7)
_LOOP_SEED = 11    # the port's own stream for the loop verification's draws
_MONO_SEED = 19    # ... and for the two-view initialisation's


def _project(cam: Pinhole, Tcw: torch.Tensor, pw: torch.Tensor):
    """World points (N, 3) -> (pixels (N, 2), camera-frame depth (N,))."""
    pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = torch.clamp(pc[:, 2], min=1e-6)
    uv = torch.stack([cam.fx * pc[:, 0] / z + cam.cx,
                      cam.fy * pc[:, 1] / z + cam.cy], dim=-1)
    return uv, pc[:, 2]


def flow_evidence(cfg: SLAMConfig, cam: Pinhole, m: MapState,
                  gray_prev: torch.Tensor, gray_next: torch.Tensor,
                  last_uv: torch.Tensor, last_obs: torch.Tensor,
                  last_valid: torch.Tensor, Tcw_new: torch.Tensor) -> MapState:
    """[CRF] short-term flow-consistency evidence: LK-track the previous
    frame's map-associated keypoints and fold the distance to the rigid
    prediction from their map points at the new pose into p_flow_err."""
    use = last_valid & (last_obs >= 0)
    res = lk_track(gray_prev, gray_next, last_uv, use, n_levels=cfg.crf.flow_levels)
    return flow_ema(cfg, cam, m, res.uv_next, res.ok, last_obs, last_valid, Tcw_new)


def flow_ema(cfg: SLAMConfig, cam: Pinhole, m: MapState, uv_next: torch.Tensor,
             flow_ok: torch.Tensor, last_obs: torch.Tensor,
             last_valid: torch.Tensor, Tcw_new: torch.Tensor) -> MapState:
    """The evidence update of `flow_evidence` from flow already tracked
    (`track_sequence` hoists a chunk's LK ahead of its tracking loop)."""
    use = last_valid & (last_obs >= 0)
    ids = torch.clamp(last_obs, min=0).long()
    uv_pred, z = _project(cam, Tcw_new, m.p_xyz[ids])
    ferr = torch.linalg.norm(uv_next - uv_pred, dim=-1)
    ok = use & flow_ok & (z > 0.05)
    decay = cfg.crf.flow_decay
    new = decay * m.p_flow_err[ids] + (1 - decay) * torch.clamp(ferr, max=50.0)
    return m._replace(p_flow_err=scatter_set(
        m.p_flow_err, torch.where(ok, last_obs, m.capacity_points), new))


def spawn_flow_dyn(cfg: SLAMConfig, cam: Pinhole, gray_cur: torch.Tensor,
                   gray_prev: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor,
                   valid: torch.Tensor, Tcw_cur: torch.Tensor,
                   Tcw_prev: torch.Tensor) -> torch.Tensor:
    """[CRF] spawn gate: LK-track the current keypoints back into the
    previous image; (K,) True where the flow departs from the rigid
    prediction by more than `spawn_flow_gate` px (a moving surface)."""
    Twc = se3_inverse(Tcw_cur)
    pc = torch.stack([(uv[:, 0] - cam.cx) / cam.fx * depth,
                      (uv[:, 1] - cam.cy) / cam.fy * depth, depth], dim=-1)
    uv_pred, z_prev = _project(cam, Tcw_prev, pc @ Twc[:3, :3].T + Twc[:3, 3])
    use = valid & (depth > 0)
    res = lk_track(gray_cur, gray_prev, uv, use, n_levels=cfg.crf.flow_levels)
    mism = torch.linalg.norm(res.uv_next - uv_pred, dim=-1)
    return use & res.ok & (z_prev > 0.05) & (mism > cfg.crf.spawn_flow_gate)


class _PhaseClock:
    """Adds the host seconds between laps to a dict of phases (or to
    nothing, when the dict is None)."""

    def __init__(self, phases: Optional[dict]):
        self.phases = phases
        self.t0 = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.phases is not None:
            now = time.perf_counter()
            self.phases[name] = self.phases.get(name, 0.0) + now - self.t0
            self.t0 = now


def _to_host(items: Sequence) -> np.ndarray:
    """Stack a list whose entries are device tensors (the per-frame path
    defers them) or host values (a chunk's fetch) into one numpy array,
    with one transfer for all the tensors."""
    where = [i for i, x in enumerate(items) if isinstance(x, torch.Tensor)]
    out = list(items)
    if where:
        vals = torch.stack([items[i] for i in where]).cpu().numpy()
        for i, v in zip(where, vals):
            out[i] = v
    return np.stack([np.asarray(x) for x in out])


class SLAMSystem:
    """Single-session SLAM (RGB-D, stereo or monocular) on one device.

    `device` defaults to CUDA and raises if no card is present; the CPU
    runs only when asked for (`device="cpu"`), as the tests do.
    `log_path` names a JSONL file: `flush_stats` writes each record not yet
    written as one `json.dumps` line, `shutdown` closes it. `timer` times
    the per-frame stages on the host clock (frontend, track, insert_kf,
    mapping, global_ba_slice); on the card that is the dispatch, not the
    device work (`utils/profiling.py`). Keyframe times are float64: the
    reference's float32 is 128 s apart at Unix times near 1.3e9.
    `n_mapping_steps`, `n_crf_steps`, `n_detect_loops` and `n_verify_loops`
    count the stage calls; `loop_log` lists the closed loops. Set
    `seq_phases` to a dict and `track_sequence` adds the host seconds of
    its phases to it (frontend, lk, steps, crf, chunk_fetch, host_misc,
    reloc_host, loop_host); the device runs behind the host, and the fetch
    absorbs what it still has to do. `mesh` (axis "frames") splits a
    chunk's front-end and forward flow over its devices; everything else
    runs on `device`.
    """

    def __init__(self, cam: Pinhole, cfg: Optional[SLAMConfig] = None,
                 log_path: Optional[str] = None, enable_mapping: bool = True,
                 enable_crf: Optional[bool] = None,
                 device: str | torch.device = "cuda", mesh: Optional[Mesh] = None):
        self.cam = cam
        self.cfg = cfg or SLAMConfig()
        self.enable_mapping = enable_mapping
        self.enable_crf = self.cfg.crf.enabled if enable_crf is None else enable_crf
        self.enable_loop = self.cfg.loop.enabled
        self.seq_phases: Optional[dict] = None
        self.device = torch.device(device)
        if mesh is not None and mesh.axis != "frames":
            raise ValueError(f"SLAMSystem shards a chunk's frames: the mesh's axis "
                             f"must be 'frames', not {mesh.axis!r}")
        self.mesh = mesh
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SLAMSystem(device='cuda'): no CUDA device; pass "
                    "device='cpu' to run on the CPU")
            # descriptor bits threshold a 1521-term f32 dot at 0.1, and
            # covisibility counts must stay exact: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self._gen = torch.Generator(device=self.device)
        self.timer = StageTimer()
        self._log_fh = None
        self.reset()
        self._log_fh = open(log_path, "w") if log_path else None

    def reset(self) -> None:
        """System::Reset — clear the map and tracking state (and the
        records, after writing those not yet logged); localisation mode
        is off again."""
        if self._log_fh is not None:
            self.flush_stats()
        self.map: MapState = empty_map(self.cfg, self.device)
        self.ts: TrackState = empty_track_state(self.cfg, self.device)
        self.initialized = False
        # (t, Tcr, ref_kf): frame pose relative to its reference keyframe,
        # device tensors resolved lazily in get_trajectory()
        self.trajectory: List[tuple] = []
        self.kf_log: List[tuple] = []        # (t, kf index)
        self.stats: List[dict] = []
        self._n_logged = 0                   # records written to the log
        self._localization_only = False
        self._n_frames = 0
        self._capacity_warned = False
        self._last_gray: Optional[torch.Tensor] = None
        self._last_Tcw: Optional[torch.Tensor] = None
        self.n_mapping_steps = 0
        self.n_crf_steps = 0
        self.n_detect_loops = 0
        self.n_verify_loops = 0
        self._consistent_groups: List[tuple] = []   # [(covis-group mask, streak)]
        self._last_loop_kf = -10**9
        self.loop_log: List[dict] = []       # kf, cand, inliers, s_corr per closure
        # global BA budget left after a loop closure: {"left": LM iterations,
        # "kf": the closing keyframe}
        self._gba_pending: Optional[dict] = None
        self._gba_slices_run = 0
        # the monocular reference frame the next frame initialises against
        self._mono_ref: Optional[tuple] = None

    def _set_sensor(self, mode: str) -> None:
        """Pin the config's sensor mode ("rgbd", "stereo", "monocular") to
        the entry point in use, before the first frame (the reference fixes
        eSensor at System construction): switching later would change the
        keyframe policy mid-run."""
        if self.cfg.sensor == mode:
            return
        if self.initialized:
            raise RuntimeError(f"sensor mode is {self.cfg.sensor!r}; cannot switch "
                               f"to {mode!r} after initialization")
        self.cfg = self.cfg.replace(sensor=mode)
        self.__dict__.pop("_chunk_cfgs", None)

    # ------------------------------------------------------------------ api
    def track_rgbd(self, gray, depth, timestamp: float) -> torch.Tensor:
        """Process one RGB-D frame ((H, W) grayscale 0-255 and depth in
        metres, numpy or tensor); returns Tcw (4, 4) on the device."""
        self._set_sensor("rgbd")
        gray, depth = self._upload(gray), self._upload(depth)
        with self.timer.stage("frontend"):
            frame = build_frame(self.cam, self.cfg, gray, depth)
        return self._track_frame(frame, timestamp, gray)

    def track_stereo(self, gray_left, gray_right, timestamp: float) -> torch.Tensor:
        """System::TrackStereo: a rectified pair ((H, W) each) in, Tcw out.
        Both eyes' features come from one batched front-end, the left ones
        gain depth by row matching, then the RGB-D pipeline applies."""
        self._set_sensor("stereo")
        gray_left, gray_right = self._upload(gray_left), self._upload(gray_right)
        frame = self._stereo_frames(gray_left[None], gray_right[None])[0]
        return self._track_frame(frame, timestamp, gray_left)

    def _stereo_frames(self, grays_left: torch.Tensor,
                       grays_right: torch.Tensor) -> List[Frame]:
        """(B, H, W) left and right images -> B depth-carrying left Frames
        (Frame::ComputeStereoMatches): all 2B images in one `build_frames`
        call, then the row match of each pair."""
        cam, B = self.cam, grays_left.shape[0]
        frames = build_frames(cam, self.cfg, torch.cat([grays_left, grays_right]), None)
        out = []
        for fl, fr in zip(frames[:B], frames[B:]):
            u_right, depth = stereo_match(cam, fl.uv, fl.level, fl.desc, fl.valid,
                                          fr.uv, fr.level, fr.desc, fr.valid)
            out.append(fl._replace(u_right=u_right, depth=depth))
        return out

    def track_monocular(self, gray, timestamp: float) -> torch.Tensor:
        """System::TrackMonocular: one image in, Tcw out (the identity until
        the two-view initialisation succeeds; up to scale after)."""
        self._set_sensor("monocular")
        gray = self._upload(gray)
        frame = build_frame(self.cam, self.cfg, gray, None)     # no depth, no uR
        if not self.initialized:
            return self._try_mono_init(frame, timestamp, gray)
        return self._track_frame(frame, timestamp, gray)

    def track_observations(self, uv, depth, desc, timestamp: float) -> torch.Tensor:
        """Pipeline-test entry: track a frame given its observations
        (keypoints, depth, descriptors) instead of an image."""
        self._set_sensor("rgbd")
        frame = frame_from_observations(uv, depth, desc, self.cfg.map.max_features,
                                        self.cam, self.device)
        return self._track_frame(frame, timestamp)

    def track_observations_mono(self, uv, desc, timestamp: float) -> torch.Tensor:
        """Observation-level monocular entry: `track_monocular` without the
        image front-end (two-view initialisation, triangulation-only
        mapping, the Sim(3) loop)."""
        self._set_sensor("monocular")
        frame = frame_from_observations(uv, np.zeros((len(uv),), np.float32), desc,
                                        self.cfg.map.max_features, self.cam, self.device)
        if not self.initialized:
            return self._try_mono_init(frame, timestamp, None)
        return self._track_frame(frame, timestamp)

    def _try_mono_init(self, frame: Frame, timestamp: float,
                       gray: Optional[torch.Tensor]) -> torch.Tensor:
        """Initializer: the first frame with more than 100 features becomes
        the reference; each next frame is matched against it and tried as
        the second view. On success keyframes 0 (the reference, at I) and
        1 (this frame) and the triangulated points make the map; a failure
        with fewer than 100 matches replaces the reference frame."""
        cfg, cam, dev = self.cfg, self.cam, self.device
        eye = torch.eye(4, device=dev)
        self._n_frames += 1
        if self._mono_ref is None:
            if int(frame.valid.sum()) > 100:
                self._mono_ref = (frame, timestamp)
            self.trajectory.append((timestamp, np.eye(4, dtype=np.float32), -1))
            self.stats.append({"t": timestamp, "event": "mono_wait"})
            return eye
        ref, t_ref = self._mono_ref
        gate = (ref.valid[:, None] & frame.valid[None, :]
                & projection_gate(ref.uv, frame.uv, 100.0))
        mm = match_nn(hamming_matrix(ref.desc, frame.desc), mask=gate,
                      max_dist=cfg.matcher.th_low, ratio=0.9, mutual=True)
        res = initialize_mono(cam, ref.uv, frame.uv[mm.idx], mm.valid,
                              self._mono_sampler())
        # the verdict and the match count in one read
        accepted, n_matches = torch.stack(
            [res.accepted.to(torch.int64), mm.valid.sum()]).tolist()
        if not accepted:
            if n_matches < 100:
                self._mono_ref = (frame, timestamp)
            self.trajectory.append((timestamp, np.eye(4, dtype=np.float32), -1))
            self.stats.append({"t": timestamp, "event": "mono_init_fail"})
            return eye
        # the initial map: keyframe 0 (the reference frame) at I, keyframe 1
        # (this frame) at Tcw2, the triangulated points observed by both
        K = cfg.map.max_features
        sf = cfg.orb.scale_factor
        normal = torch.zeros((K, 3), device=dev)
        normal[:, 2] = -1.0
        max_d = torch.linalg.norm(res.xyz, dim=-1) * sf ** ref.level.to(torch.float32)
        min_d = max_d / sf ** (cfg.orb.n_levels - 1)
        i32 = dict(dtype=torch.int32, device=dev)
        self.map, ids = add_points(
            self.map, res.xyz, ref.desc, normal, min_d, max_d, res.ok,
            torch.zeros((), **i32), tomb_dyn_threshold=cfg.crf.dynamic_threshold,
            n_obs_init=0)       # both add_keyframe calls below count
        f64 = dict(dtype=torch.float64, device=dev)
        self.map, _ = add_keyframe(self.map, ref, eye, torch.full((), t_ref, **f64), ids)
        # cur_obs[mm.idx] = ids where ok; every other row writes -1 into
        # slot K - 1, and the last write to a slot wins (XLA's CPU scatter)
        tgt = torch.where(res.ok, mm.idx, K - 1)
        rows = torch.arange(K, device=dev)
        last = torch.full((K,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, tgt, rows, "amax")
        vals = torch.where(res.ok, ids, -1)
        cur_obs = torch.where(last >= 0, vals[torch.clamp(last, min=0)], -1).to(torch.int32)
        self.map, kf1 = add_keyframe(self.map, frame, res.Tcw2,
                                     torch.full((), timestamp, **f64), cur_obs)
        self.ts = empty_track_state(cfg, dev)._replace(
            Tcw=res.Tcw2, last_uv=frame.uv, last_ur=frame.u_right,
            last_depth=frame.depth, last_level=frame.level, last_angle=frame.angle,
            last_desc=frame.desc, last_valid=frame.valid, last_obs=cur_obs,
            ref_kf=kf1, ref_matches=torch.sum(cur_obs >= 0, dtype=torch.int32),
            status=torch.ones((), **i32))
        self.initialized = True
        self._mono_ref = None
        # the initialising frame is keyframe 1: identity relative pose
        self.trajectory.append((timestamp, np.eye(4, dtype=np.float32), kf1))
        self.stats.append({"t": timestamp, "event": "mono_init",
                           "n_points": int(self.map.n_points)})
        self._last_gray = gray
        return res.Tcw2

    def _upload(self, img, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Host array -> contiguous `dtype` on the device; from pinned
        memory and asynchronous, so the upload does not stall the host."""
        t = torch.as_tensor(img, dtype=dtype).contiguous()
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _sampler(self):
        """Consensus draws for this frame, from a generator seeded by the
        frame number, so a run is reproducible frame by frame."""
        self._gen.manual_seed(_AUDIT_SEED * 1_000_003 + self._n_frames)
        return functools.partial(draw_consensus, generator=self._gen)

    def _reloc_sampler(self):
        """PnP sample indices of this frame's relocalisation attempt."""
        self._gen.manual_seed(_RELOC_SEED * 1_000_003 + self._n_frames)
        return uniform_sampler(self._gen)

    def _mono_sampler(self):
        """Eight-point sample sets of this frame's initialisation attempt."""
        self._gen.manual_seed(_MONO_SEED * 1_000_003 + self._n_frames)
        return multinomial_sampler(self._gen, MONO_SAMPLE)

    def _loop_sampler(self):
        """Horn RANSAC minimal sets of this loop verification (the
        reference splits them off its relocalisation key; the port numbers
        a stream of its own by verification)."""
        self._gen.manual_seed(_LOOP_SEED * 1_000_003 + self.n_verify_loops)
        return multinomial_sampler(self._gen)

    # stat names packed into the deferred per-frame device vector
    _DEV_STAT_KEYS = ("n_mm", "n_inliers", "n_local", "rescued", "ref_fallback",
                      "n_dynamic", "crf_tracks", "n_points", "n_kfs")

    def _track_frame(self, frame: Frame, timestamp: float,
                     gray: Optional[torch.Tensor] = None) -> torch.Tensor:
        t0 = time.perf_counter()
        cfg, cam = self.cfg, self.cam
        t_dev = torch.full((), timestamp, dtype=torch.float64, device=self.device)
        prev_gray = self._last_gray
        prev_uv, prev_obs, prev_valid = self.ts.last_uv, self.ts.last_obs, self.ts.last_valid
        dev_stats = None
        if not self.initialized:
            self.map, self.ts = initialize_map(cfg, cam, self.map, frame, t_dev)
            self.initialized = True
            info_host = {"event": "init"}
        else:
            with self.timer.stage("track"):
                self.ts, self.map, info = track_step(
                    cfg, cam, self.map, self.ts, frame, self._sampler())
            # the one device->host read of the frame: the control scalars
            need_kf, status, n_kfs = torch.stack(
                [info.need_kf.to(torch.int32), self.ts.status,
                 self.map.n_kfs]).tolist()
            need_kf = need_kf and not self._localization_only
            if status == 2 and n_kfs >= 2:
                # Tracking::Relocalization (a rare path: it reads the device)
                rr = relocalize(cfg, cam, self.map, frame, self._reloc_sampler())
                if bool(rr.accepted):
                    self.ts = self.ts._replace(
                        Tcw=rr.Tcw, vel=torch.eye(4, device=self.device),
                        status=torch.ones((), dtype=torch.int32, device=self.device))
                    status, need_kf = 1, False
            if need_kf:
                flow_dyn = None
                if (self.enable_crf and gray is not None and prev_gray is not None
                        and self._last_Tcw is not None and cfg.crf.spawn_flow_gate > 0):
                    flow_dyn = spawn_flow_dyn(cfg, cam, gray, prev_gray, frame.uv,
                                              frame.depth, frame.valid, self.ts.Tcw,
                                              self._last_Tcw)
                with self.timer.stage("insert_kf"):
                    self.map, self.ts = insert_keyframe(
                        cfg, cam, self.map, self.ts, frame, info.obs, t_dev,
                        info.near_map, flow_dyn)
                if self.enable_mapping:
                    with self.timer.stage("mapping"):
                        self.map = mapping_step(cfg, cam, self.map, self.ts.ref_kf)
                    self.n_mapping_steps += 1
                self.kf_log.append((timestamp, self.ts.ref_kf))
                self._warn_if_at_capacity()
                if self.enable_loop:
                    self._try_close_loop()
            # a pending global BA advances one budgeted slice per frame
            self._pump_gba()
            zero = torch.zeros((), dtype=torch.int64, device=self.device)
            crf_dyn = crf_tracks = zero
            if self.enable_crf:
                if gray is not None and prev_gray is not None:
                    self.map = flow_evidence(cfg, cam, self.map, prev_gray, gray,
                                             prev_uv, prev_obs, prev_valid, self.ts.Tcw)
                self.map, crf_info = crf_step(cfg, self.map, self.ts.frame_idx)
                self.n_crf_steps += 1
                crf_dyn, crf_tracks = crf_info.n_dynamic, crf_info.n_tracks
            dev_stats = torch.stack([
                info.n_mm_matches, info.n_inliers, info.n_local_matches,
                info.rescued.to(torch.int32), info.ref_fallback.to(torch.int32),
                crf_dyn.to(torch.int32), crf_tracks.to(torch.int32),
                self.map.n_points, self.map.n_kfs])
            info_host = {"need_kf": bool(need_kf), "status": status}
        self._last_gray = gray
        self._last_Tcw = self.ts.Tcw
        self._n_frames += 1
        Tcw = self.ts.Tcw
        self.trajectory.append((
            timestamp,
            Tcw @ se3_inverse(take_row(self.map.kf_Tcw, self.ts.ref_kf)),
            self.ts.ref_kf,
        ))
        rec = {"t": timestamp, "ms": (time.perf_counter() - t0) * 1e3, **info_host}
        if dev_stats is not None:
            rec["_dev"] = dev_stats
        self.stats.append(rec)
        return Tcw

    # ------------------------------------------------------ throughput mode
    def track_sequence_stereo(self, grays_left, grays_right, timestamps,
                              chunk: int = 8) -> np.ndarray:
        """Throughput mode for stereo input ((N, H, W) left and right
        images): `track_sequence` with the right eyes in place of depth;
        a chunk's 2 x chunk images go through one `build_frames` call."""
        return self.track_sequence(grays_left, grays_right, timestamps, chunk=chunk,
                                   stereo=True)

    @functools.cached_property
    def _chunk_cfgs(self):
        """(tracking config, mapping config) of the chunk path. Mapping
        inside a chunk always has the next frame pending, so local BA and
        the neighbour passes run the shortened InterruptBA schedule; and
        `track_step` decides keyframes under the throttled minimum gap
        (the reference's queue back-pressure)."""
        cfg = self.cfg
        cfg_map = dataclasses.replace(
            cfg,
            local_ba=dataclasses.replace(
                cfg.local_ba,
                outer_iters_1=cfg.local_ba.interrupt_iters_1,
                outer_iters_2=cfg.local_ba.interrupt_iters_2),
            mapping=dataclasses.replace(
                cfg.mapping,
                triang_neighbors=cfg.mapping.interrupt_triang_neighbors,
                fuse_reverse_neighbors=cfg.mapping.interrupt_fuse_reverse_neighbors))
        cfg_track = dataclasses.replace(
            cfg, tracking=dataclasses.replace(
                cfg.tracking,
                min_frames_between_kf=max(cfg.tracking.min_frames_between_kf,
                                          cfg.tracking.interrupt_min_kf_gap)))
        return cfg_track, cfg_map

    def track_sequence(self, grays, depths, timestamps, chunk: int = 8,
                       stereo: bool = False) -> np.ndarray:
        """Throughput mode: track N frames ((N, H, W) grayscale and depth,
        or with `stereo` the right eyes in place of depth) in chunks of
        `chunk`. Keyframes are inserted, mapped and checked for loops on
        the frame that asks for them, as in `track_rgbd`; the CRF relabels
        once per chunk, and relocalisation is tried at a chunk boundary
        after a persistent loss. Returns the (N, 4, 4) camera poses Tcw
        (N - 1 when the first frame initialises the map). As in the
        reference, only that first frame pins the sensor mode: a call on a
        map that already exists keeps the mode it has."""
        grays, depths = self._upload(grays), self._upload(depths)
        timestamps = np.asarray(timestamps, dtype=np.float64)
        if not self.initialized:
            first = self.track_stereo if stereo else self.track_rgbd
            first(grays[0], depths[0], float(timestamps[0]))
            grays, depths, timestamps = grays[1:], depths[1:], timestamps[1:]
        poses = [np.zeros((0, 4, 4), np.float32)]
        for i in range(0, grays.shape[0], chunk):
            j = min(i + chunk, grays.shape[0])
            poses.append(self._track_chunk(grays[i:j], depths[i:j], timestamps[i:j],
                                           stereo))
        return np.concatenate(poses)

    def _track_chunk(self, g: torch.Tensor, d: torch.Tensor, timestamps: np.ndarray,
                     stereo: bool = False) -> np.ndarray:
        """One chunk of `track_sequence`: (take, 4, 4) poses Tcw. With
        `stereo`, d holds the right eyes and no depth image exists."""
        cfg, cfg_map = self._chunk_cfgs
        cam, dev = self.cam, self.device
        take = g.shape[0]
        clock = _PhaseClock(self.seq_phases)

        frames = self._chunk_frames(g, d, stereo)
        clock.lap("frontend")
        prev_grays = [self._last_gray if self._last_gray is not None else g[0],
                      *g[:-1]]
        if self.enable_crf:
            # forward LK (frame k-1's keypoints -> image k) does not depend
            # on the poses: the whole chunk's runs ahead of the loop
            prev_uvs = [self.ts.last_uv, *(f.uv for f in frames[:-1])]
            flow = self._chunk_flow(prev_grays, g, prev_uvs)
        clock.lap("lk")
        t_dev = self._upload(timestamps, torch.float64)
        spawn_gate = self.enable_crf and cfg.crf.spawn_flow_gate > 0

        Tcw_seq, Tcr_seq, ref_seq, status_seq = [], [], [], []
        kf_flags: List[bool] = []
        loops = []      # one LoopCandidate per keyframe of the chunk
        for k, fr in enumerate(frames):
            prev_obs, prev_valid = self.ts.last_obs, self.ts.last_valid
            Tcw_prev = self.ts.Tcw
            ts, m, info = track_step(cfg, cam, self.map, self.ts, fr, self._sampler())
            # the frame's one device->host read: the reference branches on
            # the device (lax.cond), eager PyTorch on the host
            kf_here = bool(info.need_kf) and not self._localization_only
            if kf_here:
                flow_dyn = None
                if spawn_gate:
                    flow_dyn = spawn_flow_dyn(cfg, cam, g[k], prev_grays[k], fr.uv,
                                              fr.depth, fr.valid, ts.Tcw, Tcw_prev)
                m, ts = insert_keyframe(cfg, cam, m, ts, fr, info.obs, t_dev[k],
                                        info.near_map, flow_dyn)
                if self.enable_mapping:
                    m = mapping_step(cfg_map, cam, m, ts.ref_kf)
                    self.n_mapping_steps += 1
                if self.enable_loop:
                    loops.append(detect_loop(cfg, m, ts.ref_kf))
                    self.n_detect_loops += 1
            if self.enable_crf:
                m = flow_ema(cfg, cam, m, flow.uv_next[k], flow.ok[k], prev_obs,
                             prev_valid, ts.Tcw)
            self.map, self.ts = m, ts
            self._n_frames += 1
            kf_flags.append(kf_here)
            Tcw_seq.append(ts.Tcw)
            # frame pose relative to its reference keyframe at track time
            Tcr_seq.append(ts.Tcw @ se3_inverse(take_row(m.kf_Tcw, ts.ref_kf)))
            ref_seq.append(ts.ref_kf)
            status_seq.append(ts.status)
        clock.lap("steps")
        if self.enable_crf:
            self.map, _ = crf_step(cfg, self.map, self.ts.frame_idx)
            self.n_crf_steps += 1
        self._last_gray = g[take - 1]
        self._last_Tcw = self.ts.Tcw
        clock.lap("crf")

        # ONE packed device->host transfer per chunk (float32 holds every
        # index and flag exactly)
        f32 = torch.float32
        parts = [torch.stack(Tcw_seq).reshape(-1), torch.stack(Tcr_seq).reshape(-1),
                 torch.stack(ref_seq).to(f32), torch.stack(status_seq).to(f32),
                 self.map.n_kfs.to(f32).reshape(1)]
        if loops:
            parts += [torch.stack([lc.valid for lc in loops]).to(f32),
                      torch.stack([lc.cands for lc in loops]).to(f32).reshape(-1),
                      torch.stack([lc.groups for lc in loops]).to(f32).reshape(-1)]
        host = torch.cat(parts).cpu().numpy()
        clock.lap("chunk_fetch")
        cut = np.cumsum([16 * take, 16 * take, take, take, 1])
        Tcw_np = host[:cut[0]].reshape(take, 4, 4)
        Tcr_np = host[cut[0]:cut[1]].reshape(take, 4, 4)
        refkf = host[cut[1]:cut[2]].astype(np.int64)
        statuses = host[cut[2]:cut[3]].astype(np.int64)
        n_kfs = int(host[cut[3]])
        for k in range(take):
            self.trajectory.append((float(timestamps[k]), Tcr_np[k], int(refkf[k])))
            if kf_flags[k]:
                self.kf_log.append((float(timestamps[k]), int(refkf[k])))
        clock.lap("host_misc")
        n_lost = int((statuses == 2).sum())
        if n_lost:
            self.stats.append({"event": "chunk_lost", "t": float(timestamps[-1]),
                               "lost_frames": n_lost})
        # relocalisation at the chunk boundary, after a persistent loss only
        # (a one-frame inlier dip recovers by the motion model)
        persist_lost = statuses[-1] == 2 and (take < 2 or statuses[-2] == 2)
        if persist_lost and n_kfs >= 2:
            fr = (self._stereo_frames(g[take - 1:], d[take - 1:])[0] if stereo
                  else build_frame(cam, self.cfg, g[take - 1], d[take - 1]))
            rr = relocalize(self.cfg, cam, self.map, fr, self._reloc_sampler())
            if bool(rr.accepted):
                self.ts = self.ts._replace(
                    Tcw=rr.Tcw, vel=torch.eye(4, device=dev),
                    status=torch.ones((), dtype=torch.int32, device=dev))
                self.stats.append({"event": "chunk_reloc", "t": float(timestamps[-1]),
                                   "inliers": int(rr.n_inliers)})
        clock.lap("reloc_host")
        if loops:
            n, topk = len(loops), cfg.loop.retrieval_topk
            lc_valid = host[cut[4]:cut[4] + n] > 0
            lc_cands = host[cut[4] + n:cut[4] + n + n * topk].astype(np.int64)
            lc_groups = host[cut[4] + n + n * topk:] > 0
            kf_steps = [k for k in range(take) if kf_flags[k]]
            # a keyframe with no detection still goes through: it clears
            # the consistency streak
            for i, k in enumerate(kf_steps):
                self._try_close_loop(pre=(
                    int(refkf[k]), bool(lc_valid[i]), lc_cands.reshape(n, topk)[i],
                    lc_groups.reshape(n, topk, -1)[i]))
        # a pending global BA advances one budgeted slice per chunk
        self._pump_gba()
        clock.lap("loop_host")
        return Tcw_np

    def _shards(self, take: int) -> List[tuple]:
        """(device, start, stop) of each non-empty shard of a chunk's
        `take` frames: contiguous, in the mesh's order, the first
        `take % size` one frame longer."""
        per, extra = divmod(take, self.mesh.size)
        out, a = [], 0
        for i, dev in enumerate(self.mesh.devices):
            b = a + per + (i < extra)
            if b > a:
                out.append((dev, a, b))
            a = b
        return out

    def _chunk_frames(self, g: torch.Tensor, d: torch.Tensor,
                      stereo: bool) -> List[Frame]:
        """The chunk's Frames on the system's device: one batch, or with a
        mesh one batch per shard on its device, gathered back."""
        build = self._stereo_frames if stereo else (
            lambda gs, ds: build_frames(self.cam, self.cfg, gs, ds))
        if self.mesh is None:
            return build(g, d)
        return [Frame(*(t.to(self.device) for t in f))
                for dev, a, b in self._shards(g.shape[0])
                for f in build(g[a:b].to(dev), d[a:b].to(dev))]

    def _chunk_flow(self, prev_grays: Sequence[torch.Tensor], g: torch.Tensor,
                    prev_uvs: Sequence[torch.Tensor]) -> FlowResult:
        """Forward LK of every (frame k-1, frame k) pair of the chunk, with
        a mesh each shard's pairs on its device, gathered back."""
        ones = torch.ones(prev_uvs[0].shape[0], dtype=torch.bool, device=self.device)
        flow_levels = self.cfg.crf.flow_levels
        if self.mesh is None:
            return lk_track_batch(prev_grays, g, prev_uvs, [ones] * g.shape[0],
                                  n_levels=flow_levels)
        parts = [lk_track_batch([x.to(dev) for x in prev_grays[a:b]], g[a:b].to(dev),
                                [u.to(dev) for u in prev_uvs[a:b]],
                                [ones.to(dev)] * (b - a), n_levels=flow_levels)
                 for dev, a, b in self._shards(g.shape[0])]
        return FlowResult(*(torch.cat([f.to(self.device) for f in field])
                            for field in zip(*parts)))

    def _try_close_loop(self, pre=None) -> None:
        """LoopClosing::Run body for a newly inserted keyframe: detection
        (`pre` = (kf, valid, cands, groups) already fetched by a chunk, or
        None to detect here for the current reference keyframe with one
        packed fetch), then the consecutive-detection GROUP consistency: a
        candidate qualifies once its covisibility group has intersected a
        group of the previous detections `consistency_needed` times in a
        row. Up to three qualified candidates are verified in order (one
        device->host read each: the verdict, with the log's scalars); the
        first accepted one corrects the loop, re-anchors the tracker on its
        moved reference keyframe and opens the global-BA budget."""
        if pre is not None:
            kf, valid, cands, groups = pre
        else:
            lc = detect_loop(self.cfg, self.map, self.ts.ref_kf)
            self.n_detect_loops += 1
            host = torch.cat([
                self.ts.ref_kf.reshape(1).to(torch.int32),
                lc.valid.reshape(1).to(torch.int32), lc.cands,
                lc.groups.reshape(-1).to(torch.int32)]).cpu().numpy()
            topk = lc.cands.shape[0]
            kf, valid, cands = int(host[0]), bool(host[1]), host[2:2 + topk]
            groups = host[2 + topk:].reshape(topk, -1) > 0
        if kf - self._last_loop_kf < self.cfg.loop.min_kfs_since_last:
            return
        if not valid:
            self._consistent_groups = []
            return
        new_groups, ready = [], []
        for c, gmask in zip(cands, groups):
            if c < 0:
                continue
            streak = 1
            for pmask, pstreak in self._consistent_groups:
                if (gmask & pmask).any():
                    streak = max(streak, pstreak + 1)
            new_groups.append((gmask, streak))
            if streak >= self.cfg.loop.consistency_needed:
                ready.append(int(c))
        self._consistent_groups = new_groups
        dev = self.device
        kf_dev = torch.full((), kf, dtype=torch.int32, device=dev)
        for cand in ready[:3]:
            cand_dev = torch.full((), cand, dtype=torch.int32, device=dev)
            ver = verify_loop(self.cfg, self.cam, self.map, kf_dev, cand_dev,
                              self._loop_sampler())
            self.n_verify_loops += 1
            accepted, inliers, s_corr = torch.stack([
                ver.accepted.to(torch.float32), ver.n_inliers.to(torch.float32),
                ver.s_corr]).tolist()
            if not accepted:
                continue
            if self.cfg.loop.fix_scale:
                self.map = correct_loop(self.cfg, self.cam, self.map, kf_dev, cand_dev,
                                        ver.T_corr)
            else:
                # monocular: the Sim(3) essential graph absorbs scale drift
                self.map = correct_loop_sim3(self.cfg, self.cam, self.map, kf_dev,
                                             cand_dev, ver.T_corr, ver.s_corr)
            # the current pose moved with its keyframe
            self.ts = self.ts._replace(
                Tcw=take_row(self.map.kf_Tcw, self.ts.ref_kf),
                vel=torch.eye(4, device=dev))
            # global BA runs as budgeted slices pumped by the frames (or
            # chunks) that follow; a new loop restarts the budget
            self._gba_pending = {"left": self.cfg.loop.gba_total_iters, "kf": kf}
            if self.cfg.loop.gba_slice_iters <= 0:
                self._pump_gba(drain=True)
            self._last_loop_kf = kf
            self._consistent_groups = []
            self.loop_log.append({"kf": kf, "cand": cand, "inliers": int(inliers),
                                  "s_corr": s_corr})
            return

    def _pump_gba(self, drain: bool = False) -> None:
        """Run pending global-BA work: one slice of `gba_slice_iters` LM
        iterations per call, so a frame never waits for more, until the
        loop's `gba_total_iters` are spent; then the group-wide
        SearchAndFuse. `drain=True` (trajectory export, shutdown, or
        `gba_slice_iters <= 0`) finishes the whole budget now."""
        while self._gba_pending is not None:
            slice_iters = self.cfg.loop.gba_slice_iters
            if slice_iters <= 0 or drain:
                slice_iters = max(self.cfg.loop.gba_total_iters, 1)
            with self.timer.stage("global_ba_slice"):
                self.map = global_ba(self.cfg, self.cam, self.map, slice_iters)
            self._gba_slices_run += 1
            self._gba_pending["left"] -= slice_iters
            if self._gba_pending["left"] <= 0:
                kf = torch.full((), self._gba_pending["kf"], dtype=torch.int32,
                                device=self.device)
                self.map = search_and_fuse(self.cfg, self.cam, self.map, kf,
                                           self.cfg.mapping.fuse_neighbors)
                self._gba_pending = None
            if not drain:
                break

    def flush_stats(self) -> None:
        """Resolve the deferred per-frame device stats and keyframe ids,
        and write the records not yet logged to the JSONL log."""
        if any(isinstance(k, torch.Tensor) for _, k in self.kf_log):
            self.kf_log = [(t, int(k)) for t, k in self.kf_log]
        pending = [r for r in self.stats if "_dev" in r]
        if pending:
            vals = torch.stack([r.pop("_dev") for r in pending]).cpu().numpy()
            for r, row in zip(pending, vals):
                for key, v in zip(self._DEV_STAT_KEYS, row):
                    r[key] = bool(v) if key in ("rescued", "ref_fallback") else int(v)
        if self._log_fh is not None:
            for r in self.stats[self._n_logged:]:
                self._log_fh.write(json.dumps(r) + "\n")
            self._n_logged = len(self.stats)

    def _warn_if_at_capacity(self) -> None:
        """Say once, loudly, when the keyframe or live-point capacity is
        full: further insertions are dropped."""
        if self._capacity_warned:
            return
        # one host read: n_points is a high-water mark (slots are
        # recycled), so the live count decides
        n_kf, n_pt, n_alive = torch.stack([
            self.map.n_kfs, self.map.n_points,
            torch.sum(self.map.p_alive, dtype=torch.int32)]).tolist()
        full_kf = n_kf >= self.cfg.map.max_keyframes
        full_pt = n_pt >= self.cfg.map.max_points and n_alive >= self.cfg.map.max_points
        if full_kf or full_pt:
            what = "keyframe" if full_kf else "point"
            msg = (f"lc_crf_slam_torch: {what} capacity reached "
                   f"(kfs={n_kf}/{self.cfg.map.max_keyframes}, live points "
                   f"{'saturated' if full_pt else 'ok'}/{self.cfg.map.max_points}); "
                   "new insertions will be dropped — raise MapConfig capacities")
            print(msg, file=sys.stderr)
            self.stats.append({"event": "capacity_full", "detail": msg})
            self._capacity_warned = True

    # ----------------------------------------------------------- trajectory
    def get_trajectory(self):
        """Per-frame (timestamps, Twc): each stored relative pose composed
        with its reference keyframe's current pose (SaveTrajectoryTUM), so
        frames tracked before a loop closure inherit the corrected keyframe
        poses. Finishes a pending global BA first."""
        self._pump_gba(drain=True)
        if not self.trajectory:
            return np.zeros((0,)), np.zeros((0, 4, 4))
        ts = np.array([t for t, _, _ in self.trajectory])
        Tcr_all = _to_host([T for _, T, _ in self.trajectory])
        refs = _to_host([r for _, _, r in self.trajectory])
        kf_Tcw = self.map.kf_Tcw.cpu().numpy()
        kf_alive = self.map.kf_alive.cpu().numpy()
        kf_anchor = self.map.kf_anchor.cpu().numpy()
        kf_Tca = self.map.kf_Tca.cpu().numpy()
        poses = np.empty((len(ts), 4, 4))
        for k, (Tcr, r) in enumerate(zip(Tcr_all.astype(np.float64), refs)):
            r = int(r)
            hops = 0
            while r >= 0 and not kf_alive[r] and kf_anchor[r] >= 0 \
                    and hops < len(kf_Tcw):
                Tcr = Tcr @ kf_Tca[r]
                r = int(kf_anchor[r])
                hops += 1
            Tcw = Tcr @ (kf_Tcw[r] if r >= 0 else np.eye(4))
            R, t = Tcw[:3, :3], Tcw[:3, 3]
            poses[k, :3, :3] = R.T
            poses[k, :3, 3] = -R.T @ t
            poses[k, 3] = (0.0, 0.0, 0.0, 1.0)
        return ts, poses

    def save_trajectory_tum(self, path: str) -> None:
        ts, poses = self.get_trajectory()
        write_trajectory_tum(path, ts, poses)

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        """SaveKeyFrameTrajectoryTUM: the live keyframes' poses."""
        self._pump_gba(drain=True)
        n = int(self.map.n_kfs)
        alive = self.map.kf_alive[:n].cpu().numpy()
        Twc = se3_inverse(self.map.kf_Tcw[:n]).cpu().numpy()[alive]
        times = self.map.kf_time[:n].cpu().numpy()[alive]
        write_trajectory_tum(path, times, Twc)

    def restore(self, m: MapState, ts: TrackState, trajectory: Sequence = (),
                kf_log: Sequence = ()) -> None:
        """Continue from a checkpoint (`utils/checkpoint.load_checkpoint`):
        its map, tracking state and per-frame records. The frame count,
        which seeds each frame's draws, is the trajectory's length, so a
        resumed run draws as the uninterrupted one; the previous image is
        not in a checkpoint, so the first resumed frame runs no flow
        evidence."""
        self.map, self.ts = m, ts
        self.initialized = True
        self.trajectory, self.kf_log = list(trajectory), list(kf_log)
        self._n_frames = len(self.trajectory)

    def set_localization_mode(self, enabled: bool) -> None:
        """System::ActivateLocalizationMode / DeactivateLocalizationMode:
        while enabled, frames track against the frozen map: no keyframe
        insertion, so no mapping pass and no loop closing, and the map's
        keyframes and live points cannot change. Point statistics and CRF
        labels still update, as in the reference."""
        self._localization_only = enabled

    def shutdown(self) -> None:
        """Finish a pending global BA, resolve the deferred stats, write
        them to the log and close it."""
        self._pump_gba(drain=True)
        self.flush_stats()
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None
