"""System facade: the user-facing SLAM object (counterpart of
lc_crf_slam_tpu/models/system.py).

`track_rgbd` runs the reference's per-frame pipeline (`_track_frame`):
tracking, relocalisation when tracking is lost and the map holds two
keyframes, keyframe insertion behind the backward-flow spawn gate, local
mapping on every new keyframe, the forward-flow evidence EMA and the CRF
labeler on every frame. Loop closing, the chunked `track_sequence`, the
stereo and monocular entry points, the "direct" descriptor and lens
distortion are not ported yet; a configuration that asks for one of them
raises `NotImplementedError`.

A frame reads the device once (the keyframe decision and the tracking
status); a keyframe frame reads it once more for the capacity warning,
and a relocalisation attempt twice more.
"""

from __future__ import annotations

import functools
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .._ops import scatter_set, take_row
from ..config import SLAMConfig
from ..geometry.camera import Pinhole
from ..geometry.se3 import se3_inverse
from ..ops.lk_flow import lk_track
from ..ops.pnp import uniform_sampler
from ..utils.io_tum import write_trajectory_tum
from .ba import draw_consensus
from .crf import crf_step
from .frame import Frame, build_frame
from .loopclosing import relocalize
from .mapping import mapping_step
from .mapstate import MapState, empty_map
from .tracking import (
    TrackState,
    empty_track_state,
    initialize_map,
    insert_keyframe,
    track_step,
)


_AUDIT_SEED = 17   # the reference keys its audit draws with PRNGKey(17)
_RELOC_SEED = 7    # ... and its relocalisation draws with PRNGKey(7)


def _check_ported(cam: Pinhole, cfg: SLAMConfig) -> None:
    missing = []
    if cfg.loop.enabled:
        missing.append("loop closing (cfg.loop.enabled)")
    if cfg.orb.descriptor_variant != "matmul":
        missing.append(f"descriptor_variant={cfg.orb.descriptor_variant!r}")
    if cam.has_distortion:
        missing.append("keypoint undistortion (camera has distortion terms)")
    if missing:
        raise NotImplementedError(
            "not ported to lc_crf_slam_torch yet: " + "; ".join(missing))


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
    ids = torch.clamp(last_obs, min=0).long()
    uv_pred, z = _project(cam, Tcw_new, m.p_xyz[ids])
    ferr = torch.linalg.norm(res.uv_next - uv_pred, dim=-1)
    ok = use & res.ok & (z > 0.05)
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


class SLAMSystem:
    """Single-session RGB-D SLAM on one device.

    `device` defaults to CUDA and raises if no card is present; the CPU
    runs only when asked for (`device="cpu"`), as the tests do.
    `n_mapping_steps` and `n_crf_steps` count the stage calls.
    """

    def __init__(self, cam: Pinhole, cfg: Optional[SLAMConfig] = None,
                 enable_mapping: bool = True,
                 enable_crf: Optional[bool] = None,
                 device: str | torch.device = "cuda"):
        self.cam = cam
        self.cfg = cfg or SLAMConfig()
        self.enable_mapping = enable_mapping
        self.enable_crf = self.cfg.crf.enabled if enable_crf is None else enable_crf
        _check_ported(cam, self.cfg)
        self.device = torch.device(device)
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
        self.reset()

    def reset(self) -> None:
        """System::Reset — clear the map and tracking state."""
        self.map: MapState = empty_map(self.cfg, self.device)
        self.ts: TrackState = empty_track_state(self.cfg, self.device)
        self.initialized = False
        # (t, Tcr, ref_kf): frame pose relative to its reference keyframe,
        # device tensors resolved lazily in get_trajectory()
        self.trajectory: List[tuple] = []
        self.kf_log: List[tuple] = []        # (t, kf index)
        self.stats: List[dict] = []
        self._n_frames = 0
        self._capacity_warned = False
        self._last_gray: Optional[torch.Tensor] = None
        self._last_Tcw: Optional[torch.Tensor] = None
        self.n_mapping_steps = 0
        self.n_crf_steps = 0

    # ------------------------------------------------------------------ api
    def track_rgbd(self, gray, depth, timestamp: float) -> torch.Tensor:
        """Process one RGB-D frame ((H, W) grayscale 0-255 and depth in
        metres, numpy or tensor); returns Tcw (4, 4) on the device."""
        gray, depth = self._upload(gray), self._upload(depth)
        frame = build_frame(self.cam, self.cfg, gray, depth)
        return self._track_frame(frame, timestamp, gray)

    def _upload(self, img) -> torch.Tensor:
        """Host image -> contiguous float32 on the device; from pinned
        memory and asynchronous, so the upload does not stall the host."""
        t = torch.as_tensor(img, dtype=torch.float32).contiguous()
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

    # stat names packed into the deferred per-frame device vector
    _DEV_STAT_KEYS = ("n_mm", "n_inliers", "n_local", "rescued", "ref_fallback",
                      "n_dynamic", "crf_tracks", "n_points", "n_kfs")

    def _track_frame(self, frame: Frame, timestamp: float,
                     gray: Optional[torch.Tensor] = None) -> torch.Tensor:
        t0 = time.perf_counter()
        cfg, cam = self.cfg, self.cam
        t_dev = torch.full((), timestamp, dtype=torch.float32, device=self.device)
        prev_gray = self._last_gray
        prev_uv, prev_obs, prev_valid = self.ts.last_uv, self.ts.last_obs, self.ts.last_valid
        dev_stats = None
        if not self.initialized:
            self.map, self.ts = initialize_map(cfg, cam, self.map, frame, t_dev)
            self.initialized = True
            info_host = {"event": "init"}
        else:
            self.ts, self.map, info = track_step(
                cfg, cam, self.map, self.ts, frame, self._sampler())
            # the one device->host read of the frame: the control scalars
            need_kf, status, n_kfs = torch.stack(
                [info.need_kf.to(torch.int32), self.ts.status,
                 self.map.n_kfs]).tolist()
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
                self.map, self.ts = insert_keyframe(
                    cfg, cam, self.map, self.ts, frame, info.obs, t_dev,
                    info.near_map, flow_dyn)
                if self.enable_mapping:
                    self.map = mapping_step(cfg, cam, self.map, self.ts.ref_kf)
                    self.n_mapping_steps += 1
                self.kf_log.append((timestamp, self.ts.ref_kf))
                self._warn_if_at_capacity()
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

    def flush_stats(self) -> None:
        """Resolve the deferred per-frame device stats and keyframe ids."""
        if any(isinstance(k, torch.Tensor) for _, k in self.kf_log):
            self.kf_log = [(t, int(k)) for t, k in self.kf_log]
        pending = [r for r in self.stats if "_dev" in r]
        if pending:
            vals = torch.stack([r.pop("_dev") for r in pending]).cpu().numpy()
            for r, row in zip(pending, vals):
                for key, v in zip(self._DEV_STAT_KEYS, row):
                    r[key] = bool(v) if key in ("rescued", "ref_fallback") else int(v)

    def _warn_if_at_capacity(self) -> None:
        """Say once, loudly, when the keyframe or live-point capacity is
        full: further insertions are dropped."""
        if self._capacity_warned:
            return
        n_kf, n_pt = torch.stack([self.map.n_kfs, self.map.n_points]).tolist()
        full_kf = n_kf >= self.cfg.map.max_keyframes
        # n_points is a high-water mark (slots are recycled): check the
        # live count only once saturation is possible
        full_pt = n_pt >= self.cfg.map.max_points and \
            int(torch.sum(self.map.p_alive)) >= self.cfg.map.max_points
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
        with its reference keyframe's current pose (SaveTrajectoryTUM)."""
        if not self.trajectory:
            return np.zeros((0,)), np.zeros((0, 4, 4))
        ts = np.array([t for t, _, _ in self.trajectory])
        Tcr_all = torch.stack([T for _, T, _ in self.trajectory]).cpu().numpy()
        refs = torch.stack([r for _, _, r in self.trajectory]).cpu().numpy()
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
        n = int(self.map.n_kfs)
        alive = self.map.kf_alive[:n].cpu().numpy()
        Twc = se3_inverse(self.map.kf_Tcw[:n]).cpu().numpy()[alive]
        times = self.map.kf_time[:n].cpu().numpy()[alive]
        write_trajectory_tum(path, times, Twc)
