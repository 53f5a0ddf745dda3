"""System facade: the user-facing SLAM object (counterpart of
lc_crf_slam_tpu/models/system.py).

This port runs the RGB-D tracking thread with keyframe insertion: the
reference's `SLAMSystem(cam, cfg, enable_mapping=False, enable_crf=False)`
with `cfg.loop.enabled=False`, driven through `track_rgbd`. Local mapping,
the CRF labeler, loop closing and relocalisation are not ported yet; a
configuration that asks for one of them raises `NotImplementedError`.
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from .._ops import take_row
from ..config import SLAMConfig
from ..geometry.camera import Pinhole
from ..geometry.se3 import se3_inverse
from ..utils.io_tum import write_trajectory_tum
from .ba import draw_consensus
from .frame import Frame, build_frame
from .mapstate import MapState, empty_map
from .tracking import (
    TrackState,
    empty_track_state,
    initialize_map,
    insert_keyframe,
    track_step,
)


_AUDIT_SEED = 17   # the reference keys its audit draws with PRNGKey(17)


def _check_ported(cam: Pinhole, cfg: SLAMConfig, enable_mapping: bool,
                  enable_crf: bool) -> None:
    missing = []
    if enable_mapping:
        missing.append("local mapping (enable_mapping=True)")
    if enable_crf:
        missing.append("the CRF labeler (enable_crf=True)")
    if cfg.loop.enabled:
        missing.append("loop closing (cfg.loop.enabled)")
    if cfg.orb.descriptor_variant != "matmul":
        missing.append(f"descriptor_variant={cfg.orb.descriptor_variant!r}")
    if cam.has_distortion:
        missing.append("keypoint undistortion (camera has distortion terms)")
    if missing:
        raise NotImplementedError(
            "not ported to lc_crf_slam_torch yet: " + "; ".join(missing))


class SLAMSystem:
    """Single-session RGB-D SLAM on one device.

    `device` defaults to CUDA and raises if no card is present; the CPU
    runs only when asked for (`device="cpu"`), as the tests do.
    """

    def __init__(self, cam: Pinhole, cfg: Optional[SLAMConfig] = None,
                 enable_mapping: bool = True,
                 enable_crf: Optional[bool] = None,
                 device: str | torch.device = "cuda"):
        self.cam = cam
        self.cfg = cfg or SLAMConfig()
        self.enable_mapping = enable_mapping
        self.enable_crf = self.cfg.crf.enabled if enable_crf is None else enable_crf
        _check_ported(cam, self.cfg, self.enable_mapping, self.enable_crf)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SLAMSystem(device='cuda'): no CUDA device; pass "
                    "device='cpu' to run on the CPU")
            # descriptor bits threshold a 1521-term f32 dot at 0.1: no TF32
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
        self.stats: List[dict] = []
        self._n_frames = 0

    # ------------------------------------------------------------------ api
    def track_rgbd(self, gray, depth, timestamp: float) -> torch.Tensor:
        """Process one RGB-D frame ((H, W) grayscale 0-255 and depth in
        metres, numpy or tensor); returns Tcw (4, 4) on the device."""
        gray, depth = self._upload(gray), self._upload(depth)
        frame = build_frame(self.cam, self.cfg, gray, depth)
        return self._track_frame(frame, timestamp)

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

    def _track_frame(self, frame: Frame, timestamp: float) -> torch.Tensor:
        t0 = time.perf_counter()
        t_dev = torch.full((), timestamp, dtype=torch.float32, device=self.device)
        dev_stats = None
        if not self.initialized:
            self.map, self.ts = initialize_map(
                self.cfg, self.cam, self.map, frame, t_dev)
            self.initialized = True
            info_host = {"event": "init"}
        else:
            self.ts, self.map, info = track_step(
                self.cfg, self.cam, self.map, self.ts, frame, self._sampler())
            # the one device->host read of the frame: the control scalars
            need_kf, status, n_kfs = torch.stack(
                [info.need_kf.to(torch.int32), self.ts.status,
                 self.map.n_kfs]).tolist()
            if status == 2 and n_kfs >= 2:
                # the reference relocalises here; the port keeps LOST
                warnings.warn(
                    f"frame {self._n_frames}: tracking lost and relocalisation "
                    "is not ported yet; staying lost", RuntimeWarning)
            if need_kf:
                self.map, self.ts = insert_keyframe(
                    self.cfg, self.cam, self.map, self.ts, frame, info.obs,
                    t_dev, info.near_map)
            dev_stats = torch.stack([
                info.n_mm_matches, info.n_inliers, info.n_local_matches,
                info.rescued.to(torch.int32), info.ref_fallback.to(torch.int32),
                self.map.n_points, self.map.n_kfs])
            info_host = {"need_kf": bool(need_kf), "status": status}
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

    _DEV_STAT_KEYS = ("n_mm_matches", "n_inliers", "n_local_matches",
                      "rescued", "ref_fallback", "n_points", "n_kfs")

    def flush_stats(self) -> None:
        """Resolve the deferred per-frame device stats into the records."""
        pending = [r for r in self.stats if "_dev" in r]
        if pending:
            vals = torch.stack([r.pop("_dev") for r in pending]).cpu().numpy()
            for r, row in zip(pending, vals):
                for key, v in zip(self._DEV_STAT_KEYS, row):
                    r[key] = bool(v) if key in ("rescued", "ref_fallback") else int(v)

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
