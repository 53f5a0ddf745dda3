"""Synthetic RGB-D sequence generation with exact ground truth.

A numpy-only copy of lc_crf_slam_tpu/utils/synthetic.py (which the port
cannot import: the reference's geometry package imports jax). It differs
only in importing the port's `Pinhole` and in writing the PNGs of
`export_tum_sequence` with `utils/png.py` (the reference uses cv2);
rendered images and depth are bit-identical to the reference's
(tests/test_torch_synthetic.py).

The reference had no tests (SURVEY.md §5); its de-facto test was running
TUM sequences. With no dataset in this environment, this module is the
test bed: scripted camera trajectories over random static point clouds
with optional moving (dynamic) clusters, producing
  - exact ground-truth trajectories,
  - direct feature observations (keypoints + descriptors + depth) for
    pipeline tests that bypass the image front-end, and
  - rendered grayscale/depth images (dot splats + textured background)
    for front-end (FAST/ORB) tests.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..geometry.camera import Pinhole  # the port's own (no jax)


@dataclass
class SyntheticFrame:
    timestamp: float
    T_cw: np.ndarray                  # (4,4) world->camera ground truth
    uv: np.ndarray                    # (M,2) observed pixels (with noise)
    depth: np.ndarray                 # (M,) measured depth (with noise)
    desc: np.ndarray                  # (M,8) uint32 observed descriptors
    point_id: np.ndarray              # (M,) world point index (GT assoc)
    is_dynamic: np.ndarray            # (M,) bool GT dynamic label
    image: Optional[np.ndarray] = None       # (H,W) float32 grayscale
    depth_image: Optional[np.ndarray] = None  # (H,W) float32 meters


@dataclass
class SyntheticWorld:
    """Static cloud + moving clusters + scripted camera."""

    cam: Pinhole
    n_static: int = 600
    n_dynamic: int = 120
    n_frames: int = 60
    seed: int = 0
    pixel_noise: float = 0.3
    depth_noise: float = 0.01
    desc_flip_prob: float = 0.02      # per-bit observation noise
    # rendered-image sensor noise (render=True only). The default
    # renderer emits noise-free images and exact depth, under which the
    # rendered pipeline's drift is unrealistically small (fuse windows
    # self-heal every revisit — VERDICT r4 weak #4); real cameras add
    # grayscale read noise and RGB-D depth noise that accumulate into
    # genuine odometry drift.
    render_px_noise: float = 0.0      # grayscale sigma per pixel
    render_depth_noise: float = 0.0   # multiplicative depth sigma
    dynamic_speed: float = 0.04       # m/frame cluster translation
    dynamic_dir: Optional[tuple] = None  # None = random (z damped)
    # Rendered-mode rigid moving object: a fronto-parallel textured plane
    # ("billboard") sweeping through the scene — the synthetic analog of
    # TUM walking_* sequences' person. Unlike the dot-splat dynamic
    # cluster (whose overlapping patches destroy each other's texture),
    # the billboard yields MANY stable, re-matchable dynamic features,
    # which is exactly the coherent-surface case that captures an
    # undefended pose solve. Only affects render=True frames.
    billboard: bool = False
    bb_center0: tuple = (-0.8, 0.0, 2.6)  # world center at frame 0
    bb_size: tuple = (1.2, 1.6)           # (width, height) meters
    bb_speed: float = 0.04                # m/frame
    bb_dir: tuple = (1.0, 0.0, 0.0)       # unit direction (z ignored)
    bb_n_dots: int = 100                  # splat-style feature dots
    trajectory: str = "orbit"         # orbit | line | loop | sweep | pan
    sweep_yaw: float = 1.2            # sweep: max |yaw| (rad); the view
                                      # leaves the start sector entirely
                                      # (FOV ~1.18 rad at TUM intrinsics)
                                      # then returns — a true revisit
    sweep_translation: float = 0.15   # sweep positional amplitude (m);
                                      # raise for monocular runs (mono
                                      # init/triangulation need parallax)
    pan_translation: float = 0.12     # pan positional-drift radius (m);
                                      # raise for monocular runs (a
                                      # near-pure rotation gives mono
                                      # triangulation no baseline)
    pan_leadin: float = 0.0           # fraction of frames spent in a
                                      # translation-only bootstrap leg
                                      # before the pan begins: monocular
                                      # two-view init needs parallax,
                                      # and a pan's yaw outruns the init
                                      # matching window before enough
                                      # baseline accumulates
    pan_turns: float = 1.0            # total pan yaw in turns (2*pi);
                                      # >1 keeps re-viewing the start
                                      # sector after closing the circle,
                                      # giving loop detection the
                                      # multi-keyframe revisit streak
                                      # the reference's consistency
                                      # check requires
    box: tuple = (6.0, 4.0, 4.0)      # world extents (x, y, z)
    # Cylindrical textured-wall render mode (render=True only): instead
    # of per-point dot splats, every pixel samples a fixed two-octave
    # texture by its ray's azimuth/height on a cylinder around the
    # origin. A panning/rotating camera sees the SAME texture from any
    # yaw (dot splats are drawn axis-aligned per frame and their
    # overlap order shuffles under fast pans, which starved the mono
    # image pipeline to ~57 adjacent-KF matches — VERDICT r4 #4). The
    # shell POINTS still exist for observation-level uses; the wall
    # only replaces the rendered image/depth.
    wall: bool = False
    wall_radius: float = 3.0
    rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        bx, by, bz = self.box
        if self.trajectory in ("sweep", "pan"):
            # Cylindrical shell AROUND the camera: the sweep trajectory
            # yaws far enough that a frontal box would leave the view
            # empty mid-sweep; sample points over the swept angular
            # sector instead (fr1_room-style revisit geometry). A "pan"
            # covers the full circle.
            pad = 0.8
            if self.trajectory == "pan":
                phi = self.rng.uniform(-np.pi, np.pi, self.n_static)
            else:
                phi = self.rng.uniform(
                    -self.sweep_yaw - pad, self.sweep_yaw + pad,
                    self.n_static)
            r = self.rng.uniform(2.0, 2.0 + bz, self.n_static)
            self.p_static = np.stack(
                [
                    r * np.sin(phi),
                    self.rng.uniform(-by / 2, by / 2, self.n_static),
                    r * np.cos(phi),
                ],
                axis=-1,
            )
        else:
            # Static cloud in a box in front of the world origin,
            # z in [2, 2+bz]
            self.p_static = np.stack(
                [
                    self.rng.uniform(-bx / 2, bx / 2, self.n_static),
                    self.rng.uniform(-by / 2, by / 2, self.n_static),
                    self.rng.uniform(2.0, 2.0 + bz, self.n_static),
                ],
                axis=-1,
            )
        # Dynamic cluster: compact blob that translates over time
        center = np.array([bx * 0.15, 0.0, 3.0])
        self.p_dyn0 = center + self.rng.normal(0, 0.3, (self.n_dynamic, 3))
        if self.dynamic_dir is not None:
            dirv = np.asarray(self.dynamic_dir, np.float64)
        else:
            dirv = self.rng.normal(0, 1, 3)
            dirv[2] *= 0.2
        self.dyn_dir = dirv / (np.linalg.norm(dirv) + 1e-9)
        # One stable 256-bit descriptor per world point
        n_total = self.n_static + self.n_dynamic
        self.descs = self.rng.integers(
            0, 2**32, size=(n_total, 8), dtype=np.uint32
        )

    # --- camera trajectories -------------------------------------------------
    def gt_pose_twc(self, k: int) -> np.ndarray:
        """Camera-to-world pose at frame k."""
        t = k / max(self.n_frames - 1, 1)
        if self.trajectory == "line":
            pos = np.array([t * 1.0 - 0.5, 0.05 * np.sin(4 * np.pi * t), -0.2 * t])
            yaw = 0.1 * np.sin(2 * np.pi * t)
        elif self.trajectory == "loop":
            ang = 2 * np.pi * t
            pos = np.array([0.6 * np.sin(ang), 0.1 * np.sin(2 * ang), 0.4 * (1 - np.cos(ang))])
            yaw = 0.25 * np.sin(ang)
        elif self.trajectory == "sweep":
            # yaw 0 -> sweep_yaw -> 0 (smooth), small positional bob:
            # the camera looks away from the start sector and returns —
            # the loop-closure revisit scenario (mid-sweep keyframes
            # share no covisibility with the start/end keyframes)
            yaw = self.sweep_yaw * np.sin(np.pi * t)
            a = self.sweep_translation
            pos = np.array([
                a * np.sin(np.pi * t),
                0.27 * a * np.sin(4 * np.pi * t),
                0.67 * a * np.sin(np.pi * t),
            ])
        elif self.trajectory == "pan":
            # full-turn yaw 0 -> 2pi*pan_turns: the END sector IS the
            # start sector but is reached without retracing (the
            # canonical loop-closure geometry — the return cannot
            # reconnect through covisibility, only through loop
            # detection), with a small positional drift circle so the
            # revisit carries real translation error too. An optional
            # translation-only lead-in leg precedes the pan (monocular
            # two-view init needs parallax before yaw accumulates).
            a = self.pan_translation
            L = self.pan_leadin
            if t < L:
                s = t / max(L, 1e-9)
                yaw = 0.0
                pos = np.array([
                    a * (s - 1.0),
                    a / 6.0 * np.sin(2 * np.pi * s),
                    0.0,
                ])
            else:
                s = (t - L) / max(1.0 - L, 1e-9)
                ang = 2.0 * np.pi * self.pan_turns * s
                yaw = ang
                pos = np.array([
                    a * np.sin(ang),
                    a / 3.0 * np.sin(2 * ang),
                    a * (1 - np.cos(ang)),
                ])
        else:  # orbit: small lateral arc, always looking at the cloud
            ang = 0.8 * np.sin(2 * np.pi * t)
            pos = np.array([0.8 * np.sin(ang), 0.1 * np.sin(4 * np.pi * t), 0.3 * (1 - np.cos(ang))])
            yaw = -0.25 * np.sin(ang)
        cy, sy = np.cos(yaw), np.sin(yaw)
        pitch = 0.05 * np.sin(2 * np.pi * t)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = R_yaw @ R_pitch
        T[:3, 3] = pos
        return T

    def points_at(self, k: int) -> np.ndarray:
        """All world points at frame k; dynamic cluster moved."""
        p_dyn = self.p_dyn0 + self.dyn_dir * self.dynamic_speed * k
        return np.concatenate([self.p_static, p_dyn], axis=0)

    # --- observation generation ---------------------------------------------
    def frame(self, k: int, render: bool = False,
              T_wc: np.ndarray | None = None) -> SyntheticFrame:
        """Observations (and optionally a rendered image) at frame k.

        `T_wc` overrides the trajectory pose — e.g. the RIGHT eye of a
        stereo pair: gt_pose_twc(k) composed with a +baseline camera-x
        shift (see tests/test_mono_stereo_e2e.py)."""
        cam = self.cam
        if T_wc is None:
            T_wc = self.gt_pose_twc(k)
        T_cw = np.linalg.inv(T_wc)
        pts_w = self.points_at(k)
        pts_c = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = pts_c[:, 2]
        vis = z > 0.1
        u = cam.fx * pts_c[:, 0] / np.where(vis, z, 1.0) + cam.cx
        v = cam.fy * pts_c[:, 1] / np.where(vis, z, 1.0) + cam.cy
        m = 8.0
        vis &= (u >= m) & (u < cam.width - m) & (v >= m) & (v < cam.height - m)
        ids = np.nonzero(vis)[0]
        uv = np.stack([u[ids], v[ids]], axis=-1)
        uv_noisy = uv + self.rng.normal(0, self.pixel_noise, uv.shape)
        zm = z[ids] * (1 + self.rng.normal(0, self.depth_noise, len(ids)))
        # Descriptor observation noise: flip bits with small probability
        desc = self.descs[ids].copy()
        flips = self.rng.random((len(ids), 256)) < self.desc_flip_prob
        flip_words = np.zeros((len(ids), 8), dtype=np.uint32)
        for w in range(8):
            bits = flips[:, w * 32 : (w + 1) * 32]
            flip_words[:, w] = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(
                axis=-1, dtype=np.uint64
            ).astype(np.uint32)
        desc ^= flip_words
        is_dyn = ids >= self.n_static

        frame = SyntheticFrame(
            timestamp=k / 30.0,
            T_cw=T_cw,
            uv=uv_noisy.astype(np.float32),
            depth=zm.astype(np.float32),
            desc=desc,
            point_id=ids,
            is_dynamic=is_dyn,
        )
        if render:
            if self.wall:
                frame.image, frame.depth_image = self._render_wall(T_wc)
            else:
                frame.image, frame.depth_image = self._render(
                    uv, z[ids], ids)
            if self.billboard:
                self._render_billboard(frame.image, frame.depth_image,
                                       T_wc, k)
            if self.render_px_noise > 0:
                frame.image = np.clip(
                    frame.image + self.rng.normal(
                        0, self.render_px_noise, frame.image.shape),
                    0.0, 255.0,
                ).astype(np.float32)
            if self.render_depth_noise > 0:
                valid = frame.depth_image > 0
                frame.depth_image = np.where(
                    valid,
                    frame.depth_image * (1 + self.rng.normal(
                        0, self.render_depth_noise,
                        frame.depth_image.shape)),
                    frame.depth_image,
                ).astype(np.float32)
        return frame

    def right_eye(self, k: int) -> np.ndarray:
        """Rendered right image of a rectified stereo rig at frame k: the
        trajectory pose shifted by the baseline bf / fx along camera x (the
        rig of tests/test_mono_stereo_e2e.py)."""
        shift = np.eye(4)
        shift[0, 3] = self.cam.bf / self.cam.fx
        return self.frame(k, render=True, T_wc=self.gt_pose_twc(k) @ shift).image

    _PATCH_R = 19  # rendered texture half-width per point (full BRIEF support)

    def _point_texture(self, pid: int) -> np.ndarray:
        """Deterministic per-point texture patch (world-point identity must
        live in the pixels, or descriptors cannot re-identify points
        across frames)."""
        r = self._PATCH_R
        prng = np.random.default_rng(1000 + int(pid))
        # smooth moderate-contrast texture (low-res random, bilinearly
        # upsampled): descriptors need spatial correlation to survive
        # ±1px sampling shifts, and the bright center must stay the
        # strongest FAST corner in its grid cell
        lowres = prng.random((10, 10)).astype(np.float32)
        ys = np.linspace(0, 9, 2 * r + 1)
        xs = np.linspace(0, 9, 2 * r + 1)
        yi0 = np.floor(ys).astype(int); xi0 = np.floor(xs).astype(int)
        yi1 = np.minimum(yi0 + 1, 9); xi1 = np.minimum(xi0 + 1, 9)
        wy = (ys - yi0)[:, None]; wx = (xs - xi0)[None, :]
        tex = (
            lowres[np.ix_(yi0, xi0)] * (1 - wy) * (1 - wx)
            + lowres[np.ix_(yi0, xi1)] * (1 - wy) * wx
            + lowres[np.ix_(yi1, xi0)] * wy * (1 - wx)
            + lowres[np.ix_(yi1, xi1)] * wy * wx
        )
        tex = 70.0 + 60.0 * tex
        # single extreme center pixel: FAST fires (ring at radius 3 is all
        # texture, 70..130, center is far outside that band) while touching
        # so few descriptor samples that it can't correlate different
        # points' descriptors the way a uniform bright block would.
        tex[r, r] = 235.0 if prng.random() < 0.5 else 20.0
        return tex

    @functools.cached_property
    def _wall_tex(self):
        """Two fixed texture octaves for the cylindrical wall."""
        prng = np.random.default_rng(777 + self.seed)
        return (prng.random((64, 512)).astype(np.float32),
                prng.random((192, 1536)).astype(np.float32))

    @staticmethod
    def _tex_bilinear(tex: np.ndarray, yy: np.ndarray, xx: np.ndarray):
        """Periodic bilinear sample of `tex` at float coords (yy, xx)."""
        Hh, Ww = tex.shape
        y0 = np.floor(yy).astype(int)
        x0 = np.floor(xx).astype(int)
        fy = yy - y0
        fx = xx - x0
        y0 %= Hh
        x0 %= Ww
        y1 = (y0 + 1) % Hh
        x1 = (x0 + 1) % Ww
        return (tex[y0, x0] * (1 - fy) * (1 - fx)
                + tex[y0, x1] * (1 - fy) * fx
                + tex[y1, x0] * fy * (1 - fx)
                + tex[y1, x1] * fy * fx)

    def _render_wall(self, T_wc: np.ndarray):
        """Ray-cast the textured cylinder: image + exact depth image."""
        cam = self.cam
        H, W = cam.height, cam.width
        us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        d_c = np.stack([(us - cam.cx) / cam.fx,
                        (vs - cam.cy) / cam.fy,
                        np.ones_like(us)], axis=-1)      # (H, W, 3)
        R_wc = T_wc[:3, :3]
        o = T_wc[:3, 3]
        d_w = d_c @ R_wc.T
        # |o_xz + t d_xz|^2 = R^2, positive root
        a = d_w[..., 0] ** 2 + d_w[..., 2] ** 2
        b = 2.0 * (o[0] * d_w[..., 0] + o[2] * d_w[..., 2])
        c = o[0] ** 2 + o[2] ** 2 - self.wall_radius ** 2
        disc = np.maximum(b * b - 4 * a * c, 1e-12)
        t = (-b + np.sqrt(disc)) / (2 * np.maximum(a, 1e-12))
        pt = o[None, None, :] + t[..., None] * d_w
        theta = np.arctan2(pt[..., 0], pt[..., 2])        # [-pi, pi]
        y = pt[..., 1]
        coarse, fine = self._wall_tex
        u_c = (theta / (2 * np.pi)) * coarse.shape[1]
        v_c = y * (coarse.shape[0] / 4.0)                 # 4 m vertical tile
        u_f = (theta / (2 * np.pi)) * fine.shape[1]
        v_f = y * (fine.shape[0] / 4.0)
        mix = (0.62 * self._tex_bilinear(coarse, v_c, u_c)
               + 0.38 * self._tex_bilinear(fine, v_f, u_f))
        img = (35.0 + 185.0 * mix).astype(np.float32)
        depth = t.astype(np.float32)                      # z-depth (d_cz=1)
        return img, depth

    def _render(self, uv: np.ndarray, z: np.ndarray, ids: np.ndarray):
        """Splat per-point texture patches on a low-contrast background."""
        H, W = self.cam.height, self.cam.width
        r = self._PATCH_R
        rng = np.random.default_rng(12345)  # fixed background
        img = 60.0 + 2.0 * rng.standard_normal((H, W)).astype(np.float32)
        depth_img = np.zeros((H, W), np.float32)
        ui = np.round(uv[:, 0]).astype(int)
        vi = np.round(uv[:, 1]).astype(int)
        # draw far-to-near so closer points overwrite (correct occlusion)
        order = np.argsort(-z)
        for k in order:
            x, y, d, pid = ui[k], vi[k], z[k], ids[k]
            y0, y1 = max(y - r, 0), min(y + r + 1, H)
            x0, x1 = max(x - r, 0), min(x + r + 1, W)
            tex = self._point_texture(pid)
            img[y0:y1, x0:x1] = tex[y0 - (y - r) : y1 - (y - r),
                                    x0 - (x - r) : x1 - (x - r)]
            # depth covers the WHOLE drawn patch (the splat is a physical
            # surface patch): real RGB-D gives depth on nearly every
            # textured pixel, and the close-point keyframe policy +
            # depth-backed point spawning starve when only splat centers
            # carry depth (observed: 130/668 keypoints with depth at QVGA
            # -> map starvation -> LOST mid-sweep)
            depth_img[y0:y1, x0:x1] = d
        return np.clip(img, 0, 255), depth_img

    # --- moving billboard (rendered rigid object) ---------------------------
    def bb_center(self, k: int) -> np.ndarray:
        d = np.asarray(self.bb_dir, np.float64)
        d = d / (np.linalg.norm(d) + 1e-9)
        return np.asarray(self.bb_center0, np.float64) + d * self.bb_speed * k

    def _bb_texture_sample(self, s: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Bilinear sample of a fixed random texture at billboard-frame
        coords (s right, q down). Smooth texture keeps the billboard's
        FAST-corner density comparable to the splat background (a real
        moving person is ~20-30% of a frame's features, not 90% — a
        corner-saturated texture would make the mover the overwhelming
        feature majority and the scenario physically unrepresentative)."""
        if not hasattr(self, "_bb_tex"):
            w, h = self.bb_size
            prng = np.random.default_rng(777)
            self._bb_nc = (max(int(h / 0.11), 2), max(int(w / 0.11), 2))
            self._bb_tex = 50.0 + 160.0 * prng.random(self._bb_nc).astype(
                np.float32)
        w, h = self.bb_size
        nq, ns = self._bb_nc
        fy = np.clip((q + h / 2) / h * (nq - 1), 0, nq - 1 - 1e-6)
        fx = np.clip((s + w / 2) / w * (ns - 1), 0, ns - 1 - 1e-6)
        y0 = fy.astype(int); x0 = fx.astype(int)
        wy = fy - y0; wx = fx - x0
        t = self._bb_tex
        base = (t[y0, x0] * (1 - wy) * (1 - wx)
                + t[y0, x0 + 1] * (1 - wy) * wx
                + t[y0 + 1, x0] * wy * (1 - wx)
                + t[y0 + 1, x0 + 1] * wy * wx)
        # sparse extreme-value dots riding the surface: the same
        # single-extreme-pixel-on-smooth-context recipe the static
        # splats use, so per-feature detectability matches and the
        # billboard's share of frame features is set by its area
        if not hasattr(self, "_bb_dots"):
            prng = np.random.default_rng(778)
            n_dots = max(int(self.bb_n_dots), 0)
            self._bb_dots = np.stack([
                prng.uniform(-w / 2 * 0.92, w / 2 * 0.92, n_dots),
                prng.uniform(-h / 2 * 0.92, h / 2 * 0.92, n_dots),
            ], axis=-1)
            self._bb_dot_val = np.where(
                prng.random(n_dots) < 0.5, 235.0, 15.0)
        if len(self._bb_dots):
            d2 = (
                np.square(s[..., None] - self._bb_dots[None, :, 0])
                + np.square(q[..., None] - self._bb_dots[None, :, 1])
            )
            j = np.argmin(d2, axis=-1)
            near = d2[np.arange(len(j)), j] < 0.006 ** 2
            base = np.where(near, self._bb_dot_val[j], base)
        return base

    def _render_billboard(self, img, depth_img, T_wc: np.ndarray, k: int):
        """Ray-cast the moving plane into (img, depth_img), in place.

        The plane is fronto-parallel in the world (constant world z);
        pixels whose back-projected ray hits the moving rectangle closer
        than any already-drawn splat take its texture and depth."""
        cam = self.cam
        H, W = cam.height, cam.width
        R, c = T_wc[:3, :3], T_wc[:3, 3]
        us, vs = np.meshgrid(
            np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64)
        )
        dirs_c = np.stack(
            [(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
             np.ones_like(us)], axis=-1)
        dirs_w = dirs_c @ R.T
        ctr = self.bb_center(k)
        dz = dirs_w[..., 2]
        t = np.where(np.abs(dz) > 1e-6, (ctr[2] - c[2]) / np.where(
            np.abs(dz) > 1e-6, dz, 1.0), -1.0)
        pw = c + t[..., None] * dirs_w
        w, h = self.bb_size
        s = pw[..., 0] - ctr[0]
        q = pw[..., 1] - ctr[1]
        # camera-frame depth of the hit is exactly t (dirs_c z-component = 1)
        hit = (t > 0.1) & (np.abs(s) < w / 2) & (np.abs(q) < h / 2)
        occl = hit & ((depth_img <= 0) | (t < depth_img))
        img[occl] = self._bb_texture_sample(s[occl], q[occl])
        depth_img[occl] = t[occl].astype(np.float32)

    def bb_gt_dynamic(self, xyz: np.ndarray, margin: float = 0.08,
                      n: Optional[int] = None) -> np.ndarray:
        """GT-dynamic test for reconstructed points: within `margin` of the
        billboard plane and inside the rectangle swept over frames 0..n."""
        n = n or self.n_frames
        c0, c1 = self.bb_center(0), self.bb_center(n - 1)
        lo = np.minimum(c0, c1)
        hi = np.maximum(c0, c1)
        w, h = self.bb_size
        return (
            (np.abs(xyz[:, 2] - c0[2]) < margin)
            & (xyz[:, 0] > lo[0] - w / 2 - margin)
            & (xyz[:, 0] < hi[0] + w / 2 + margin)
            & (xyz[:, 1] > lo[1] - h / 2 - margin)
            & (xyz[:, 1] < hi[1] + h / 2 + margin)
        )

    def export_tum_sequence(self, out_dir: str, n: Optional[int] = None,
                            depth_factor: float = 5000.0) -> None:
        """Write this world as a TUM RGB-D sequence directory (rgb/,
        depth/, rgb.txt, depth.txt, groundtruth.txt), so the dataset path
        (association, PNG decoding, the CLI) runs without the real data.
        Images are the gray rendering replicated to 8-bit RGB, depth
        16-bit at `depth_factor` counts per metre."""
        import os

        import torch

        from ..geometry.se3 import rotmat_to_quat
        from . import png

        n = n or self.n_frames
        os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
        rgb_lines, depth_lines, gt_lines = [], [], []
        for k in range(n):
            f = self.frame(k, render=True)
            t = f.timestamp
            rgb_rel = f"rgb/{t:.6f}.png"
            dep_rel = f"depth/{t:.6f}.png"
            img8 = np.clip(f.image, 0, 255).astype(np.uint8)
            png.imwrite(os.path.join(out_dir, rgb_rel), np.stack([img8] * 3, axis=-1))
            d16 = np.clip(f.depth_image * depth_factor, 0, 65535).astype(np.uint16)
            png.imwrite(os.path.join(out_dir, dep_rel), d16)
            rgb_lines.append(f"{t:.6f} {rgb_rel}")
            depth_lines.append(f"{t:.6f} {dep_rel}")
            Twc = self.gt_pose_twc(k)
            q = rotmat_to_quat(torch.as_tensor(Twc[:3, :3], dtype=torch.float32)).numpy()
            tx, ty, tz = Twc[:3, 3]
            gt_lines.append(
                f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
            )
        for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                            ("groundtruth.txt", gt_lines)):
            with open(os.path.join(out_dir, name), "w") as fh:
                fh.write("# synthetic TUM export\n")
                fh.write("\n".join(lines) + "\n")

    def groundtruth(self):
        ts = np.array([k / 30.0 for k in range(self.n_frames)])
        poses = np.stack([self.gt_pose_twc(k) for k in range(self.n_frames)])
        return ts, poses
