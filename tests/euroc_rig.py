"""ORB-SLAM2's published settings for the EuRoC MAV stereo rig
(`Examples/Stereo/EuRoC.yaml`; Burri et al., IJRR 2016): the rectified
752x480 pair's calibration, the ORB extractor at 1200 features with a
keypoint capacity of 1200 (above the default 1024), and the tracking
settings; the scene the stereo tests render for it; and the cut of the
rig the CPU tests run, half its pixels with the same baseline. Imports
neither package: each test builds its own package's configuration from
these settings."""

import dataclasses

# fx = fy, cx, cy [px], the pair's size, bf = baseline 0.110 m * fx
CAMERA = dict(fx=435.2047, fy=435.2047, cx=367.4517, cy=252.2009, width=752, height=480,
              bf=47.9064)
FPS = 20.0
SLAM = {
    "orb.n_features": 1200, "orb.scale_factor": 1.2, "orb.n_levels": 8,
    "orb.ini_th_fast": 20, "orb.min_th_fast": 7, "orb.cell_size": 16,
    "orb.edge_margin": 19, "orb.max_keypoints": 1200,
    "tracking.th_depth": 35.0, "tracking.max_frames_between_kf": 20,
    "crf.enabled": False, "loop.enabled": True, "loop.fix_scale": True,
    "map.max_features": 1200,
}
# a static orbit of 1400 textured points, 1 px of rendering noise
WORLD = dict(seed=0, render_px_noise=1.0, render_depth_noise=0.015, n_static=1400,
             n_dynamic=0, n_frames=80, trajectory="orbit")


def camera(scale: float = 1.0) -> dict:
    """The rig at `scale` of its pixels a side: fx, fy, cx, cy and bf
    scaled with it, so the baseline stays 0.110 m."""
    cam = dict(CAMERA)
    for key in ("fx", "fy", "cx", "cy", "bf"):
        cam[key] *= scale
    cam["width"], cam["height"] = round(cam["width"] * scale), round(cam["height"] * scale)
    return cam


def slam_config(cfg, **overrides):
    """`cfg` (either package's `SLAMConfig`) with the rig's settings and
    `overrides` replacing its sections' fields."""
    sections: dict = {}
    for key, val in {**SLAM, **overrides}.items():
        sec, name = key.split(".", 1)
        sections.setdefault(sec, {})[name] = val
    return cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kv)
                          for sec, kv in sections.items()})


def orb() -> dict:
    """The ORB extractor's settings without their section."""
    return {k.split(".", 1)[1]: v for k, v in SLAM.items() if k.startswith("orb.")}
