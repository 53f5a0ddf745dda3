"""The stereo cell's pieces on the CPU: the EuRoC deployment cut to a
tiny size through its entry `track_stereo`, the stereo faults, and the
entry's refusal of a program whose front end of a pair the frame tap
cannot see."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from slam_bench import session, spec, stereo_faults
from slam_bench.tests import tiny

SEED = 2**31 + 4321


def tiny_stereo_config() -> dict:
    """The EuRoC stereo deployment cut as the tiny RGB-D cell is: its rig
    at half its pixels (376x240, the same baseline), small map arrays and
    capacity, 5-pair sessions on the orbit over 20 frames (a session then
    moves ~10 cm)."""
    with open(os.path.join(tiny.BENCH, "configs", "euroc_stereo.json")) as fh:
        conf = json.load(fh)
    conf["name"] = "tiny_stereo"
    for key in ("fx", "fy", "cx", "cy", "bf"):
        conf["camera"][key] /= 2
    conf["camera"].update({"width": 376, "height": 240})
    conf["slam"].update({"orb.max_keypoints": 512, "orb.n_features": 500,
                         "map.max_points": 4096, "map.max_features": 512,
                         "map.max_keyframes": 16})
    conf["world"]["n_frames"] = 20
    conf["session_frames"] = 5
    conf["compare_frames"] = 2
    return conf


def stereo_root(tmp: str) -> str:
    """A tiny checkout whose one cell hands pairs to `track_stereo`."""
    root = tiny.make_root(tmp, tiny_stereo_config())
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["workloads"][0]["traffic"] = "stereo_perframe"
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return stereo_root(str(tmp_path_factory.mktemp("stereo")))


@pytest.mark.parametrize("variant", [None, "stale_state"])
def test_stereo_run_through_its_entry(root, monkeypatch, variant):
    """A sound run is correct, with the left eyes of the sampled pairs
    held to the plain front end; a pose that never moves is not; a traced
    run reads the stereo front end's spans."""
    from lc_crf_slam_torch.models.system import SLAMSystem

    pairs = []
    original = SLAMSystem.track_stereo

    def counted(self, left, right, t):
        pairs.append((left.shape, right.shape))
        return original(self, left, right, t)

    monkeypatch.setattr(SLAMSystem, "track_stereo", counted)
    r = session.run(root, tiny.CELL, SEED, 0.0, variant is None, time.perf_counter(),
                    device="cpu", variant=variant, frames=5, log=lambda s: None)
    assert list(r["checks"]) == ["kp_diff", "desc_bits", "ate_m", "map_rel_q50",
                                 "loop_missed"]
    assert r["attempted"] >= 3 and r["failed"] == 0
    assert set(pairs) == {((240, 376), (240, 376))}
    assert r["correct"] is (variant is None), r["checks"]
    if variant is None:
        # the frame tap kept the sampled pairs' left eyes, equal to the plain ones
        assert r["checks"]["kp_diff"]["value"] == 0.0
        assert r["checks"]["desc_bits"]["value"] == 0.0
        assert {"stereo_extract_ms", "stereo_match_ms", "frontend_ms"} <= set(r["metrics"])


def test_stereo_faults_lengthen_the_matched_depths():
    """Each stereo fault lengthens the matched depths it picks, by its
    scale, and moves their uR to agree; the rest stay as they were."""
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.geometry.camera import Pinhole
    from lc_crf_slam_torch.models.frame import build_frames
    from slam_bench.world import Pinhole as WorldPinhole, SyntheticWorld

    conf = tiny_stereo_config()
    world = SyntheticWorld(cam=WorldPinhole(**conf["camera"]), **conf["world"])
    f = world.frame(0, render=True)
    left = torch.as_tensor(f.image, dtype=torch.float32)[None]
    right = torch.as_tensor(world.right_eye(0), dtype=torch.float32)[None]
    cam = Pinhole(**conf["camera"])
    cfg = SLAMConfig()

    sound = build_frames(cam, cfg, left, None, right)[0]
    has = sound.depth > 0
    assert int(has.sum()) > 50
    for name, every, scale in (("stereo_depth_scaled", 1, 1.05),
                               ("stereo_depth_third", 3, 1.10)):
        with stereo_faults.VARIANTS[name](None):
            bad = build_frames(cam, cfg, left, None, right)[0]
        pick = has & (torch.arange(has.shape[0]) % every == 0)
        torch.testing.assert_close(bad.depth[pick], sound.depth[pick] * scale)
        torch.testing.assert_close(bad.depth[~pick], sound.depth[~pick])
        bf = (bad.uv[pick, 0] - bad.u_right[pick]) * bad.depth[pick]
        torch.testing.assert_close(bf, torch.full_like(bf, cam.bf), rtol=1e-4, atol=0)


def test_the_entry_refuses_a_front_end_the_tap_cannot_see(root, monkeypatch):
    """Where the program's `build_frames` takes no right eye, the stereo
    front end runs where the frame tap keeps nothing, so `kp_diff` could
    not be read: loading the entry stops the run at once."""
    from lc_crf_slam_torch.models import frame

    spec.entry(root, "track_stereo")            # the program as it is: loads
    monkeypatch.setattr(frame, "build_frames", lambda cam, cfg, grays, depth_imgs: [])
    with pytest.raises(RuntimeError, match="right eye"):
        spec.entry(root, "track_stereo")


def test_the_stereo_cell_resolves():
    """The benchmark's stereo cell: its configuration, its mix's entry,
    and a reader for each metric it reports."""
    bench = spec.benchmark(tiny.REPO)
    cell = spec.cell(bench, "euroc.perframe")
    conf = spec.config(tiny.REPO, bench, cell["config"])
    assert conf["name"] == "euroc_stereo" and conf["slam"]["orb.max_keypoints"] >= 1200
    assert np.isclose(conf["camera"]["bf"] / conf["camera"]["fx"], 0.110, atol=1e-4)
    mix = spec.traffic(tiny.REPO, cell["traffic"])
    assert mix["entry"] == "track_stereo" and callable(mix["module"].hand_in)
    for trace in (False, True):
        entries = spec.metrics(bench, cell["name"], trace)
        assert set(spec.readers(tiny.REPO, entries)) == {m["name"] for m in entries}
    names = {m["name"] for m in spec.metrics(bench, cell["name"], True)}
    assert {"stereo_extract_ms", "stereo_match_ms", "host_syncs", "device_idle"} <= names
    assert not {"crf_ms", "fast_cell_best.roofline"} & names
