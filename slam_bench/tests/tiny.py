"""A checkout of the benchmark in a temporary directory, cut to a size
the CPU runs in seconds: the real traffic and metric readers, and one
cell of the walking deployment at QVGA with small map arrays and 5-frame
sessions, held to the walking cell's limits but the CRF's labels."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
CELL = "tiny.perframe"


def tiny_config() -> dict:
    with open(os.path.join(BENCH, "configs", "tum3_walking_rgbd.json")) as fh:
        conf = json.load(fh)
    conf["name"] = "tiny_walking"
    conf["camera"] = {"fx": 268.0, "fy": 270.0, "cx": 160.0, "cy": 120.0,
                      "width": 320, "height": 240, "bf": 20.0}
    conf["slam"].update({"orb.max_keypoints": 512, "orb.n_features": 500,
                         "map.max_points": 4096, "map.max_features": 512,
                         "map.max_keyframes": 16})
    # the line trajectory over 20 frames, not 60: a 5-frame session then
    # moves ~20 cm, so a pose that never moves reads far past the ATE limit
    conf["world"].update({"n_static": 800, "n_frames": 20})
    conf["session_frames"] = 5
    conf["compare_frames"] = 2
    # the CRF's labels: too few points on the mover in 5 frames
    del conf["checks"]["crf_contrast"]
    return conf


def make_root(tmp: str, conf: dict = None) -> str:
    """A checkout under `tmp` holding BENCHMARK.json with the one tiny
    cell and the benchmark's own traffic and metric files; returns it."""
    root = os.path.join(tmp, "checkout")
    for sub in ("traffic", "entries", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(root, "slam_bench", sub))
    os.makedirs(os.path.join(root, "slam_bench", "configs"))
    conf = conf or tiny_config()
    with open(os.path.join(root, "slam_bench", "configs", "tiny.json"), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"] = [{"name": conf["name"], "source": "test", "why": "test",
                         "file": "slam_bench/configs/tiny.json", "reduced": []}]
    bench["workloads"] = [{"name": CELL, "config": conf["name"], "traffic": "perframe",
                           "chips": 1, "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [CELL]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root
