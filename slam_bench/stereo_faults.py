"""Faults planted in the stereo row match, for the readings that the stereo
cell's limits are set from: `calibrate.py` with these variants added to
`faults.VARIANTS`. The benchmark's own runs never run this.

    python3 slam_bench/stereo_faults.py --workload euroc.perframe \
        --seeds 1,2,3 --variants stereo_depth_scaled,stereo_depth_third,tf32 \
        --variant-seeds 4,5,6 --frames 81,100 [--jobs J] [--out PATH]

takes `calibrate.py`'s arguments. Each variant patches the program's
`stereo_match` where `build_frames` calls it, so the depth of a matched
left keypoint, and with it its uR, is wrong where it is produced:
- `stereo_depth_scaled`: every depth 5% long (a baseline 5% off);
- `stereo_depth_third`: every third depth 10% long (a third of the map
  misplaced).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slam_bench import calibrate, faults  # noqa: E402


def _deeper_match(every: int, scale: float):
    """A variant: every `every`-th matched depth `scale` times as long."""
    def wrap(match):
        def deeper(cam, uv_l, *args, **kwargs):
            import torch

            u_right, depth = match(cam, uv_l, *args, **kwargs)
            pick = torch.arange(depth.shape[0], device=depth.device) % every == 0
            has = (depth > 0) & pick
            depth = torch.where(has, depth * scale, depth)
            u_right = torch.where(has, uv_l[:, 0] - cam.bf / torch.where(has, depth, 1.0),
                                  u_right)
            return u_right, depth
        return deeper

    def variant(slam):
        return faults.patched("lc_crf_slam_torch.models.frame", "stereo_match", wrap)
    return variant


VARIANTS = {"stereo_depth_scaled": _deeper_match(1, 1.05),
            "stereo_depth_third": _deeper_match(3, 1.10)}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    faults.VARIANTS.update(VARIANTS)
    opts = dict(zip(argv[::2], argv[1::2]))
    jobs = int(opts.get("--jobs", 1))
    if jobs == 1 or "--part" in opts:
        return calibrate.main(argv)
    # calibrate.py's parts would start without these variants: start ours
    out = opts.get("--out", os.path.join("build", "slam_bench", "calibrate.jsonl"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv,
                               "--part", str(i)], env=env) for i in range(jobs)]
    for p in procs:
        p.wait()
    rows = []
    for i in range(jobs):
        path = f"{out}.{i}"
        if os.path.exists(path):
            with open(path) as fh:
                rows += [json.loads(line) for line in fh if line.strip()]
    print("summary " + json.dumps(calibrate.summary(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
