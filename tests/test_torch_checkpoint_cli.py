"""The port's command line (`python -m lc_crf_slam_torch.run_slam`), end to
end on the CPU: the argument parser (tests/test_cli_aux.py's checks), a
QVGA TUM-format sequence exported with its timestamps at Unix seconds
(1305031102.175304 s on), tracked chunked into a checkpoint and resumed
per frame, and a synthetic run on direct observations. Each run must exit
0, write both trajectories and the JSONL log, and print the summary with
the ATE under the reference test's bar (0.5 m on the dataset path, 0.01 m
on synthetic observations); every keyframe time in KeyFrameTrajectory.txt
must be its frame's to 1e-6 s, across the checkpoint too. The comparison
with the reference's CLI on the same 640x480 sequence is `slow`."""

import json
import os

import numpy as np
import pytest
import torch

from lc_crf_slam_torch import run_slam
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.utils.io_tum import read_file_list, read_trajectory_tum
from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

from chip_smoke import shift_sequence
from torch_parity import CAM, assert_poses_close

OFFSET = 1305031102.175304
TIME_TOL_S = 1e-6
SEQ_ATE_BAR_M = 0.5        # tests/test_native_dataset.py's dataset-CLI bar
SYN_ATE_BAR_M = 0.01       # tests/test_cli_aux.py's synthetic bar
SMALL = "orb.max_keypoints: 512\nmap.max_points: 4096\nmap.max_features: 512\n"


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_argparser():
    ap = run_slam.build_argparser()
    with pytest.raises(SystemExit):
        ap.parse_args([])       # neither --seq nor --synthetic
    args = ap.parse_args(["--synthetic", "--frames", "5"])
    assert args.frames == 5 and args.device == "cuda" and args.chunk == 8
    args = ap.parse_args(["--seq", "d", "--device", "cpu", "--throughput", "--profile", "p"])
    assert (args.seq, args.device, args.throughput, args.profile) == ("d", "cpu", True, "p")
    with pytest.raises(SystemExit):
        ap.parse_args(["--seq", "d", "--camera", "kinect"])


def test_refuses_what_it_cannot_run():
    with pytest.raises(NotImplementedError, match="distributed"):
        run_slam.main(["--synthetic", "--distributed", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_slam.main(["--synthetic", "--frames", "2"])


def test_lost_frames_counts_frames():
    """The summary's count: frame records not tracked (after the first),
    and every frame a chunk reports lost; other events are not frames."""
    stats = [{"event": "init"}, {"status": 1}, {"status": 2},
             {"event": "chunk_lost", "lost_frames": 3}, {"event": "chunk_reloc"},
             {"event": "capacity_full"}, {"event": "mono_wait"}]
    assert run_slam.lost_frames(stats) == 1 + 3 + 1
    assert run_slam.lost_frames(stats[:2]) == 0


def test_tum_sequence_chunked_then_resumed(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(run_slam.CAMERAS, "qvga", CAM)
    d = str(tmp_path / "seq")
    SyntheticWorld(cam=CAM, n_frames=6, n_static=500, n_dynamic=0, seed=13,
                   pixel_noise=0.0, depth_noise=0.0).export_tum_sequence(d)
    shift_sequence(d, OFFSET)
    rgb = read_file_list(os.path.join(d, "rgb.txt"))
    for name, part in (("a.txt", rgb[:3]), ("b.txt", rgb[3:])):
        with open(os.path.join(d, name), "w") as fh:
            fh.writelines(f"{t:.6f} {v[0]} {t:.6f} {v[0].replace('rgb', 'depth')}\n"
                          for t, v in part)
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SMALL)
    out = {k: str(tmp_path / k) for k in ("traj.txt", "kf.txt", "run.jsonl", "ck.npz",
                                          "prof")}
    common = ["--seq", d, "--camera", "qvga", "--config", str(cfg), "--device", "cpu",
              "--no-loop", "--out", out["traj.txt"], "--kf-out", out["kf.txt"],
              "--log", out["run.jsonl"]]
    # frames 0-2 chunked (the first initialises, then one chunk of 2)
    assert run_slam.main(common + ["--assoc", os.path.join(d, "a.txt"), "--throughput",
                                   "--chunk", "3", "--checkpoint", out["ck.npz"],
                                   "--profile", out["prof"], "--timing"]) == 0
    first = _summary(capsys)
    assert first["frames"] == 3 and first["lost_frames"] == 0
    assert os.path.exists(os.path.join(out["prof"], "trace.json"))
    records = [json.loads(x) for x in open(out["run.jsonl"])]
    assert records[0]["event"] == "init"
    # frames 3-5 per frame, resumed from the checkpoint
    assert run_slam.main(common + ["--assoc", os.path.join(d, "b.txt"),
                                   "--resume", out["ck.npz"]]) == 0
    captured = capsys.readouterr()
    summary = json.loads(captured.out.strip().splitlines()[-1])
    assert "resumed from" in captured.err and "loader" in captured.err
    assert summary["frames"] == 6 and summary["lost_frames"] == 0
    assert summary["ate_rmse_m"] < SEQ_ATE_BAR_M
    records = [json.loads(x) for x in open(out["run.jsonl"])]
    assert len(records) == 3 and all(r["status"] == 1 for r in records)
    ts, poses = read_trajectory_tum(out["traj.txt"])
    np.testing.assert_allclose(ts, [t for t, _ in rgb], atol=TIME_TOL_S, rtol=0)
    assert poses.shape == (6, 4, 4) and np.isfinite(poses).all()
    kf_t, _ = read_trajectory_tum(out["kf.txt"])
    assert 2 <= len(kf_t) <= summary["keyframes"]     # culled keyframes are not written
    frame_t = np.array([t for t, _ in rgb])
    assert np.abs(kf_t[:, None] - frame_t[None]).min(axis=1).max() <= TIME_TOL_S


def test_synthetic_observations(tmp_path, capsys):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SMALL)
    out, kf, log = (str(tmp_path / k) for k in ("traj.txt", "kf.txt", "run.jsonl"))
    assert run_slam.main(["--synthetic", "--frames", "4", "--dynamic", "40",
                          "--config", str(cfg), "--device", "cpu", "--out", out,
                          "--kf-out", kf, "--log", log]) == 0
    summary = _summary(capsys)
    assert summary["frames"] == 4 and summary["ate_rmse_m"] < SYN_ATE_BAR_M
    assert os.path.exists(out) and os.path.exists(kf)
    assert len(open(log).read().splitlines()) == 4


@pytest.mark.slow
def test_cli_matches_reference_cli(tmp_path, capsys):
    """Both CLIs, per frame on the same exported 640x480 TUM3 sequence
    (the first 8 frames of chip_smoke.py's tracking world, default
    config): the same keyframes, none lost, poses to 1 mm."""
    from lc_crf_slam_tpu import run_slam as ref_run_slam

    d = str(tmp_path / "seq")
    SyntheticWorld(cam=TUM3, n_frames=31, n_static=600, n_dynamic=0,
                   seed=0).export_tum_sequence(d, n=8)
    shift_sequence(d, OFFSET)
    results = {}
    for name, main, dev in (("ref", ref_run_slam.main, ["--cpu"]),
                            ("port", run_slam.main, ["--device", "cpu"])):
        out, kf = str(tmp_path / f"{name}.txt"), str(tmp_path / f"{name}_kf.txt")
        assert main(["--seq", d, "--out", out, "--kf-out", kf] + dev) == 0
        results[name] = (_summary(capsys), read_trajectory_tum(out),
                         read_trajectory_tum(kf))
    (s_ref, (t_ref, p_ref), (k_ref, _)), (s_port, (t_port, p_port), (k_port, _)) = \
        results["ref"], results["port"]
    assert s_ref["keyframes"] == s_port["keyframes"]
    assert s_ref["lost_frames"] == s_port["lost_frames"] == 0
    np.testing.assert_array_equal(t_ref, t_port)
    assert_poses_close(p_ref, p_port, 1e-3, 1e-3)
    assert len(k_ref) == len(k_port)
    # the port's keyframe times are frame times; the reference's float32 ones are not
    assert np.abs(k_port[:, None] - t_port[None]).min(axis=1).max() <= TIME_TOL_S
