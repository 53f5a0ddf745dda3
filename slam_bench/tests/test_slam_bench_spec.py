"""A cell, a configuration, a traffic mix, an entry and a per-layer metric
are found by name from files alone: a later change adds files and
entries, and no file of the harness changes."""

import json
import os
import time

import pytest

from slam_bench import session, spec
from slam_bench.tests import tiny


def test_the_benchmarks_own_cells_resolve():
    root = tiny.REPO
    bench = spec.benchmark(root)
    for cell in bench["workloads"]:
        conf = spec.config(root, bench, cell["config"])
        assert conf["name"] == cell["config"]
        mix = spec.traffic(root, cell["traffic"])
        assert callable(mix["module"].hand_in) and mix["entry"] == "track_rgbd"
        for trace in (False, True):
            entries = spec.metrics(bench, cell["name"], trace)
            assert entries and set(spec.readers(root, entries)) == {m["name"] for m in entries}
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2


def test_new_pieces_from_files_alone(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as fh:
        bench = json.load(fh)
    # a new configuration, mix and metric, as files
    conf = tiny.tiny_config()
    conf["name"] = "another"
    conf["session_frames"] = 4
    with open(os.path.join(root, "slam_bench", "configs", "another.json"), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(root, "slam_bench", "traffic", "longer.json"), "w") as fh:
        json.dump({"entry": "track_rgbd", "warmup_keyframes": 2, "trace_frames": 5}, fh)
    with open(os.path.join(root, "slam_bench", "metrics", "frames_seen.py"), "w") as fh:
        fh.write("def read(run):\n    return float(len(run.frame_ms))\n")
    # and entries naming them
    bench["configs"].append({"name": "another", "source": "test", "why": "test",
                             "file": "slam_bench/configs/another.json", "reduced": []})
    bench["workloads"].append({"name": "another.longer", "config": "another",
                               "traffic": "longer", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "fps", "workloads": ["another.longer"]})
    with open(bench_path, "w") as fh:
        json.dump(bench, fh)

    bench = spec.benchmark(root)
    cell = spec.cell(bench, "another.longer")
    assert spec.config(root, bench, cell["config"])["session_frames"] == 4
    assert spec.traffic(root, cell["traffic"])["trace_frames"] == 5
    entries = spec.metrics(bench, "another.longer", True)
    assert [m["name"] for m in entries] == ["frames_seen"]
    read = spec.readers(root, entries)["frames_seen"]
    rec = session.RunRecord(frame_ms=[1.0, 2.0], window_s=1.0, statuses=[1, 1],
                            peak_bytes=0, setup_s=1.0, spans={}, syncs=[], trace=None,
                            shape={})
    assert read(rec) == 2.0
    # the old cell does not list the new metric
    assert "frames_seen" not in {m["name"] for m in spec.metrics(bench, tiny.CELL, True)}


def test_unknown_names_refused():
    bench = spec.benchmark(tiny.REPO)
    with pytest.raises(KeyError):
        spec.cell(bench, "no.such.cell")
    with pytest.raises(KeyError):
        spec.config(tiny.REPO, bench, "no_such_config")


def _write(root, rel, obj):
    with open(os.path.join(root, rel), "w") as fh:
        json.dump(obj, fh)


@pytest.mark.parametrize("mix, error", [
    ({"entry": "track_rgbd", "warmup_keyframes": 1, "trace_frames": 3, "cameras": 2}, KeyError),
    ({"entry": "track_rgbd", "warmup_keyframes": 1}, KeyError),
    ({"entry": "track_rgbd", "warmup_keyframes": "1", "trace_frames": 3}, TypeError),
    ({"entry": "track_sequence", "warmup_keyframes": 1, "trace_frames": 3}, KeyError),
    ({"entry": "no_such_entry", "warmup_keyframes": 1, "trace_frames": 3}, OSError),
])
def test_a_mix_with_keys_nothing_reads_is_refused(tmp_path, mix, error):
    root = tiny.make_root(str(tmp_path))
    _write(root, "slam_bench/traffic/odd.json", mix)
    with pytest.raises(error):
        spec.traffic(root, "odd")


def test_a_new_mix_drives_another_entry(tmp_path, monkeypatch):
    """A mix that hands chunks to `track_sequence`, added as a traffic
    file and a cell: the run goes through that entry, the comparison sees
    the front end of its batches as the plain one, and every keyframe's
    loop detection and every chunk's CRF step ran. (Its trajectory is held
    to no limit here: the walking cell's were set for per-frame tracking.)"""
    from lc_crf_slam_torch.models.system import SLAMSystem

    root = tiny.make_root(str(tmp_path))
    _write(root, "slam_bench/traffic/chunked.json",
           {"entry": "track_sequence", "chunk": 2, "warmup_keyframes": 1, "trace_frames": 2})
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "tiny.chunked", "config": "tiny_walking",
                               "traffic": "chunked", "chips": 1, "why": "test"})
    _write(root, "BENCHMARK.json", bench)
    chunks = []
    original = SLAMSystem.track_sequence

    def counted(self, grays, *args, **kwargs):
        chunks.append(len(grays))
        return original(self, grays, *args, **kwargs)

    monkeypatch.setattr(SLAMSystem, "track_sequence", counted)
    r = session.run(root, "tiny.chunked", 2**32 + 3, 0.0, False, time.perf_counter(),
                    device="cpu", frames=5, log=lambda s: None)
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert checks["kp_diff"] == 0 and checks["desc_bits"] == 0, checks
    assert checks["loop_missed"] == 0 and checks["crf_missed"] == 0, checks
    assert checks["ate_m"] < 0.1, checks
    assert set(chunks) == {2} and r["attempted"] >= 3
