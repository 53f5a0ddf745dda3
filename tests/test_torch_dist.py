"""The port's multi-device layer (lc_crf_slam_torch/parallel/) against the
JAX reference, on the CPU.

The reference runs as tests/test_dist.py runs it, on the 8-device CPU mesh
that conftest.py forces. The port runs on gloo process groups: a world of
one in this process, four ranks in `spawn`ed workers (one fixture, run
once; tests/torch_dist_worker.py) and two processes joined by address, the
counterpart of tests/test_multihost.py. Each worker has its own time limit
and a free port, so a hung rendezvous fails its test.

Tolerances are the reference's own (tests/test_dist.py): camera
translations 1e-4 m and valid points 1e-3 against both the reference's
distributed solves and its single-device `solve_ba`; the CRF's neighbour
ids exactly, its weights and beliefs to 1e-6. On the noisy problem (seed
1, 0.3 px) a few points sit along flat directions where the reference's
own distributed solve and `solve_ba` differ by 1.2e-3: there the points
are held by the robust cost (1e-4 relative) and the cameras, as the
reference's `test_recovers_gt` holds them, also to the ground truth
(1 cm). `SLAMSystem(mesh=...)` with
the frames split over devices gives bitwise the poses and keyframes of
`mesh=None`, with one front-end (FAST) call per shard of a chunk; and the
command line with `--distributed` in a world of one writes the trajectory
it writes without."""

import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import SLAMConfig as RefConfig
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.ops.schur import solve_ba as ref_solve_ba
from lc_crf_slam_tpu.parallel import dist_ba as ref_dist_ba
from lc_crf_slam_tpu.parallel import dist_crf as ref_dist_crf
from lc_crf_slam_tpu.parallel.mesh import make_mesh as ref_make_mesh
from lc_crf_slam_torch import config, convert
from lc_crf_slam_torch.geometry.camera import TUM3, Pinhole
from lc_crf_slam_torch.models import crf
from lc_crf_slam_torch.models import frame as frame_mod
from lc_crf_slam_torch.models.system import SLAMSystem
from lc_crf_slam_torch.ops.schur import solve_ba
from lc_crf_slam_torch.parallel import dist_ba, dist_crf
from lc_crf_slam_torch.parallel.mesh import (edge_sharding, init_distributed, make_mesh,
                                             shard_bounds)
from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

import torch_dist_worker
from test_schur_ba import cam_errs, make_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240
CAM_TOL_M = 1e-4
PT_TOL = 1e-3
CRF_TOL = 1e-6
N_ITERS = 10
SEEDS = {0: dict(seed=0), 1: dict(seed=1, pix_noise=0.3)}
POINTS_HELD = {0: True, 1: False}   # see the module docstring
COST_RTOL = 1e-4
GT_TOL_M = 0.01


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(target, args_per_rank):
    """Start one `spawn` worker per argument tuple and join each within its
    own time limit; a worker still alive then is killed and fails the
    test, as does a non-zero exit."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for args in args_per_rank]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORKER_TIMEOUT_S)
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"workers {hung} still running after {WORKER_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs), [p.exitcode for p in procs]


def _numpy(prob) -> dict:
    return {f: np.asarray(getattr(prob, f)) for f in prob._fields}


def _crf_toy(n=512, seed=0):
    """tests/test_dist.py's toy CRF inputs."""
    rng = np.random.default_rng(seed)
    return dict(xyz=rng.uniform(-3, 3, (n, 3)).astype(np.float32),
                ok=rng.uniform(size=n) < 0.9,
                u_s=rng.gamma(2.0, 1.0, n).astype(np.float32),
                u_d=np.full((n,), 4.0, np.float32))


@pytest.fixture(scope="module")
def reference():
    """The reference's solves of each problem on the 8-device mesh and on
    one device, and its distributed CRF on the toy inputs."""
    mesh = ref_make_mesh(8)
    solves = {name: jax.jit(lambda p, f=f: f(p)[:3]) for name, f in (
        ("single", lambda p: ref_solve_ba(REF_TUM3, p, n_iters=N_ITERS)),
        ("edges", lambda p: ref_dist_ba.dist_solve_ba(REF_TUM3, p, mesh, n_iters=N_ITERS)),
        ("blocks", lambda p: ref_dist_ba.dist_solve_ba_blocks(REF_TUM3, p, mesh,
                                                              n_iters=N_ITERS)))}
    out = {}
    for seed, kw in SEEDS.items():
        prob, cams_true, _, nc, _ = make_problem(**kw)
        out[seed] = dict(prob=prob, nc=nc, valid=np.asarray(prob.p_valid),
                         cams_true=cams_true,
                         single=solves["single"](prob), edges=solves["edges"](prob),
                         blocks=solves["blocks"](ref_dist_ba.partition_point_blocks(prob, 8)))
        for name in solves:
            cam, pts, stats = out[seed][name]
            out[seed][name] = (np.asarray(cam), np.asarray(pts), float(stats.cost))
    toy = _crf_toy()
    cfg = RefConfig()
    args = [jnp.asarray(toy[k]) for k in ("xyz", "ok")]
    nbr, w = ref_dist_crf.dist_knn_graph(cfg, *args, mesh)
    q = ref_dist_crf.dist_mean_field(cfg, jnp.asarray(toy["u_s"]), jnp.asarray(toy["u_d"]),
                                     nbr, w, args[1], mesh)
    out["crf"] = dict(toy=toy, nbr=np.asarray(nbr), w=np.asarray(w), q=np.asarray(q))
    return out


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one rank in this process, joined by address."""
    init_distributed(coordinator_address=f"localhost:{_free_port()}", num_processes=1,
                     process_id=0, device="cpu")
    yield make_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    """Every problem and the CRF on four ranks in spawned workers: their
    result files, in rank order."""
    out = str(tmp_path_factory.mktemp("four_ranks"))
    problems = {str(seed): _numpy(reference[seed]["prob"]) for seed in SEEDS}
    port = _free_port()
    _spawn(torch_dist_worker.ranks_job,
           [(r, 4, port, problems, reference["crf"]["toy"], out) for r in range(4)])
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(4)]


def _assert_close(r, seed, want, cam, pts, cost):
    """(cam, pts, cost) against a solve `want` of the same problem (`r`,
    the reference fixture's entry): translations of the first nc cameras
    to 1e-4 m; valid points (the unpadded prefix) to 1e-3 where they are
    held, else the robust cost to 1e-4 relative and the cameras to the
    ground truth."""
    nc, valid = r["nc"], r["valid"]
    np.testing.assert_allclose(cam[:nc, :3, 3], want[0][:nc, :3, 3], atol=CAM_TOL_M)
    if POINTS_HELD[seed]:
        np.testing.assert_allclose(pts[:len(valid)][valid], want[1][valid], atol=PT_TOL)
    else:
        assert abs(float(cost) - want[2]) <= COST_RTOL * want[2], (float(cost), want[2])
        assert cam_errs(cam, r["cams_true"], nc).max() < GT_TOL_M


@pytest.mark.parametrize("variant", ["edges", "blocks"])
@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_world_of_one_matches_reference(reference, world_of_one, seed, variant):
    """One rank: the same LM as `schur.solve_ba` (bitwise for the edge
    variant) and the reference's solves to their tolerances."""
    ref = reference[seed]
    prob = convert.ba_problem_to_torch(ref["prob"])
    mesh = world_of_one
    if variant == "edges":
        cam, pts, stats = dist_ba.dist_solve_ba(TUM3, dist_ba.shard_problem(prob, mesh),
                                                mesh, n_iters=N_ITERS)
        cam_s, pts_s, _ = solve_ba(TUM3, prob, n_iters=N_ITERS)
        assert torch.equal(cam, cam_s) and torch.equal(pts, pts_s)
        assert int(stats.n_edges) == int(np.asarray(ref["prob"].e_valid).sum())
    else:
        blocks = dist_ba.partition_point_blocks(prob, mesh.size)
        cam, pts, stats = dist_ba.dist_solve_ba_blocks(
            TUM3, dist_ba.shard_problem(blocks, mesh, blocks=True), mesh, n_iters=N_ITERS)
    assert np.isfinite(float(stats.cost))
    for against in ("single", variant):
        _assert_close(ref, seed, ref[against], cam.numpy(), pts.numpy(), stats.cost)


@pytest.mark.parametrize("variant", ["edges", "blocks"])
@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_four_ranks_match_reference(reference, four_ranks, seed, variant):
    """Four ranks: every rank holds the same cameras and points, which
    agree with the reference's 8-device and single-device solves."""
    ref = reference[seed]
    got = [(r[f"{seed}/{variant}/cam"], r[f"{seed}/{variant}/pts"]) for r in four_ranks]
    assert [int(r["mesh_rank"]) for r in four_ranks] == [0, 1, 2, 3]
    for cam, pts in got[1:]:
        np.testing.assert_array_equal(cam, got[0][0])
        np.testing.assert_array_equal(pts, got[0][1])
    cost = four_ranks[0][f"{seed}/{variant}/cost"]
    for against in ("single", variant):
        _assert_close(ref, seed, ref[against], *got[0], cost)


@pytest.mark.parametrize("n", [4, 8])
def test_partition_point_blocks_equals_reference(reference, n):
    prob = reference[0]["prob"]
    want = ref_dist_ba.partition_point_blocks(prob, n)
    got = dist_ba.partition_point_blocks(convert.ba_problem_to_torch(prob), n)
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_four_rank_crf_matches_reference(reference, four_ranks):
    """The tracks' rows gathered in rank order: the neighbour ids equal
    the reference's, weights and the beliefs every rank holds to 1e-6."""
    ref = reference["crf"]
    np.testing.assert_array_equal(np.concatenate([r["crf/nbr"] for r in four_ranks]),
                                  ref["nbr"])
    np.testing.assert_allclose(np.concatenate([r["crf/w"] for r in four_ranks]),
                               ref["w"], atol=CRF_TOL)
    for r in four_ranks:
        np.testing.assert_allclose(r["crf/q"], ref["q"], atol=CRF_TOL)


def test_world_of_one_crf_equals_single_device(world_of_one):
    """One rank: the graph and beliefs of `crf.knn_graph` + `mean_field`."""
    toy = {k: torch.from_numpy(v) for k, v in _crf_toy(seed=3).items()}
    cfg = config.SLAMConfig()
    mesh = world_of_one
    assert shard_bounds(512, mesh) == (0, 512)
    nbr, w = dist_crf.dist_knn_graph(cfg, toy["xyz"], toy["ok"], mesh)
    nbr_s, w_s = crf.knn_graph(cfg, toy["xyz"], toy["ok"])
    assert torch.equal(nbr, nbr_s) and torch.equal(w, w_s)
    q = dist_crf.dist_mean_field(cfg, toy["u_s"], toy["u_d"], nbr, w, toy["ok"], mesh)
    q_s = crf.mean_field(cfg, toy["u_s"], toy["u_d"], nbr_s, w_s, toy["ok"])
    assert torch.equal(q, q_s)
    assert torch.equal(edge_sharding(mesh, q), q)


def test_two_process_distributed_ba(reference, tmp_path):
    """tests/test_multihost.py's proof for the port: two processes join by
    address and solve the point-block BA across the process boundary;
    both hold the cameras and points of the single-process `solve_ba`
    (theirs and the reference's)."""
    ref = reference[0]
    port = _free_port()
    arrays = _numpy(ref["prob"])
    _spawn(torch_dist_worker.multihost_job,
           [(pid, port, arrays, N_ITERS, str(tmp_path)) for pid in range(2)])
    for pid in range(2):
        r = np.load(tmp_path / f"rank{pid}.npz")
        assert int(r["world"]) == 2
        for want in ((r["cam_s"], r["pts_s"], float(r["cost_s"])), ref["single"]):
            _assert_close(ref, 0, want, r["cam_d"], r["pts_d"], r["cost_d"])


# ---- SLAMSystem(mesh=...) ---------------------------------------------------

# __graft_entry__.py's small pipeline world: 160x120, the reduced ORB and
# map capacities, CRF and mapping on. Its trajectory spans 60 frames (over
# the graft's 10 the motion is too fast: the chunk loses track, and so
# does the stereo rig over 30), and a keyframe comes at least every 3
# frames, so that keyframes, mapping and loop detection run inside the
# chunks.
WORLD_FRAMES = 60
SMALL = Pinhole(fx=134.0, fy=135.0, cx=80.0, cy=60.0, width=160, height=120, bf=10.0)
PIPE_CFG = config.SLAMConfig(
    orb=config.ORBConfig(n_features=250, max_keypoints=256, n_levels=4),
    map=config.MapConfig(max_points=4096, max_keyframes=48, max_features=256),
    mapping=config.MappingConfig(max_new_points_per_kf=192),
    tracking=config.TrackingConfig(max_frames_between_kf=3))


_FAST = frame_mod.fast_cell_best


def _pipeline(monkeypatch, mesh, n_frames: int, chunk: int, stereo: bool):
    """`track_sequence(_stereo)` over the small world's first n_frames:
    (poses, system, front-end calls)."""
    world = SyntheticWorld(cam=SMALL, n_frames=WORLD_FRAMES, n_static=400, n_dynamic=0,
                           seed=1)
    grays = np.stack([world.frame(k, render=True).image for k in range(n_frames)])
    second = np.stack([world.right_eye(k) if stereo else world.frame(k, render=True)
                       .depth_image for k in range(n_frames)])
    calls = []
    monkeypatch.setattr(frame_mod, "fast_cell_best",
                        lambda pyr, *a: calls.append(pyr.flat.shape[0]) or _FAST(pyr, *a))
    slam = SLAMSystem(SMALL, PIPE_CFG, enable_crf=True, enable_mapping=True, device="cpu",
                      mesh=mesh)
    stamps = np.arange(n_frames) / 30.0
    run = slam.track_sequence_stereo if stereo else slam.track_sequence
    poses = run(grays.astype(np.float32), second.astype(np.float32), stamps, chunk=chunk)
    return poses, slam, calls


@pytest.mark.parametrize("stereo", [False, True])
def test_sharded_pipeline_matches_single_device(monkeypatch, stereo):
    """The chunk's frames split over a "frames" mesh of CPU devices (RGB-D:
    4 shards of a chunk of 8; stereo: 3 uneven shards, 2 + 1 + 1, of each
    chunk of 4): the same keyframes and bitwise the same poses as
    `mesh=None`, and one front-end batch a shard (stereo: both eyes)."""
    n_dev, n_frames, chunk = (3, 9, 4) if stereo else (4, 9, 8)
    poses, slam, calls = _pipeline(monkeypatch, None, n_frames, chunk, stereo)
    mesh = make_mesh(devices=["cpu"] * n_dev, axis="frames")
    poses_m, slam_m, calls_m = _pipeline(monkeypatch, mesh, n_frames, chunk, stereo)
    eyes = 2 if stereo else 1
    n_chunks = -(-(n_frames - 1) // chunk)
    assert calls == [eyes] + [eyes * chunk] * n_chunks
    shard = [2, 1, 1] if stereo else [2] * 4
    assert calls_m == [eyes] + [eyes * s for s in shard] * n_chunks
    assert slam_m.kf_log == slam.kf_log and len(slam.kf_log) >= 2
    assert slam_m.n_mapping_steps == slam.n_mapping_steps == len(slam.kf_log)
    assert np.array_equal(poses_m, poses) and np.isfinite(poses).all()
    assert np.array_equal(slam_m.get_trajectory()[1], slam.get_trajectory()[1])
    assert slam_m.n_crf_steps == slam.n_crf_steps == n_chunks


def test_mesh_axis_is_checked():
    """A system splits frames only: a mesh of another axis is refused."""
    mesh = make_mesh(devices=["cpu"] * 2, axis="tracks")
    assert mesh.size == 2 and mesh.rank == 0 and mesh.group is None
    with pytest.raises(ValueError, match="frames"):
        SLAMSystem(SMALL, PIPE_CFG, device="cpu", mesh=mesh)


# ---- run_slam --distributed -------------------------------------------------

CLI = ("import sys; from lc_crf_slam_torch import run_slam; "
       "from lc_crf_slam_torch.geometry.camera import Pinhole; "
       "run_slam.CAMERAS['small'] = Pinhole(fx=134.0, fy=135.0, cx=80.0, cy=60.0, "
       "width=160, height=120, bf=10.0); sys.exit(run_slam.main(sys.argv[1:]))")


def test_cli_distributed_world_of_one(tmp_path):
    """`run_slam.main` (what `python -m lc_crf_slam_torch.run_slam` runs) on
    a 6-frame TUM export of the small world, with `--cpu --distributed`
    under a world-of-one gloo environment and without: both exit 0 and
    write the same trajectory and keyframes."""
    seq = tmp_path / "seq"
    SyntheticWorld(cam=SMALL, n_frames=WORLD_FRAMES, n_static=400, n_dynamic=0,
                   seed=1).export_tum_sequence(str(seq), n=6)
    small = tmp_path / "small.yaml"
    small.write_text("orb.max_keypoints: 256\norb.n_levels: 4\nmap.max_points: 4096\n"
                     "map.max_keyframes: 48\nmap.max_features: 256\n")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", OMP_NUM_THREADS="2")
    procs = {}
    for name, extra in (("plain", []), ("dist", ["--distributed"])):
        argv = ["--seq", str(seq), "--camera", "small", "--config", str(small), "--cpu",
                "--out", str(tmp_path / f"{name}.txt"),
                "--kf-out", str(tmp_path / f"{name}_kf.txt"), *extra]
        procs[name] = subprocess.Popen([sys.executable, "-c", CLI, *argv], cwd=REPO,
                                       env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    outs = {}
    for name, p in procs.items():
        try:
            outs[name] = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} run timed out")
        assert p.returncode == 0, outs[name]
    summaries = {n: json.loads(o[0].strip().splitlines()[-1]) for n, o in outs.items()}
    assert summaries["dist"]["frames"] == summaries["plain"]["frames"] == 6
    assert summaries["dist"]["keyframes"] == summaries["plain"]["keyframes"]
    for suffix in (".txt", "_kf.txt"):
        a = np.loadtxt(tmp_path / f"plain{suffix}", ndmin=2)
        b = np.loadtxt(tmp_path / f"dist{suffix}", ndmin=2)
        np.testing.assert_array_equal(a, b)
