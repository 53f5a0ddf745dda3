"""Worker processes of tests/test_torch_dist.py, started with the `spawn`
method: each joins a gloo process group on the CPU, runs the port's
distributed BA and CRF on the numpy inputs it is handed, and writes its
rank's results to `<out>/rank<r>.npz`. Imports torch and the port only."""

import os

import numpy as np
import torch
import torch.distributed as dist


def _problem(arrays):
    from lc_crf_slam_torch.ops.schur import BAProblem

    return BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def ranks_job(rank: int, world: int, port: int, problems: dict, crf: dict, out: str):
    """A group named by torchrun's environment variables: each BA problem
    through `dist_solve_ba` (edges sharded) and `dist_solve_ba_blocks`
    (point blocks), 10 iterations each, then the CRF's kNN graph and mean
    field with the tracks sharded."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from lc_crf_slam_torch.config import SLAMConfig
    from lc_crf_slam_torch.geometry.camera import TUM3
    from lc_crf_slam_torch.parallel import dist_ba, dist_crf
    from lc_crf_slam_torch.parallel.mesh import edge_sharding, init_distributed, make_mesh

    init_distributed(device="cpu")
    mesh = make_mesh()
    res = {}
    for name, arrays in problems.items():
        prob = _problem(arrays)
        cam, pts, stats = dist_ba.dist_solve_ba(
            TUM3, dist_ba.shard_problem(prob, mesh), mesh, n_iters=10)
        res.update({f"{name}/edges/cam": cam.numpy(), f"{name}/edges/pts": pts.numpy(),
                    f"{name}/edges/cost": stats.cost.numpy(),
                    f"{name}/edges/n_edges": stats.n_edges.numpy()})
        blocks = dist_ba.partition_point_blocks(prob, mesh.size)
        cam, pts, stats = dist_ba.dist_solve_ba_blocks(
            TUM3, dist_ba.shard_problem(blocks, mesh, blocks=True), mesh, n_iters=10)
        res.update({f"{name}/blocks/cam": cam.numpy(), f"{name}/blocks/pts": pts.numpy(),
                    f"{name}/blocks/cost": stats.cost.numpy()})
    cfg = SLAMConfig()
    xyz, ok, u_s, u_d = (edge_sharding(mesh, torch.from_numpy(crf[k]))
                         for k in ("xyz", "ok", "u_s", "u_d"))
    nbr, w = dist_crf.dist_knn_graph(cfg, xyz, ok, mesh)
    q = dist_crf.dist_mean_field(cfg, u_s, u_d, nbr, w, ok, mesh)
    res.update({"crf/nbr": nbr.numpy(), "crf/w": w.numpy(), "crf/q": q.numpy(),
                "mesh_size": np.asarray(mesh.size), "mesh_rank": np.asarray(mesh.rank)})
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def multihost_job(pid: int, port: int, arrays: dict, n_iters: int, out: str):
    """Two processes joined by address: the point-block BA across the
    process boundary beside this process's own single-process `solve_ba`."""
    torch.set_num_threads(1)
    from lc_crf_slam_torch.geometry.camera import TUM3
    from lc_crf_slam_torch.ops.schur import solve_ba
    from lc_crf_slam_torch.parallel import dist_ba
    from lc_crf_slam_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(coordinator_address=f"localhost:{port}", num_processes=2,
                     process_id=pid, device="cpu")
    mesh = make_mesh()
    prob = _problem(arrays)
    cam_s, pts_s, stats_s = solve_ba(TUM3, prob, n_iters=n_iters)
    blocks = dist_ba.partition_point_blocks(prob, mesh.size)
    cam_d, pts_d, stats_d = dist_ba.dist_solve_ba_blocks(
        TUM3, dist_ba.shard_problem(blocks, mesh, blocks=True), mesh, n_iters=n_iters)
    np.savez(os.path.join(out, f"rank{pid}.npz"), cam_s=cam_s.numpy(), pts_s=pts_s.numpy(),
             cost_s=stats_s.cost.numpy(), cam_d=cam_d.numpy(), pts_d=pts_d.numpy(),
             cost_d=stats_d.cost.numpy(), world=np.asarray(dist.get_world_size()))
    dist.destroy_process_group()
