"""Bundle adjustment over the ranks of an "edge" mesh: the Schur reduction
with `all_reduce` collectives (counterpart of
lc_crf_slam_tpu/parallel/dist_ba.py).

Two layouts, each an SPMD function that every rank calls with its own
shard (`shard_problem` cuts it from the whole problem):
- `dist_solve_ba`: the observations (edges) are sharded. Each rank sums
  its edges' camera, point and coupling blocks (`ops/schur.py::
  _partial_blocks`), one all-reduce sums them over the ranks, and every
  rank solves the reduced camera system and back-substitutes the points
  (`_solve_from_blocks`): state stays replicated.
- `dist_solve_ba_blocks`: the map is sharded by contiguous point blocks
  (`partition_point_blocks`). A rank keeps its points, their 3x3 blocks,
  their (pps, C, 6, 3) coupling and their back-substitution; only the
  6C x 6C Schur complement, the camera blocks and gradient and the
  cost are all-reduced, so the traffic does not grow with the map. The
  points are all-gathered once, at the end.

Each `psum` of the reference is one `all_reduce(SUM)` of the concatenated
tensors (`mesh.psum`). The LM loop is `schur.solve_ba`'s: accept on a
lower robust cost, never a non-finite candidate; the cost and the count
of non-finite values go in one all-reduce, so every rank takes the same
decision. The sums over ranks differ from one device's in the last bits.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..geometry.camera import Pinhole
from ..geometry.se3 import exp_se3
from ..ops.schur import (BAProblem, BAStats, _back_substitute, _camera_step,
                         _partial_blocks, _point_schur, _project_edges,
                         _robust_weights, _solve_from_blocks)
from .mesh import Mesh, all_gather_rows, edge_sharding, psum, replicated

_EDGE_FIELDS = ("e_cam", "e_pt", "e_uv", "e_ur", "e_w", "e_valid")


def shard_problem(prob: BAProblem, mesh: Mesh, blocks: bool = False) -> BAProblem:
    """This rank's shard of a whole problem, on its device: its rows of the
    edge arrays, and with `blocks` (a `partition_point_blocks` problem) of
    the points; the rest whole."""
    split = _EDGE_FIELDS + (("p_xyz", "p_valid") if blocks else ())
    return BAProblem(*(edge_sharding(mesh, x) if f in split else replicated(mesh, x)
                       for f, x in zip(prob._fields, prob)))


def partition_point_blocks(prob: BAProblem, n_shards: int) -> BAProblem:
    """Repartition a BA problem into `n_shards` contiguous point blocks, on
    the host: points padded to a multiple of `n_shards`, edges grouped by
    the shard that owns their point (stable in edge order), `e_pt`
    rewritten to local point ids, and every shard's edge list padded to a
    common length (invalid edges). Only `dist_solve_ba_blocks` takes it."""
    dev = prob.p_xyz.device
    host = {f: getattr(prob, f).cpu().numpy() for f in prob._fields}
    P = host["p_xyz"].shape[0]
    pps = -(-P // n_shards)
    p_xyz = np.zeros((pps * n_shards, 3), np.float32)
    p_xyz[:P] = host["p_xyz"]
    p_valid = np.zeros((pps * n_shards,), bool)
    p_valid[:P] = host["p_valid"]

    e_pt, e_valid = host["e_pt"], host["e_valid"]
    shard = np.where(e_valid, e_pt // pps, 0)
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard[order], minlength=n_shards)
    E_pad = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    def pack(arr, fill):
        arr = arr[order]
        out = np.full((n_shards, E_pad) + arr.shape[1:], fill, arr.dtype)
        for s in range(n_shards):
            out[s, :counts[s]] = arr[starts[s]:starts[s] + counts[s]]
        return out.reshape((n_shards * E_pad,) + arr.shape[1:])

    t = lambda a: torch.from_numpy(a).to(dev)     # noqa: E731
    return BAProblem(
        cam_Tcw=prob.cam_Tcw, cam_fixed=prob.cam_fixed, p_xyz=t(p_xyz), p_valid=t(p_valid),
        e_cam=t(pack(host["e_cam"], 0)),
        e_pt=t(np.clip(pack(e_pt - shard * pps, 0), 0, pps - 1)),
        e_uv=t(pack(host["e_uv"], 0.0)), e_ur=t(pack(host["e_ur"], -1.0)),
        e_w=t(pack(host["e_w"], 0.0)), e_valid=t(pack(e_valid, False)))


def _huber(prob: BAProblem, huber_delta: float, huber_delta_mono):
    """Per-edge Huber delta: `huber_delta` on stereo edges,
    `huber_delta_mono` on mono ones (None: one delta for all)."""
    if huber_delta_mono is None:
        return huber_delta
    return torch.where(prob.e_ur >= 0, huber_delta, huber_delta_mono)


def _lm(mesh: Mesh, prob: BAProblem, step: Callable, cam: Pinhole, huber,
        n_iters: int, init_lambda: float, p0: torch.Tensor):
    """`solve_ba`'s accept/reject loop over the ranks; `step(cam_Tcw,
    p_xyz, lam)` gives a candidate from this rank's points `p0`. Returns
    (cam_Tcw, this rank's p_xyz, the cost summed over the ranks)."""

    def cost(cam_Tcw, p_xyz):
        """(robust cost, non-finite values), each summed over the ranks."""
        r, _, _, _, z_ok = _project_edges(cam, cam_Tcw, p_xyz, prob)
        active = prob.e_valid & z_ok & prob.p_valid[prob.e_pt]
        local = _robust_weights(r, prob.e_w, active, huber)[2]
        bad = torch.sum(~torch.isfinite(cam_Tcw)) + torch.sum(~torch.isfinite(p_xyz))
        return psum(mesh, torch.stack([local, bad.to(local.dtype)]))[0]

    cam_Tcw, p_xyz = prob.cam_Tcw, p0
    lam = torch.full((), init_lambda, dtype=torch.float32, device=p0.device)
    f_old = cost(cam_Tcw, p_xyz)[0]
    for _ in range(n_iters):
        cam_new, p_new = step(cam_Tcw, p_xyz, lam)
        f_new, bad = cost(cam_new, p_new)
        accept = (f_new < f_old) & (bad == 0)
        cam_Tcw = torch.where(accept, cam_new, cam_Tcw)
        p_xyz = torch.where(accept, p_new, p_xyz)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e6)
        f_old = torch.where(accept, f_new, f_old)
    return cam_Tcw, p_xyz, f_old


def _stats(mesh: Mesh, prob: BAProblem, cost: torch.Tensor) -> BAStats:
    n_edges = psum(mesh, torch.sum(prob.e_valid.to(torch.int64)))[0].to(torch.int32)
    return BAStats(cost=cost, n_edges=n_edges, edge_chi2=torch.zeros_like(prob.e_w))


def dist_solve_ba(cam: Pinhole, prob: BAProblem, mesh: Mesh, n_iters: int = 10,
                  huber_delta: float = 2.7955, init_lambda: float = 1e-4,
                  huber_delta_mono: float | None = 2.4477,
                  ) -> Tuple[torch.Tensor, torch.Tensor, BAStats]:
    """Edge-sharded LM bundle adjustment: `schur.solve_ba`'s semantics.
    `prob` holds this rank's edges (`shard_problem(prob, mesh)`; pad the
    edges to a multiple of the mesh size with e_valid=False) and the whole
    cameras and points. Returns the replicated (cam_Tcw, p_xyz, stats);
    `edge_chi2` is zeros over this rank's edges."""
    huber = _huber(prob, huber_delta, huber_delta_mono)

    def step(cam_Tcw, p_xyz, lam):
        blocks = psum(mesh, *_partial_blocks(cam, cam_Tcw, p_xyz, prob, huber))
        return _solve_from_blocks(cam_Tcw, p_xyz, prob, blocks, lam)

    cam_Tcw, p_xyz, cost = _lm(mesh, prob, step, cam, huber, n_iters, init_lambda,
                               prob.p_xyz)
    return cam_Tcw, p_xyz, _stats(mesh, prob, cost)


def dist_solve_ba_blocks(cam: Pinhole, prob: BAProblem, mesh: Mesh, n_iters: int = 10,
                         huber_delta: float = 2.7955, init_lambda: float = 1e-4,
                         huber_delta_mono: float | None = 2.4477,
                         ) -> Tuple[torch.Tensor, torch.Tensor, BAStats]:
    """Point-block-sharded LM bundle adjustment (the global BA whose map
    grows with the mesh). `prob` is this rank's block of a
    `partition_point_blocks(prob, mesh.size)` problem
    (`shard_problem(..., blocks=True)`): its points, and its edges with
    local point ids. Returns the replicated cam_Tcw, the points of every
    block in rank order (padded P), and the stats."""
    huber = _huber(prob, huber_delta, huber_delta_mono)

    def step(cam_Tcw, p_l, lam):
        Hcc, g_c, Hpp, g_p, Wpc = _partial_blocks(cam, cam_Tcw, p_l, prob, huber)
        Hpp_inv, _, S_red, rhs_red = _point_schur(Hpp, g_p, Wpc, lam)
        # the one reduction over the ranks: the camera system
        S_red, Hcc, g_c, rhs_red = psum(mesh, S_red, Hcc, g_c, rhs_red)
        delta_c = _camera_step(Hcc, g_c, S_red, rhs_red, prob.cam_fixed, lam)
        # the points' back-substitution stays on their rank
        delta_p = _back_substitute(Hpp, g_p, Wpc, Hpp_inv, prob.p_valid, delta_c)
        return exp_se3(delta_c) @ cam_Tcw, p_l + delta_p

    cam_Tcw, p_l, cost = _lm(mesh, prob, step, cam, huber, n_iters, init_lambda,
                             prob.p_xyz)
    return cam_Tcw, all_gather_rows(mesh, p_l), _stats(mesh, prob, cost)
