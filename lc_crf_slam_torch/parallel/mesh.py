"""Process groups, device meshes and shardings (counterpart of
lc_crf_slam_tpu/parallel/mesh.py).

The reference builds a `jax.sharding.Mesh` with named axes and runs
`shard_map`ped functions over it. The port has two axes:
- "edge": BA observations and CRF tracks, data parallel SPMD. One process
  (rank) per shard, joined in a `torch.distributed` process group; each
  reduction of the reference (`psum`, `all_gather`) is a collective of
  that group (NCCL on the card, gloo on the CPU).
- "frames": the batched front-end and forward flow of a chunk
  (`SLAMSystem(mesh=...)`), split over the listed devices by the one
  process that drives them; no process group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# a rendezvous or a collective that waits longer than this fails
TIMEOUT = datetime.timedelta(minutes=5)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str | torch.device = "cuda") -> None:
    """Join this process to a `torch.distributed` process group.

    With no address, torchrun's environment names the group
    (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`); with one
    ("host:port"), `num_processes` and `process_id` do, over a `tcp://`
    rendezvous. The backend follows `device`: NCCL for "cuda" (each rank
    on the card `LOCAL_RANK`, else its rank modulo the cards visible) and
    gloo only for "cpu", which the caller asks for. A no-op when a group
    is already up."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA device; "
                               "pass device='cpu' for a gloo group on the CPU")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for device {dev}")
    if coordinator_address is None:
        kwargs = dict(init_method="env://")
        rank = int(os.environ.get("RANK", "0"))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: an address needs num_processes "
                             "and process_id")
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
        rank = process_id
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)


def process_device() -> torch.device:
    """The device this rank's shard lives on: its card under NCCL, the CPU
    under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices with one named axis. On the "edge" axis
    `group` is the process group (shard i is rank i, on `devices[i]`);
    on "frames" one process drives every device and `group` is None."""

    devices: tuple
    axis: str
    group: object = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        """This process's shard: its rank in the group (0 without one)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


def make_mesh(n_devices: Optional[int] = None, axis: str = "edge",
              devices: Optional[Sequence] = None) -> Mesh:
    """A one-axis mesh. "edge": every rank of the process group
    (`init_distributed` first), one shard each; `devices` defaults to each
    rank's `process_device()`. Any other axis: `devices` as listed (one
    device may appear more than once), else the first `n_devices` cards."""
    if axis == "edge":
        if not dist.is_initialized():
            raise RuntimeError("make_mesh(axis='edge') needs a process group: "
                               "call init_distributed first")
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"an 'edge' mesh has one shard per rank: {world}, "
                             f"not {n_devices}")
        if devices is None:
            names = [None] * world
            dist.all_gather_object(names, str(process_device()))
            devices = names
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        return Mesh(tuple(torch.device(d) for d in devices), axis, dist.group.WORLD)
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("make_mesh: no CUDA device; list the devices "
                               "(e.g. devices=['cpu'] * 4) to run on the CPU")
        devices = [f"cuda:{i}" for i in range(n_devices or n_cards)]
    devices = tuple(torch.device(d) for d in devices)[:n_devices]
    return Mesh(devices, axis)


def shard_bounds(n: int, mesh: Mesh):
    """(start, stop) of this rank's contiguous rows of n; n must divide by
    the mesh size (pad the rows first)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} shards")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def edge_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of x, on its device (the reference's `P("edge")`)."""
    lo, hi = shard_bounds(x.shape[0], mesh)
    return x[lo:hi].to(mesh.device)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x whole, on this rank's device (the reference's `P()`)."""
    return x.to(mesh.device)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order (the
    reference's tiled `all_gather`). The list form of the collective, so
    gloo and NCCL take the same call."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def psum(mesh: Mesh, *xs: torch.Tensor):
    """The sums over the ranks of same-dtype tensors (the reference's
    `psum`), as one all-reduce of their concatenation."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out = torch.split(flat, [x.numel() for x in xs])
    return tuple(o.reshape(x.shape) for o, x in zip(out, xs))
