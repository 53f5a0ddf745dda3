"""Primitives whose semantics decide parity with the JAX reference.

- `stable_topk`: `lax.top_k` breaks ties by the lower index; `torch.topk`
  does not promise that (on [1,3,3,0,3], k=3, it returns [2,4,1] where
  `lax.top_k` returns [1,2,4]). A stable descending sort does.
- Drop-mode scatters: the reference writes with `.at[idx].set/add
  (mode="drop")` and passes the capacity as the "no target" index. Torch's
  indexed writes raise on an out-of-range index, so these helpers write
  into a copy with one extra dump row and cut it off again. Negative
  indices are dropped too (the reference never passes one to a drop-mode
  write: JAX would wrap it). `scatter_set` lets the last of duplicate
  writes win on every device. `scatter_min` / `scatter_max` are
  `.at[idx].min/.max(mode="drop")`.
- Popcount of int32 words (descriptors are int32 bit-views of the
  reference's uint32 words) as a SWAR reduction in int64.
"""

from __future__ import annotations

import numpy as np
import torch


def stable_topk(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index, as
    `lax.top_k`: returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def take_row(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """arr[i] for a 0-d device index, without the host read that indexing
    with a 0-d tensor makes."""
    return arr.index_select(0, i.reshape(1).long())[0]


def as_value(val, like: torch.Tensor) -> torch.Tensor:
    """val (tensor or Python scalar) as a tensor of like's dtype and
    device; a scalar becomes a device fill, not a host-to-device copy."""
    if isinstance(val, torch.Tensor):
        return val.to(dtype=like.dtype, device=like.device)
    return torch.full((), val, dtype=like.dtype, device=like.device)


def put_row(arr: torch.Tensor, i: torch.Tensor, val) -> torch.Tensor:
    """A copy of arr with row i (0-d device index) replaced by val."""
    v = as_value(val, arr)
    return arr.index_copy(0, i.reshape(1).long(), v.expand(arr.shape[1:])[None])


def _dump_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((idx >= 0) & (idx < n), idx, n).long()


def _with_dump_row(arr: torch.Tensor) -> torch.Tensor:
    return torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """`arr.at[idx].set(val, mode="drop")` along axis 0. Where several
    entries of idx name one row, the last of them (in idx's row-major
    order) wins, on every device. JAX leaves it unspecified; the CPU's
    indexed write goes in order, so the last wins there, but on a card
    the writes race and two runs of one path part (one run's tracked
    points differed from the other's on the second frame). So every
    entry but each row's last is sent to the dump row."""
    n = arr.shape[0]
    dump = _dump_index(idx, n)
    flat = dump.reshape(-1)
    pos = torch.arange(flat.shape[0], device=flat.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=flat.device).scatter_reduce_(
        0, flat, pos, "amax")
    out = _with_dump_row(arr)
    out[torch.where(last[flat] == pos, flat, n).reshape(dump.shape)] = as_value(val, arr)
    return out[:n]


def scatter_add(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """`arr.at[idx].add(val, mode="drop")` along axis 0, by `index_add_`:
    atomic adds on the card, exact for the integer counts the callers
    add. (`index_put_(accumulate=True)` sorts the indices and adds each
    index's duplicates one after another, and every dropped entry lands
    on the one dump row: 300k of them took ~30 ms on an H100.)"""
    n = arr.shape[0]
    out = _with_dump_row(arr)
    v = as_value(val, arr).expand((idx.shape[0],) + tuple(arr.shape[1:]))
    return out.index_add_(0, _dump_index(idx, n), v)[:n]


def _scatter_reduce(arr, idx, val, reduce: str) -> torch.Tensor:
    n = arr.shape[0]
    out = _with_dump_row(arr)
    v = as_value(val, arr).expand(idx.shape)
    return out.scatter_reduce_(0, _dump_index(idx, n), v, reduce,
                               include_self=True)[:n]


def scatter_min(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """`arr.at[idx].min(val, mode="drop")` along axis 0 of a 1-D arr."""
    return _scatter_reduce(arr, idx, val, "amin")


def scatter_max(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """`arr.at[idx].max(val, mode="drop")` along axis 0 of a 1-D arr."""
    return _scatter_reduce(arr, idx, val, "amax")


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (read as its uint32 bit pattern), int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def words_to_int32(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same bits."""
    return torch.where(words64 >= 2**31, words64 - 2**32, words64).to(torch.int32)


def u32_to_i32(a) -> np.ndarray:
    """numpy uint32 words -> their int32 bit-view (a writable copy)."""
    return np.array(a, dtype=np.uint32, order="C").view(np.int32)


def i32_to_u32(a) -> np.ndarray:
    """numpy int32 bit-view -> the uint32 words (a writable copy)."""
    return np.array(a, dtype=np.int32, order="C").view(np.uint32)
