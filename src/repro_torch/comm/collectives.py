"""The cross-process collectives of a process mesh, over gloo.

The reference's `psum`, `psum_scatter` and grouped `all_gather` inside
shard_map become `torch.distributed` calls on the subgroups of a process
mesh (`launch.mesh.make_process_mesh`). Every function here returns a new
tensor and leaves its input as it was.

The transport is gloo: one card cannot hold two NCCL ranks, and the ranks
of a one-card mesh share `cuda:0`. gloo takes CUDA tensors for the three
collectives used here (torch 2.11.0+cu128 on an H100:
`tools/dist_probe.py`) and moves them through the host itself, so a
message is handed to it on the rank's device as it is. The rank computes
on the card; only the message crosses the host, and that copy is part of
the exchange's time.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


# torch renamed the tensor forms of these two collectives; take the name
# the installed torch has
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (None: the tensor as it
    is, for a group of one)."""
    if group is None or _size(group) == 1:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The ranks' `t` stacked on a new leading axis, in the order of their
    ranks in `group` (the mesh's worker order)."""
    if group is None or _size(group) == 1:
        return t[None]
    n = _size(group)
    flat = t.detach().contiguous().reshape(-1)
    out = flat.new_empty((n * flat.shape[0],))
    _gather_into(out, flat, group=group)
    return out.reshape((n,) + tuple(t.shape))


def reduce_scatter(flat: torch.Tensor, group: Optional[object]
                   ) -> torch.Tensor:
    """This rank's 1/n chunk of the sum of the ranks' (n c,) `flat`
    vectors: the reduce-scatter half of the a2a reduce."""
    if group is None or _size(group) == 1:
        return flat
    n = _size(group)
    out = flat.new_empty((flat.shape[0] // n,))
    _scatter_from(out, flat.detach().contiguous(), op=dist.ReduceOp.SUM,
                  group=group)
    return out
