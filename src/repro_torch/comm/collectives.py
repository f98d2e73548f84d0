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


# ----------------------------------------------------------------------------
# DTensor's collectives over the same transport
# ----------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


_sent = 0      # bytes handed to the routed collectives, by this process


def dtensor_bytes_sent() -> int:
    """The bytes this process has handed to DTensor's routed collectives
    so far (each call's input tensor; a Shard -> Shard redistribution's
    all-gather included): read it before and after the work to meter."""
    return _sent


def _count(t: torch.Tensor) -> None:
    global _sent
    _sent += t.numel() * t.element_size()


def _group(group):
    """The process group of a functional collective's `group`: a
    (DeviceMesh, dim) pair, a 1-D DeviceMesh, a group or its name."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if isinstance(group, dist.ProcessGroup):
        return group
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group)
    return group.get_group()


def _dtensor_all_gather(self, gather_dim, group, tag=""):
    pg = _group(group)
    n = _size(pg)
    t = self.detach().contiguous()
    _count(t)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _gather_into(out, t, group=pg)
    if gather_dim % max(t.dim(), 1):
        out = torch.cat(out.chunk(n), dim=gather_dim)
    return out


def _dtensor_all_reduce(self, reduceOp, group, tag=""):
    pg = _group(group)
    out = self.detach().clone(memory_format=torch.contiguous_format)
    _count(out)
    op = reduceOp.lower()
    dist.all_reduce(out, op=_OPS["sum" if op == "avg" else op], group=pg)
    return out / _size(pg) if op == "avg" else out


def _dtensor_reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
    pg = _group(group)
    n = _size(pg)
    op = reduceOp.lower()
    chunks = [c.contiguous() for c in self.detach().chunk(n, scatter_dim)]
    flat = torch.cat([c.reshape(-1) for c in chunks])
    _count(flat)
    out = flat.new_empty((flat.shape[0] // n,))
    _scatter_from(out, flat, op=_OPS["sum" if op == "avg" else op],
                  group=pg)
    out = out.reshape(chunks[0].shape)
    return out / n if op == "avg" else out


def _dtensor_all_to_all(self, output_split_sizes, input_split_sizes, group,
                        tag=""):
    if output_split_sizes is not None or input_split_sizes is not None:
        raise NotImplementedError("all_to_all_single over gloo takes "
                                  "equal splits only")
    pg = _group(group)
    n, me = _size(pg), dist.get_rank(pg)
    gathered = _dtensor_all_gather(self, 0, pg).chunk(n)
    return torch.cat([g.chunk(n)[me] for g in gathered])


def _dtensor_shard_dim_alltoall(input, gather_dim, shard_dim, mesh,
                                mesh_dim):
    out = _dtensor_all_gather(input, gather_dim, (mesh, mesh_dim))
    return out.chunk(mesh.size(mesh_dim), dim=shard_dim)[
        mesh.get_local_rank(mesh_dim)].contiguous()


# torch's functional collectives (by their names in either torch the port
# runs on: 2.11 on the card, 2.13 here) and what takes their place
DTENSOR_ROUTES = {"all_gather_tensor": _dtensor_all_gather,
                  "all_gather_single": _dtensor_all_gather,
                  "all_reduce": _dtensor_all_reduce,
                  "reduce_scatter_tensor": _dtensor_reduce_scatter,
                  "reduce_scatter_single": _dtensor_reduce_scatter,
                  "all_to_all_single": _dtensor_all_to_all}


def route_dtensor_collectives() -> None:
    """Send DTensor's collectives through the calls above (the
    `torch.distributed` collectives this module uses, synchronous), in
    place of torch's functional collectives, and its Shard -> Shard
    all_to_all through an all-gather and a slice. Over gloo on the card
    the functional collectives crash the process (torch 2.11.0+cu128:
    `all_gather_tensor` of a CUDA tensor, a segmentation fault); the
    calls here take CUDA tensors (`tools/dist_probe.py`).

    It rebinds private names of torch (`_functional_collectives`' five
    collectives, `shard_dim_alltoall` in `tensor._collective_utils` and
    `tensor.placement_types`) for the whole process, every process group
    included. `launch.mesh.device_mesh` installs it only when the default
    group is gloo: on the card, where it is needed, and on the CPU, where
    torch's own would do but the port's tests then run the calls the card
    runs. Idempotent."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types
    for name, fn in DTENSOR_ROUTES.items():
        if hasattr(funcol, name):
            setattr(funcol, name, fn)
    for mod in (_collective_utils, placement_types):
        if hasattr(mod, "shard_dim_alltoall"):
            mod.shard_dim_alltoall = _dtensor_shard_dim_alltoall
