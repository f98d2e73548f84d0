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

The tally: every collective of this module -- the mesh rounds' calls,
the expert-parallel MoE's (`psum`, `pmean`, `all_gather_dim`, autograd
aware; `pmax`), and DTensor's routed ones (`route_dtensor_collectives`) --
records its kind (the reference's HLO names: all-gather, all-reduce,
reduce-scatter, all-to-all, collective-permute), its group size and its
bytes: the result's, as the reference's `collective_stats` counts them,
and the input's, the bytes handed to the transport. `tally()` is a
snapshot, `tally_since(snapshot)` what came after it, and
`launch.hlo_analysis.collective_stats` prices it in wire bytes a device
with the reference's ring model. A dry run on a fake world
(`launch.dryrun`) and a real run of the same step make the same calls,
so their tallies are equal.
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


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


def _size(group) -> int:
    return dist.get_world_size(group)


# ----------------------------------------------------------------------------
# the tally
# ----------------------------------------------------------------------------

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# (kind, group size, routed through DTensor) -> [count, result bytes,
# bytes handed over]; aggregated, so a long run keeps it small
_TALLY: dict = {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, g: int, result: torch.Tensor, handed: torch.Tensor,
            routed: bool = False) -> None:
    row = _TALLY.setdefault((kind, int(g), routed), [0, 0, 0])
    row[0] += 1
    row[1] += _nbytes(result)
    row[2] += _nbytes(handed)


def tally() -> dict:
    """A snapshot of the tally: {(kind, group size, routed): (count,
    result bytes, bytes handed over)} since the process started."""
    return {k: tuple(v) for k, v in _TALLY.items()}


def tally_since(snapshot: dict) -> dict:
    """The collectives recorded after `snapshot` (a `tally()`), in its
    form; keys with no new call are left out."""
    out = {}
    for k, v in _TALLY.items():
        old = snapshot.get(k, (0, 0, 0))
        new = tuple(a - b for a, b in zip(v, old))
        if new[0]:
            out[k] = new
    return out


def tally_bytes(records: dict) -> int:
    """The bytes handed to the transport in `records` (a `tally_since`)."""
    return sum(v[2] for v in records.values())


def all_reduce(t: torch.Tensor, group: Optional[object],
               op: str = "sum") -> torch.Tensor:
    """The sum (`op` "max": the largest) of `t` over the ranks of `group`
    (None: the tensor as it is, for a group of one)."""
    if group is None or _size(group) == 1:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    _record("all-reduce", _size(group), out, out)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_gather(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The ranks' `t` stacked on a new leading axis, in the order of their
    ranks in `group` (the mesh's worker order)."""
    if group is None or _size(group) == 1:
        return t[None]
    n = _size(group)
    flat = t.detach().contiguous().reshape(-1)
    out = flat.new_empty((n * flat.shape[0],))
    _record("all-gather", n, out, flat)
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
    _record("reduce-scatter", n, out, flat)
    _scatter_from(out, flat.detach().contiguous(), op=dist.ReduceOp.SUM,
                  group=group)
    return out


# ----------------------------------------------------------------------------
# autograd-aware forms, for a body written on local shards (the
# expert-parallel MoE): the reference's psum / pmean / tiled all_gather
# inside shard_map
# ----------------------------------------------------------------------------

class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        g = all_gather(t, group)                      # (n, ...)
        return torch.cat(g.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n, dim = _size(ctx.group), ctx.dim
        chunks = grad.movedim(dim, 0).contiguous()
        out = reduce_scatter(chunks.reshape(-1), ctx.group)
        return (out.reshape((chunks.shape[0] // n,)
                            + tuple(chunks.shape[1:])).movedim(0, dim),
                None, None)


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' `t` concatenated along `dim` in their order in `group`
    (the reference's `all_gather(..., axis=dim, tiled=True)`). Its
    backward is the reduce-scatter of the grad: every rank used the whole
    tensor on its own data."""
    if group is None or _size(group) == 1:
        return t
    return _AllGatherDim.apply(t, group, dim % t.dim())


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, scale):
        ctx.scale = scale
        out = all_reduce(t, group)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, grad):
        return (grad * ctx.scale if ctx.scale != 1.0 else grad), None, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, the same on every rank. The result is
    taken as replicated: every rank's grad of it is the whole grad, so
    the backward hands it on as it is (no collective)."""
    if group is None or _size(group) == 1:
        return t
    return _Psum.apply(t, group, 1.0)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest `t` over `group`, the same on every rank
    (the reference's `pmax`): an all-reduce, tallied and priced as
    `psum`'s. No grad: only the serving step's decode attention over a
    sequence-sharded cache takes it (`models.shards.decode_over_shards`),
    and serving records no graph."""
    return all_reduce(t, group, "max")


def pmean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of `t` over `group`, replicated as `psum`'s; the backward
    scales the grad by 1/n."""
    if group is None or _size(group) == 1:
        return t
    return _Psum.apply(t, group, 1.0 / _size(group))


# ----------------------------------------------------------------------------
# DTensor's collectives over the same transport
# ----------------------------------------------------------------------------

def dtensor_bytes_sent() -> int:
    """The bytes this process has handed to DTensor's routed collectives
    so far (each call's input tensor; a Shard -> Shard redistribution's
    all-gather included): read it before and after the work to meter."""
    return sum(v[2] for k, v in _TALLY.items() if k[2])


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
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _record("all-gather", n, out, t, routed=True)
    _gather_into(out, t, group=pg)
    if gather_dim % max(t.dim(), 1):
        out = torch.cat(out.chunk(n), dim=gather_dim)
    return out


def _dtensor_all_reduce(self, reduceOp, group, tag=""):
    pg = _group(group)
    out = self.detach().clone(memory_format=torch.contiguous_format)
    _record("all-reduce", _size(pg), out, out, routed=True)
    op = reduceOp.lower()
    dist.all_reduce(out, op=_OPS["sum" if op == "avg" else op], group=pg)
    return out / _size(pg) if op == "avg" else out


def _dtensor_reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
    pg = _group(group)
    n = _size(pg)
    op = reduceOp.lower()
    chunks = [c.contiguous() for c in self.detach().chunk(n, scatter_dim)]
    flat = torch.cat([c.reshape(-1) for c in chunks])
    out = flat.new_empty((flat.shape[0] // n,))
    _record("reduce-scatter", n, out, flat, routed=True)
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
