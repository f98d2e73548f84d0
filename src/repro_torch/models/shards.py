"""DTensor helpers of the sharded steps (`launch.sharding`): the model
code runs unchanged on plain tensors and on DTensors, and these are the
few places where it must know which.

  * `local_kernel`: a hand-written kernel (flash attention, the SSM scan)
    takes this rank's local shards: its batch rows and, over the "model"
    axis, its heads or its d_inner channels. It never sees a DTensor
    (the wrappers refuse one).
  * `write_rows` / `copy_into`: in-place cache writes that keep a DTensor
    cache's placements (a write into a view that DTensor had to gather
    would be lost).
  * `lookup_rows`: an embedding lookup on the table's own shards, where
    DTensor's rule for a vocab-sharded table fails.
  * `whole_dim`: a dim replicated before an op that DTensor cannot run
    on a shard of it (the gather of the gold logits).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placed(x, placements):
    """`x` (a DTensor) under `placements`."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def whole_dim(x, dim: int):
    """A DTensor with `dim` replicated (the others kept); a plain tensor as
    it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.dim()
    return placed(x, [Replicate() if isinstance(pl, Shard) and pl.dim == dim
                       else pl for pl in x.placements])


def local_kernel(kernel, args, batched, split, **kw):
    """Run a hand-written kernel (or an op DTensor is slow or unable to
    shard) on this rank's local shards. `args` are DTensors and plain
    tensors, the same on every rank (or, args[0] plain, all plain: the
    kernel is called on them). A mesh
    axis that shards args[0]'s dim 0 shards dim 0 of every arg that
    `batched` marks; the "model" axis splits dim `split[i]` of arg i (None:
    arg i replicated; an arg of size 1 there is replicated too, as MQA's
    one KV head) when every such dim divides; every other axis
    replicates. The local output is a DTensor placed as args[0]."""
    if not is_dtensor(args[0]):
        return kernel(*(a.contiguous() for a in args), **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    args = [as_dtensor(a, args[0]) for a in args]
    mesh = args[0].device_mesh
    names = mesh.mesh_dim_names or ()
    per_arg = [[] for _ in args]
    for i, pl in enumerate(args[0].placements):
        n = mesh.size(i)
        batch = isinstance(pl, Shard) and pl.dim == 0
        dims = [(a.shape[d] if d is not None else None)
                for a, d in zip(args, split)]
        model = (not batch and i < len(names) and names[i] == "model"
                 and dims[0] % n == 0
                 and all(m is None or m % n == 0 or m == 1 for m in dims))
        for j, a in enumerate(args):
            if batch and batched[j]:
                per_arg[j].append(Shard(0))
            elif model and dims[j] not in (None, 1):
                per_arg[j].append(Shard(split[j]))
            else:
                per_arg[j].append(Replicate())
    # an arg replicated on an axis that splits the output gets a partial
    # grad there: its shards' grads are summed, not taken as whole
    local = [placed(a, pls).to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) and isinstance(p0, Shard)
        else p for p, p0 in zip(pls, per_arg[0])]).contiguous()
        for a, pls in zip(args, per_arg)]
    out = kernel(*local, **kw)
    return DTensor.from_local(out, mesh, per_arg[0], run_check=False)


def lookup_rows(table, ids):
    """table[ids] for a DTensor `table` (V, d), on the table's shards as
    they are stored (DTensor's rule for a lookup into a vocab-sharded
    table, a masked partial sum, fails on torch 2.11 in the backward's
    index_put). On a mesh dim that shards the table the ids are
    replicated (they are small), and each rank looks up the ids in its
    own rows and columns: ids outside its rows give zeros, so the sum
    over the vocab's mesh dims is the lookup. The output ends placed as
    `ids` (batch), d whole: an all-reduce of the (B, S, d) rows over the
    vocab's dims and a gather of d's columns, where gathering the table
    would move all of it. The table's grad is summed where the ids were
    split and the table was not."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ids = as_dtensor(ids, table)
    mesh = table.device_mesh
    tpl = [pl if isinstance(pl, Shard) else Replicate()
           for pl in table.placements]
    ipl = [Replicate() if isinstance(t, Shard) else pl
           for t, pl in zip(tpl, ids.placements)]
    opl = [Partial() if isinstance(t, Shard) and t.dim == 0
           else Shard(ids.dim()) if isinstance(t, Shard) else pl
           for t, pl in zip(tpl, ipl)]
    local_ids = placed(ids, ipl).to_local().long()
    local = placed(table, tpl).to_local(grad_placements=[
        Partial() if isinstance(t, Replicate) and isinstance(o, Shard)
        else t for t, o in zip(tpl, opl)])
    rows = local.shape[0]
    block = 0                     # this rank's block of rows, outer first
    for i, pl in enumerate(tpl):
        if isinstance(pl, Shard) and pl.dim == 0:
            block = block * mesh.size(i) + mesh.get_local_rank(i)
    at = local_ids - block * rows
    hit = (at >= 0) & (at < rows)
    out = F.embedding(at.clamp(0, rows - 1), local)
    out = torch.where(hit[..., None], out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
    out = DTensor.from_local(out, mesh, opl, run_check=False)
    return placed(out, ids.placements)


def write_rows(dst, src, start: int):
    """dst[:, start:start + src.shape[1]] = src, in place; a DTensor
    `dst` keeps its placements."""
    end = start + src.shape[1]
    if not is_dtensor(dst):
        dst[:, start:end] = src.to(dst.dtype)
        return
    src = as_dtensor(src.to(dst.dtype), dst)
    new = whole_dim(dst, 1).slice_scatter(whole_dim(src, 1), dim=1,
                                           start=start, end=end)
    dst.copy_(placed(new, dst.placements))


def as_dtensor(x, like):
    """`x` as a DTensor on `like`'s mesh (a plain tensor, the same on every
    rank, replicated)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def copy_into(dst, src):
    """dst.copy_(src); a DTensor `dst` keeps its placements."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    dst.copy_(placed(as_dtensor(src.to(dst.dtype), dst), dst.placements))
