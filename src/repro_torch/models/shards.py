"""DTensor helpers of the sharded steps (`launch.sharding`): the model
code runs unchanged on plain tensors and on DTensors, and these are the
few places where it must know which.

  * `local_kernel`: a hand-written kernel (flash attention, the SSM scan)
    takes this rank's local shards: its batch rows and, over the "model"
    axis, its heads or its d_inner channels. It never sees a DTensor
    (the wrappers refuse one).
  * `write_rows` / `copy_into`: in-place cache writes that keep a DTensor
    cache's placements (a write into a view that DTensor had to gather
    would be lost); a cache split along its sequence is written on the
    shard that owns the rows.
  * `decode_over_shards`: decode attention over a cache split along its
    sequence or its head dim, each rank on its own slots, the ranks'
    softmax statistics combined (serve_long's caches, never gathered).
  * `lookup_rows`: an embedding lookup on the table's own shards, where
    DTensor's rule for a vocab-sharded table fails.
  * `whole_dim`: a dim replicated before an op that DTensor cannot run
    on a shard of it (the gather of the gold logits).
  * `split_heads` / `merge_heads`: the projection's last dim cut into
    heads and back, made whole first (in the backward too) where the
    heads do not split over the mesh.
  * `reduced`: partial sums reduced where DTensor would carry them into
    the next product and run it whole, or gather that product's weight
    (the SSM's x_proj output; the input products of the SSM and the
    RG-LRU and the MLP's hidden layer, whose sums over a sharded d_model
    a serving step carries).
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


def split_heads(x, n_heads: int, head_dim: int):
    """x (..., n_heads * head_dim) as (..., n_heads, head_dim). A DTensor
    whose last dim is split over a mesh dim that does not divide the heads
    (40 heads over 16 "model" ranks) has that dim made whole first:
    DTensor cannot split a shard across the heads, where the reference's
    partitioner pads."""
    if is_dtensor(x) and _uneven_heads(x, n_heads, x.dim() - 1):
        x = whole_dim(x, x.dim() - 1)
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _uneven_heads(x, n_heads: int, dim: int) -> bool:
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    return any(isinstance(pl, Shard) and pl.dim == dim
               and n_heads % mesh.size(i)
               for i, pl in enumerate(x.placements))


class _WholeGrad(torch.autograd.Function):
    """The identity, whose backward makes the grad's last dim whole."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return whole_dim(grad, -1)


def merge_heads(x, n_heads: int):
    """x (..., n_heads, head_dim) as (..., n_heads * head_dim). A DTensor
    whose merged dim may come back in the backward split over a mesh dim
    that does not divide the heads has its grad's last dim made whole
    first, so the backward's split into heads is `split_heads`'."""
    out = x.reshape(*x.shape[:-2], -1)
    if is_dtensor(out) and torch.is_grad_enabled() and out.requires_grad:
        mesh = out.device_mesh
        if any(n_heads % mesh.size(i) for i in range(mesh.ndim)):
            out = _WholeGrad.apply(out)
    return out


def reduced(x):
    """A DTensor with its partial sums reduced (every Partial placement
    made Replicate, an all-reduce), before an op that is not linear in
    them; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    return placed(x, [Replicate() if isinstance(pl, Partial) else pl
                      for pl in x.placements])


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
    `dst` keeps its placements. A DTensor whose dim 1 is split writes on
    the ranks that hold the rows only, each into its own shard (`src` made
    whole along dim 1, dst never gathered)."""
    end = start + src.shape[1]
    if not is_dtensor(dst):
        dst[:, start:end] = src.to(dst.dtype)
        return
    src = as_dtensor(src.to(dst.dtype), dst)
    if not _split_dims(dst, 1):
        new = whole_dim(dst, 1).slice_scatter(whole_dim(src, 1), dim=1,
                                               start=start, end=end)
        dst.copy_(placed(new, dst.placements))
        return
    rows = placed(src, _whole_on(dst.placements, 1)).to_local()
    local = dst.to_local()
    first = _first_row(dst, 1)
    lo = max(start, first)
    hi = min(end, first + local.shape[1])
    if lo < hi:
        local[:, lo - first:hi - first] = rows[:, lo - start:hi - start]


def _split_dims(t, dim: int) -> list:
    """The mesh dims that split tensor dim `dim` of the DTensor `t`."""
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(t.placements)
            if isinstance(pl, Shard) and pl.dim == dim]


def _whole_on(placements, dim: int) -> list:
    """`placements` with the mesh dims that split tensor dim `dim`
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
            for pl in placements]


def _first_row(t, dim: int) -> int:
    """The index in the whole DTensor `t` of this rank's first row along
    `dim` (even shards, the outer mesh dim first)."""
    mesh, block, n = t.device_mesh, 0, 1
    for i in _split_dims(t, dim):
        block = block * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return block * (t.shape[dim] // n)


def splits_slots(cache) -> bool:
    """Whether a DTensor k/v cache (B, S, KV, hd) is split along its
    sequence (dim 1) or its head dim (dim 3): decode attention then runs
    on the shards (`decode_over_shards`)."""
    return is_dtensor(cache) and bool(_split_dims(cache, 1)
                                      or _split_dims(cache, 3))


def decode_over_shards(q, kcache, vcache, valid_at, softcap=None):
    """Decode attention of q (B,1,H,hd) over a DTensor cache (B,S,KV,hd)
    split along its sequence over some mesh dims (serve_long's "data")
    and along KV heads or head_dim over "model", without gathering the
    cache: each rank scores its own slots, whose indices in the whole
    cache are its first row's plus arange, and `valid_at(idx)` ((T,)
    bool: `layers.decode_valid`) says which count. Each rank keeps its
    largest score m, l = Σ exp(s - m) and o = Σ exp(s - m)·v
    (`layers.decode_partial`), and the ranks of the sequence's mesh dims
    combine them (flash-decoding's split-KV combine): m* = pmax(m), then
    one psum of (exp(m - m*)·o, exp(m - m*)·l) and their quotient: over
    the sequence's mesh dims only (m, l, o) cross the wire, whose size
    does not depend on S. Where head_dim is split, the partial scores of
    the rank's slots are summed over its mesh dims first. q goes to the
    cache's split of batch, heads and head_dim (a
    reshuffle of the one token's q); the output is a DTensor placed so,
    whole over the sequence's mesh dims, its heads split where head_dim
    was."""
    from torch.distributed.tensor import DTensor, Shard
    from ..comm.collectives import pmax, psum
    from .layers import decode_partial
    mesh = kcache.device_mesh
    q_pl = _whole_on(kcache.placements, 1)
    k = kcache.to_local()
    v = placed(as_dtensor(vcache, kcache), kcache.placements).to_local()
    ql = placed(as_dtensor(q, kcache), q_pl).to_local()
    first = _first_row(kcache, 1)
    idx = first + torch.arange(k.shape[1], device=k.device)
    hd_groups = [mesh.get_group(i) for i in _split_dims(kcache, 3)]
    seq_groups = [mesh.get_group(i) for i in _split_dims(kcache, 1)]

    def score_sum(s):
        for g in hd_groups:
            s = psum(s, g)
        return s

    m, l, o = decode_partial(ql, k, v, valid_at(idx), softcap,
                             head_dim=kcache.shape[3],
                             score_sum=score_sum if hd_groups else None)
    B, _, KV, G, hd = o.shape
    if seq_groups:
        m_all = m
        for g in seq_groups:
            m_all = pmax(m_all, g)
        w = torch.exp(m - m_all)                          # (B,KV,G,1)
        parts = torch.cat([(o * w.permute(0, 3, 1, 2)[..., None])
                           .reshape(B, -1), (w * l).reshape(B, -1)], dim=1)
        for g in seq_groups:
            parts = psum(parts, g)
        o = parts[:, :KV * G * hd].reshape(o.shape)
        l = parts[:, KV * G * hd:].reshape(l.shape)
    out = (o / l.permute(0, 3, 1, 2)[..., None]).reshape(B, 1, KV * G, hd)
    out = DTensor.from_local(out.to(v.dtype), mesh, q_pl, run_check=False)
    # a head_dim split goes back to a split of the heads (one token's
    # output reshuffled), so the heads merge into the output projection
    # as the head-sharded layout's do
    H = q.shape[2]
    return placed(out, [Shard(2) if isinstance(pl, Shard) and pl.dim == 3
                        and H % mesh.size(i) == 0 else pl
                        for i, pl in enumerate(q_pl)])


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
