"""Core NN layers (`repro.models.layers` counterpart): norms, partial RoPE
and M-RoPE, chunked-softmax attention, causal (global or sliding-window)
or bidirectional (GQA/MQA, softcap, qk-norm), cross attention over
another sequence's K/V, single-token decode attention over a dense
cache or a ring buffer of `window` slots, gated MLPs, the top-1 MoE with
capacity-dropped dispatch, embeddings.

Weights keep the reference's layout: a projection is stored (in, out) and
applied as `x @ W`, so a reference pytree loads without transposes. Each
weight group is a `Params` module whose attribute names are the reference
dict's keys, so a module's `state_dict` keys are the reference pytree's
paths joined with dots.

The MoE has the reference's two dispatch modes, chosen by `MOE_CTX`
(`set_moe_ctx`, all seven fields): the portable grouped dispatch
(`moe_forward`, G = `groups` independently capacitated groups; under
DTensor's rules on a process mesh when no mesh is set, as the
reference's `make_jitted_*` run it), and the expert parallelism of
`_moe_forward_shardmap` when `mesh` is set (a process mesh,
`launch.mesh.make_process_mesh`): its body runs on each rank's local
shards and calls the port's collectives (`comm.collectives`) on the
mesh's subgroups, as the reference's shard_map body calls psum and
all_gather. There is no shard_map: the local shards are taken from the
DTensors and the output made a DTensor again.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .shards import is_dtensor, lookup_rows, reduced, split_heads

NEG = -1e30


class Params(nn.Module):
    """A named group of weights (and nested groups): the counterpart of one
    dict of the reference pytree. Weights are trainable parameters
    (`launch.train`, `optim.localdp`); serving and scoring run under
    `torch.inference_mode()` / `torch.no_grad()` and record no graph."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ----------------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------------

def init_device(gen) -> torch.device:
    """Where an init draws: `gen`'s device, or "meta" (shapes only, no
    values) when `gen` is None."""
    return gen.device if gen is not None else torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype, scale=None):
    """Normal(0, scale) draws from `gen`, on `gen`'s device; scale defaults
    to 1/sqrt(fan_in) with fan_in = shape[0]. A stack of 3 or more axes
    (the experts) is drawn one slice of axis 0 at a time in float32, so
    the transient is one slice's and not the stack's (maverick's
    (128, 5120, 8192) is 21.5 GB in float32)."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if len(shape) < 3:
        x = torch.randn(shape, generator=gen, device=init_device(gen),
                        dtype=torch.float32)
        return (x * s).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=init_device(gen))
    if gen is not None:
        for piece in out:
            piece.copy_(dense_init(gen, shape[1:], dtype, scale=s))
    return out


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return ((1.0 + gamma.float()) * out).to(x.dtype)


def layernorm(x, gamma, beta, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (gamma.float() * out + beta.float()).to(x.dtype)


def apply_norm(p: Params, x, kind):
    if kind == "rmsnorm":
        return rmsnorm(x, p.g)
    return layernorm(x, p.g, p.b)


def init_norm(d, kind, dtype, device):
    if kind == "rmsnorm":
        return Params(g=torch.zeros((d,), dtype=dtype, device=device))
    return Params(g=torch.ones((d,), dtype=dtype, device=device),
                  b=torch.zeros((d,), dtype=dtype, device=device))


# ----------------------------------------------------------------------------
# RoPE (+ partial)
# ----------------------------------------------------------------------------

def rope_freqs(head_dim, rope_pct, base, device=None):
    rot = int(head_dim * rope_pct) // 2 * 2
    inv = 1.0 / (base ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=device) / rot))
    return inv, rot


def apply_rope(x, positions, *, rope_pct=1.0, base=10_000.0,
               mrope_sections=None):
    """x: (..., S, H, hd); positions: (..., S) int, or (3, ..., S) under
    M-RoPE: the rot/2 frequency slots are split into `mrope_sections`,
    each driven by its own position stream (temporal, height, width)."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, rope_pct, base, x.device)
    if rot == 0:
        return x
    if mrope_sections is not None:
        assert sum(mrope_sections) == rot // 2, (mrope_sections, rot)
        pos = torch.cat([positions[i][..., None].expand(
                             *positions[i].shape, n)
                         for i, n in enumerate(mrope_sections)], dim=-1)
        theta = pos.float() * inv                          # (..., S, rot/2)
    else:
        theta = positions[..., None].float() * inv
    cos = torch.cos(theta)[..., None, :]                   # (..., S, 1, rot/2)
    sin = torch.sin(theta)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2].float(), xr[..., rot // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------

def _softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def pick_chunk(S, want):
    """Largest divisor of S that is <= want (graceful for odd lengths)."""
    c = min(want, S)
    while S % c:
        c -= 1
    return c


def _attn_scores(q, k, softcap):
    # q: (B, C, KV, G, hd)  k: (B, T, KV, hd) -> (B, KV, G, C, T), float32,
    # scaled by 1/sqrt(hd)
    # (bf16 products are exact in float32: the reference's
    # preferred_element_type=float32)
    s = torch.einsum("bckgh,btkh->bkgct", q.float(), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    return _softcap(s, softcap)


def chunked_attention(q, k, v, positions, *, causal=True, window=None,
                      softcap=None, q_chunk=512):
    """Causal attention, global or over a sliding window, or bidirectional
    attention, with a softmax over query chunks. q: (B,Sq,H,hd), k/v:
    (B,Sk,KV,hd), positions: (B,Sq) int, the queries' and (when causal,
    Sk = Sq) the keys'. Returns (B,Sq,H,hd) in v's dtype.

    `causal=False` scores each chunk of queries against all Sk keys, which
    may be another sequence (cross attention), with no mask. A causal
    window W < Sq scores each chunk of C queries against a strip of
    C + Wpad keys (Wpad = ceil(W/C)·C) starting Wpad before the chunk, so
    the work is O(S·W); the mask 0 <= pq - pk < W is built from the
    query positions, as the reference's. As the reference's
    `dynamic_slice`, a strip that would run past the end starts earlier
    instead of being cut short."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    C = pick_chunk(S, q_chunk)
    qg = q.reshape(B, S, KV, G, hd)
    windowed = causal and window is not None and window < S
    if windowed:
        Wpad = -(-window // C) * C
        T = min(C + Wpad, S)
    outs = []
    for qs in range(0, S, C):
        qc = qg[:, qs:qs + C]
        if windowed:
            ks = min(max(qs - Wpad, 0), S - T)
            kc, vc, pk = (t[:, ks:ks + T] for t in (k, v, positions))
        else:
            kc, vc, pk = k, v, positions
        s = _attn_scores(qc, kc, softcap)                   # (B,KV,G,C,T)
        if causal:
            pq = positions[:, qs:qs + C]
            dp = pq[:, None, None, :, None] - pk[:, None, None, None, :]
            m = (dp >= 0) & (dp < window) if windowed else dp >= 0
            s = torch.where(m, s, NEG)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgct,btkh->bckgh", p.to(vc.dtype), vc))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def _decode_scores(q, kcache, vcache, valid, softcap):
    """Attention of q (B,1,H,hd) over cache slots (B,T,KV,hd) where
    `valid` (T,) bool says which slots count."""
    B, T, KV, hd = kcache.shape
    H = q.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = _attn_scores(qg, kcache, softcap)                   # (B,KV,G,1,T)
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgct,btkh->bckgh", p.to(vcache.dtype), vcache)
    return out.reshape(B, 1, H, hd)


def decode_attention(q, kcache, vcache, pos, *, window=None, softcap=None):
    """Single-token attention against a cache. q: (B,1,H,hd);
    k/vcache: (B,S,KV,hd); pos: int, the last valid position. A window
    W < S scores only the W slots from clip(pos - (W-1), 0, S - W)."""
    S = kcache.shape[1]
    start, T = 0, S
    if window is not None and window < S:
        start, T = min(max(pos - (window - 1), 0), S - window), window
    idx = start + torch.arange(T, device=q.device)
    return _decode_scores(q, kcache[:, start:start + T],
                          vcache[:, start:start + T], idx <= pos, softcap)


def decode_attention_ring(q, kcache, vcache, pos, *, window, softcap=None):
    """Decode attention over a ring-buffer cache of `window` slots: slot j
    holds position p_j = j + W·floor((pos - j)/W) <= pos, and a slot with
    p_j < 0 has not been written yet."""
    W = kcache.shape[1]
    j = torch.arange(W, device=q.device)
    return _decode_scores(q, kcache, vcache,
                          decode_valid(pos, j, length=W, ring=True), softcap)


def decode_valid(pos, idx, *, length, window=None, ring=False):
    """Which cache slots, by their indices `idx` (T,) in the whole cache of
    `length` slots, a decode at position `pos` attends to: on a ring
    (`decode_attention_ring`) slot j holds p_j = j + W·floor((pos - j)/W)
    and counts when 0 <= p_j <= pos; on a dense cache slot i counts when
    i <= pos and, under a window W < length, when it lies in the W slots
    from clip(pos - (W-1), 0, length - W) (`decode_attention`'s)."""
    if ring:
        p = idx + length * torch.div(pos - idx, length, rounding_mode="floor")
        return (p >= 0) & (p <= pos)
    valid = idx <= pos
    if window is not None and window < length:
        start = min(max(pos - (window - 1), 0), length - window)
        valid = valid & (idx >= start) & (idx < start + window)
    return valid


def decode_partial(q, kcache, vcache, valid, softcap, *, head_dim=None,
                   score_sum=None):
    """One shard's part of decode attention (flash-decoding's split KV):
    q (B,1,H,hd) over this shard's slots (B,T,KV,hd), of which `valid`
    (T,) count. Returns float32 (m, l, o): the largest score (B,KV,G,1),
    l = Σ exp(s - m) (B,KV,G,1) and o = Σ exp(s - m)·v (B,1,KV,G,hd); the
    attention is o / l once the shards' parts are combined
    (`shards.decode_over_shards`). A shard whose slots all fail `valid`
    has m = NEG, and weighs nothing beside one that has a slot. Where q
    and the cache hold a slice of the head dim, `head_dim` is the whole
    one and `score_sum` sums the slices' partial scores before the scale,
    the softcap and the mask."""
    B, T, KV, hd = kcache.shape
    H = q.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bckgh,btkh->bkgct", qg.float(), kcache.float())
    if score_sum is not None:
        s = score_sum(s)
    s = _softcap(s * (1.0 / math.sqrt(head_dim or hd)), softcap)
    s = torch.where(valid, s, NEG)                          # (B,KV,G,1,T)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgct,btkh->bckgh", p.to(vcache.dtype), vcache)
    return m, p.sum(dim=-1), o.float()


def init_attn(gen, cfg, dtype):
    d, H, KVh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dev = init_device(gen)
    p = {"wq": dense_init(gen, (d, H * hd), dtype),
         "wk": dense_init(gen, (d, KVh * hd), dtype),
         "wv": dense_init(gen, (d, KVh * hd), dtype),
         "wo": dense_init(gen, (H * hd, d), dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KVh * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KVh * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["qnorm"] = Params(g=torch.zeros((hd,), dtype=dtype, device=dev))
        p["knorm"] = Params(g=torch.zeros((hd,), dtype=dtype, device=dev))
    return Params(**p)


def attn_qkv(p: Params, x, cfg, positions, rope_base, cross_kv=None):
    """q (B,S,H,hd), k and v (B,Sk,KV,hd): k and v from `cross_kv`
    (B,Sk,d) when given (cross attention, Sk its own length, no RoPE),
    else from x (Sk = S)."""
    H, KVh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ p.wq
    if "bq" in p:
        q = q + p.bq
    q = split_heads(q, H, hd)
    src = x if cross_kv is None else cross_kv
    k = src @ p.wk
    v = src @ p.wv
    if "bk" in p:
        k, v = k + p.bk, v + p.bv
    k = split_heads(k, KVh, hd)
    v = split_heads(v, KVh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.qnorm.g)
        k = rmsnorm(k, p.knorm.g)
    if rope_base is not None and cross_kv is None:
        q = apply_rope(q, positions, rope_pct=cfg.rope_pct, base=rope_base,
                       mrope_sections=cfg.mrope_sections)
        k = apply_rope(k, positions, rope_pct=cfg.rope_pct, base=rope_base,
                       mrope_sections=cfg.mrope_sections)
    return q, k, v


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------

def init_mlp(gen, d, dff, kind, dtype):
    if kind in ("geglu", "swiglu"):
        return Params(wi=dense_init(gen, (d, dff), dtype),
                      wg=dense_init(gen, (d, dff), dtype),
                      wo=dense_init(gen, (dff, d), dtype))
    return Params(wi=dense_init(gen, (d, dff), dtype),
                  wo=dense_init(gen, (dff, d), dtype))


def mlp_forward(p: Params, x, kind):
    # jax.nn.gelu defaults to the tanh approximation
    if kind == "geglu":
        h = F.gelu(x @ p.wg, approximate="tanh") * (x @ p.wi)
    elif kind == "swiglu":
        h = F.silu(x @ p.wg) * (x @ p.wi)
    else:  # gelu
        h = F.gelu(x @ p.wi, approximate="tanh")
    # a DTensor h with partial sums (the gate's product over a sharded
    # d_model times the other's) is reduced before the down projection,
    # where DTensor would gather wo to carry them
    return reduced(h) @ p.wo


# ----------------------------------------------------------------------------
# MoE: top-1 router, capacity-dropped dispatch into (G, E, C, d)
# ----------------------------------------------------------------------------

def init_moe(gen, cfg, dff, dtype):
    E, d = cfg.n_experts, cfg.d_model
    p = {"router": dense_init(gen, (d, E), dtype, scale=0.02),
         "wi": dense_init(gen, (E, d, dff), dtype),
         "wg": dense_init(gen, (E, d, dff), dtype),
         "wo": dense_init(gen, (E, dff, d), dtype)}
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, d, dff, "swiglu", dtype)
    return Params(**p)


# Launcher-installed MoE dispatch context (the reference's). Portable
# (mesh None): the grouped dispatch in G = `groups` groups, `spec` the
# DTensor placements its (E, G C, d) buffer is redistributed to (None:
# left to DTensor's rules). Expert-parallel (mesh a process mesh):
# tokens stay on their `dp` shard, each `tp` rank owns E/|tp| experts,
# the weights (E_loc, d/|fsdp|, ff) are all-gathered over `fsdp` when
# `gather_weights` (train, prefill) or stay resident and the partial
# activations are summed over `fsdp` (decode).
MOE_CTX = {"groups": 1, "spec": None, "mesh": None, "dp": None,
           "tp": "model", "fsdp": None, "gather_weights": True}


def set_moe_ctx(groups=1, spec=None, mesh=None, dp=None, tp="model",
                fsdp=None, gather_weights=True):
    """Install the MoE dispatch context; no arguments restore the
    portable one-group default. gather_weights=True: the FSDP
    just-in-time all-gather of the expert weights (training and prefill,
    amortized over many tokens). False: the weights stay resident 2-D
    sharded, the token batch is gathered over the fsdp axes and the
    expert products' partial sums are summed there (decode)."""
    MOE_CTX.update(groups=groups, spec=spec, mesh=mesh, dp=dp, tp=tp,
                   fsdp=fsdp, gather_weights=gather_weights)


def moe_capacity(T: int, cfg) -> int:
    """Slots an expert has in a dispatch group of T tokens."""
    return max(1, int(math.ceil(T * cfg.capacity_factor / cfg.n_experts)))


def moe_route(p: Params, xt, cfg):
    """Top-1 routing of the tokens xt (T, d), or of G groups of them
    (G, T, d), each group capacitated on its own. Returns (eid, gate,
    pos, keep, prob): each token's expert, its gate (the expert's
    probability, float32), its slot (its rank among its group's tokens
    routed to that expert, in token order), whether the slot is under
    the capacity, and the router's float32 softmax (..., T, E)."""
    return _route(p.router, xt, cfg)


def _route(router, xt, cfg):
    E = cfg.n_experts
    prob = torch.softmax((xt @ router).float(), dim=-1)
    eid = torch.argmax(prob, dim=-1)
    onehot = F.one_hot(eid, E)
    gate = torch.sum(prob * onehot, dim=-1)
    # the token dim by its index: DTensor's cumsum rule mis-reads dim=-2
    pos = torch.sum((torch.cumsum(onehot, dim=onehot.dim() - 2) - 1)
                    * onehot, dim=-1)
    keep = pos < moe_capacity(xt.shape[-2], cfg)
    return eid, gate, pos, keep, prob


def _experts(buf, wi, wg, wo):
    """The experts' swiglu FFN on their slots: buf (E, C, d) -> (E, C, d),
    three batched products over E."""
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, wi)
    return torch.einsum("ecf,efd->ecd", h, wo)


def _aux(prob, eid, E):
    """E · Σ_e mean(prob)_e · mean(onehot)_e over every token."""
    prob = prob.reshape(-1, E)
    me = torch.mean(prob, dim=0)
    ce = torch.mean(F.one_hot(eid.reshape(-1), E).float(), dim=0)
    return E * torch.sum(me * ce)


def moe_forward(p: Params, x, cfg, dff, aux: bool = True):
    """Top-1 capacity-dropped MoE over x (B, S, d); returns (out, aux),
    aux None when not asked for (serving throws it away). With
    `MOE_CTX["mesh"]` set it is the expert-parallel `_moe_forward_shardmap`
    (or raises), never the portable path.

    Portable: the T = B·S tokens are split into G = MOE_CTX["groups"]
    dispatch groups of consecutive tokens (G = 1 when G does not divide
    T), each with C = ceil(T/G · capacity_factor / E) slots an expert. A
    token at slot >= C is dropped: its expert output is 0 and the shared
    expert still applies. Kept tokens are scattered into a zeroed (E, G
    C, d) buffer (expert e, group g, slot c at row g C + c), every expert
    runs on its G C slots (three batched products over E), and the
    outputs are gathered back, scaled by the gate. The scatter and the
    gather index a flat buffer with one spare row that dropped tokens
    write to and read zeros from, so no step waits on the host.
    aux = E · Σ_e mean(prob)_e · mean(onehot)_e over all T tokens, the
    load-balance loss."""
    if MOE_CTX["mesh"] is not None:
        return _moe_forward_shardmap(p, x, cfg, dff, aux)
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    G = MOE_CTX["groups"] if T % max(MOE_CTX["groups"], 1) == 0 else 1
    Tg = T // G
    xt = x.reshape(T, d)
    eid, gate, pos, keep, prob = moe_route(
        p, xt if G == 1 else xt.reshape(G, Tg, d), cfg)
    eid, gate, pos, keep = (t.reshape(T) for t in (eid, gate, pos, keep))
    C = moe_capacity(Tg, cfg)
    spare = E * G * C
    slot = pos if G == 1 else (torch.arange(T, device=x.device) // Tg) * C \
        + pos
    idx = torch.where(keep, eid * (G * C) + slot, spare)
    buf = x.new_zeros(spare + 1, d).index_put((idx,), xt)
    buf = buf[:spare].reshape(E, G * C, d)
    if MOE_CTX["spec"] is not None and is_dtensor(buf):
        from .shards import placed
        buf = placed(buf, MOE_CTX["spec"])
    out_e = _experts(buf, p.wi, p.wg, p.wo)
    out_e = torch.cat([out_e.reshape(spare, d), out_e.new_zeros(1, d)])
    out = out_e[idx] * (gate * keep).to(x.dtype)[:, None]
    if "shared" in p:
        out = out + mlp_forward(p.shared, xt, "swiglu")
    if not aux:
        return out.reshape(B, S, d), None
    return out.reshape(B, S, d), _aux(prob, eid, E)


def _ep_local(t, mesh, spec):
    """(this rank's shard of the DTensor `t` under `spec` (a
    `launch.sharding.P` on the mesh's axes), its placements). The grad of
    a dim the shard replicates is partial: the ranks there work on other
    tokens, or on other experts' share of the same ones."""
    from torch.distributed.tensor import Partial, Replicate
    from ..launch.sharding import placements
    from .shards import placed
    layout = tuple(tuple(n.split("+")) for n in t.device_mesh.mesh_dim_names)
    pls = placements(mesh, spec, layout)
    local = placed(t, pls).to_local(grad_placements=[
        Partial() if isinstance(pl, Replicate) else pl for pl in pls])
    return local, pls


def _moe_forward_shardmap(p, x, cfg, dff, aux: bool = True):
    """Expert-parallel MoE on the process mesh `MOE_CTX["mesh"]` (the
    reference's shard_map body, on local shards). x (B, S, d) and the
    weights are DTensors on the mesh. Each rank takes its dp shard of
    the tokens (B_loc, S, d), whole over the other axes, and its experts'
    weights (E_loc, d/|fsdp|, ff) as stored (P(tp, fsdp, None)).

    gather_weights (or no fsdp axes): the weights are all-gathered over
    fsdp, the router too, and the rank routes its own tokens as one
    group, C = ceil(T_loc · cf / E). Resident: the token batch is
    gathered over fsdp instead (every fsdp rank must see the same tokens
    before summing partial products), the experts contract the rank's
    d slice and its ff slice, and the partial sums are summed over fsdp.
    Every rank of a tp column routes the same tokens; it computes only
    the tokens routed to its experts [base, base + E_loc), base = tp
    index · E_loc, and the outputs are summed over tp (and fsdp when
    resident), then the rank's dp rows are taken back. aux is the mean
    over dp and tp of each rank's aux. The shared expert runs outside,
    under DTensor's rules (plain TP)."""
    from torch.distributed.tensor import DTensor, Replicate
    from ..comm import collectives as col
    from ..launch.sharding import P, _axes
    mesh = MOE_CTX["mesh"]
    if not getattr(mesh, "is_process", False):
        raise ValueError("the expert-parallel MoE needs a process mesh "
                         "(launch.mesh.make_process_mesh) in MOE_CTX")
    if not (is_dtensor(x) and is_dtensor(p.wi)):
        raise ValueError("the expert-parallel MoE takes DTensors on the "
                         "mesh (launch.sharding.place_model)")
    tp, dp_axes = MOE_CTX["tp"], _axes(MOE_CTX["dp"])
    fsdp = MOE_CTX["fsdp"]
    fsdp_axes = _axes(fsdp)
    B, S, d = x.shape
    E = cfg.n_experts
    ntp = mesh.shape[tp]
    if E % ntp:
        raise ValueError(f"{E} experts do not split over {ntp} {tp} ranks")
    E_loc = E // ntp
    gather_w = MOE_CTX["gather_weights"] or not fsdp_axes
    nfs = math.prod(mesh.shape[a] for a in fsdp_axes)
    g_fs = mesh.subgroup(fsdp_axes) if fsdp_axes else None
    g_tp = mesh.subgroup((tp,))
    dp_spec = (dp_axes if len(dp_axes) > 1 else dp_axes[0]) if dp_axes \
        else None
    xl, x_pls = _ep_local(x, mesh, P(dp_spec, None, None))
    w_spec = P(tp, fsdp, None)
    wi, wg, wo = (_ep_local(t, mesh, w_spec)[0] for t in (p.wi, p.wg, p.wo))
    router = _ep_local(p.router, mesh, P(fsdp, None))[0]
    if fsdp_axes and gather_w:
        wi, wg, wo = (col.all_gather_dim(w, g_fs, 1) for w in (wi, wg, wo))
    if fsdp_axes:
        router = col.all_gather_dim(router, g_fs, 0)
    Bl, Sl, _ = xl.shape
    if not gather_w:
        xl = col.all_gather_dim(xl, g_fs, 0)
        Bl = xl.shape[0]
    T = Bl * Sl
    xt = xl.reshape(T, d)
    eid, gate, pos, keep, prob = _route(router, xt, cfg)
    C = moe_capacity(T, cfg)
    base = mesh.coords()[tp] * E_loc
    mine = (eid >= base) & (eid < base + E_loc) & keep
    spare = E_loc * C
    idx = torch.where(mine, (eid - base) * C + pos, spare)
    buf = xt.new_zeros(spare + 1, d).index_put((idx,), xt)
    buf = buf[:spare].reshape(E_loc, C, d)
    if gather_w:
        out_e = _experts(buf, wi, wg, wo)
    else:
        # resident 2-D weights: contract the local d slice, sum the
        # (decode-sized) partial activations over fsdp, then the ff slice
        fr = 0
        for a in fsdp_axes:
            fr = fr * mesh.shape[a] + mesh.coords()[a]
        d_loc, ff_loc = wi.shape[1], wo.shape[1]
        buf_d = buf[:, :, fr * d_loc:(fr + 1) * d_loc]
        h = F.silu(col.psum(torch.einsum("ecd,edf->ecf", buf_d, wg), g_fs))
        h = h * col.psum(torch.einsum("ecd,edf->ecf", buf_d, wi), g_fs)
        out_e = torch.einsum("ecf,efd->ecd",
                             h[:, :, fr * ff_loc:(fr + 1) * ff_loc], wo)
    out_e = torch.cat([out_e.reshape(spare, d), out_e.new_zeros(1, d)])
    out = out_e[idx] * (gate * mine).to(xl.dtype)[:, None]
    out = col.psum(out, g_tp if gather_w
                   else mesh.subgroup((tp,) + fsdp_axes))
    if not gather_w:
        Bo = Bl // nfs
        out = out.reshape(Bl, Sl, d)[fr * Bo:(fr + 1) * Bo]
    out = DTensor.from_local(out.reshape(-1, Sl, d), x.device_mesh, x_pls,
                             run_check=False)
    if "shared" in p:   # the shared expert: plain TP, under DTensor's rules
        out = out + mlp_forward(p.shared, x.reshape(B * S, d),
                                "swiglu").reshape(B, S, d)
    if not aux:
        return out, None
    a = _aux(prob, eid, E)
    if dp_axes:
        a = col.pmean(a, mesh.subgroup(dp_axes + (tp,)))
    return out, DTensor.from_local(a, x.device_mesh,
                                   [Replicate()] * x.device_mesh.ndim,
                                   run_check=False)


# ----------------------------------------------------------------------------
# embeddings / head
# ----------------------------------------------------------------------------

def init_embed(gen, cfg, dtype):
    p = {"tok": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype,
                               scale=0.02)
    return Params(**p)


def embed_rows(table, tokens):
    """table[tokens]; a DTensor table is looked up on its shards
    (`shards.lookup_rows`)."""
    if is_dtensor(table):
        return lookup_rows(table, tokens)
    return F.embedding(tokens, table)


def embed_tokens(p: Params, tokens, cfg):
    x = embed_rows(p.tok, tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(p: Params, x, cfg):
    w = p.tok.T if cfg.tie_embeddings else p.head
    logits = (x @ w.to(x.dtype)).float()
    return _softcap(logits, cfg.final_softcap)
