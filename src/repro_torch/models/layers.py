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

The MoE is the reference's portable path (`moe_forward`) in one
dispatch group: no caller sets the reference's `MOE_CTX["groups"]`. On a
process mesh (`launch.train.make_jitted_train_step`,
`launch.serve.make_jitted_serve_fns`) it runs as the reference's
`make_jitted_*` run it without the dry run's MoE context: the same
dispatch under DTensor's rules, the expert weights stored by the expert
rule. The reference's expert parallelism is not ported:
`_moe_forward_shardmap` and the `mesh`, `spec`, `dp`, `tp`, `fsdp` and
`gather_weights` fields of `set_moe_ctx` / `MOE_CTX` (ROADMAP.md Queue 1
item 13f), with the dry run that sets them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .shards import is_dtensor, lookup_rows

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
    p_j = j + W * torch.div(pos - j, W, rounding_mode="floor")
    return _decode_scores(q, kcache, vcache, (p_j >= 0) & (p_j <= pos),
                          softcap)


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
    B, S, d = x.shape
    H, KVh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ p.wq
    if "bq" in p:
        q = q + p.bq
    q = q.reshape(B, S, H, hd)
    src = x if cross_kv is None else cross_kv
    Sk = src.shape[1]
    k = src @ p.wk
    v = src @ p.wv
    if "bk" in p:
        k, v = k + p.bk, v + p.bv
    k = k.reshape(B, Sk, KVh, hd)
    v = v.reshape(B, Sk, KVh, hd)
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
    return h @ p.wo


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


def moe_capacity(T: int, cfg) -> int:
    """Slots an expert has in a dispatch of T tokens."""
    return max(1, int(math.ceil(T * cfg.capacity_factor / cfg.n_experts)))


def moe_route(p: Params, xt, cfg):
    """Top-1 routing of the tokens xt (T, d). Returns (eid, gate, pos,
    keep, prob): each token's expert (T,), its gate (the expert's
    probability, float32), its slot (its rank among the tokens routed to
    that expert, in token order), whether the slot is under the capacity,
    and the router's float32 softmax (T, E)."""
    E = cfg.n_experts
    prob = torch.softmax((xt @ p.router).float(), dim=-1)
    eid = torch.argmax(prob, dim=-1)
    onehot = F.one_hot(eid, E)
    gate = torch.sum(prob * onehot, dim=-1)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    keep = pos < moe_capacity(xt.shape[0], cfg)
    return eid, gate, pos, keep, prob


def moe_forward(p: Params, x, cfg, dff, aux: bool = True):
    """Top-1 capacity-dropped MoE over x (B, S, d); returns (out, aux),
    aux None when not asked for (serving throws it away).

    The T = B·S tokens are one dispatch group with C = ceil(T ·
    capacity_factor / E) slots an expert. A token at slot >= C is
    dropped: its expert output is 0 and the shared expert still applies.
    Kept tokens are scattered into a zeroed (E, C, d) buffer, every
    expert runs on its C slots (three batched products over E), and the
    outputs are gathered back, scaled by the gate. The scatter and the
    gather index a flat buffer with one spare row that dropped tokens
    write to and read zeros from, so no step waits on the host.
    aux = E · Σ_e mean(prob)_e · mean(onehot)_e, the load-balance
    loss."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, d)
    eid, gate, pos, keep, prob = moe_route(p, xt, cfg)
    C = moe_capacity(T, cfg)
    spare = E * C
    idx = torch.where(keep, eid * C + pos, spare)
    buf = x.new_zeros(spare + 1, d).index_put((idx,), xt)
    buf = buf[:spare].reshape(E, C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p.wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, p.wi)
    out_e = torch.einsum("ecf,efd->ecd", h, p.wo)
    out_e = torch.cat([out_e.reshape(spare, d), out_e.new_zeros(1, d)])
    out = out_e[idx] * (gate * keep).to(x.dtype)[:, None]
    if "shared" in p:
        out = out + mlp_forward(p.shared, xt, "swiglu")
    if not aux:
        return out.reshape(B, S, d), None
    me = torch.mean(prob, dim=0)
    ce = torch.mean(F.one_hot(eid, E).float(), dim=0)
    return out.reshape(B, S, d), E * torch.sum(me * ce)


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
