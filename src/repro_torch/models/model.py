"""The LMs (`repro.models.model` counterpart): weights as `nn.Module`s,
the scoring forward (chunked cross-entropy loss), prefill and
single-token decode with caches, for the decoder-only stack and the
whisper-style encoder-decoder.

    Decoder                 embed (tok, head), blocks, final_norm
      AttnBlock             norm1, attn, [norm1_post], norm2, mlp or moe,
                            [norm2_post]
      SSMBlock              norm1, ssm, ...
      RGLRUBlock            norm1, rglru, ...
    EncoderDecoder          embed (tok, pos_dec), enc, dec, enc_final,
                            dec_final
      EncLayer              norm1, attn, norm2, mlp
      DecLayer              norm1, self_attn, norm_x, cross_attn, norm2,
                            mlp

A plain loop over the layers takes the place of the reference's scan over
stacked periods; the cache is a list with one dict per layer, {"k", "v"}
(B, S_alloc, KV, hd) for attention and {"h", "conv"} for SSM and RG-LRU
blocks, and prefill and decode update it in place. A sliding-window
block's cache holds min(S_max, window) slots; when that is the window it
is a ring buffer, position p in slot p mod window.

Weight layout: as the reference, every projection is (in, out) and
applied as `x @ W`; `params_from_reference` loads a reference `init_params`
pytree (nested dicts of numpy arrays) without transposes, unstacking its
"scan" leaves (n_periods, ...), and an encoder-decoder's "enc" and "dec"
leaves (L, ...), into one module per layer.

The scoring forward is differentiable (`launch.train`); under grad each
block runs inside `torch.utils.checkpoint` when `cfg.remat` is set, the
counterpart of the reference's `jax.checkpoint` over the scanned periods.
`prefill` and `decode_step` run under `torch.inference_mode()` (under
`torch.no_grad()` with the sharding hooks installed: `serving`).

A block whose `spec.mlp` is "moe" holds `moe` (`layers.moe_forward`)
in place of `mlp`; in the scoring forward each block returns its
load-balance aux, summed over the layers, and the loss is
xent + 0.01 · aux, as the reference's (prefill and decode skip the
aux). An "embeddings" model (qwen2-vl) takes `batch["embeds"]`
in place of tokens; under M-RoPE positions are (3, B, S) streams, the
causal mask reads the temporal one, and a decode step writes one
position to all three.

The encoder-decoder takes precomputed frame embeddings (B, T, d), the
reference's stub of the conv front end. Its encoder attends both ways,
its decoder causally over at most MAX_WHISPER_DEC tokens and across to
per-layer K/V of the encoder output; GELU MLPs and no RoPE, whatever
`cfg.pattern`, `mrope_sections`, `input_mode` or `use_flash_attention`
say, as the reference's. Its cache is the reference's dict (see
`init_cache_encdec`). A decoder position past the context raises where
the reference's `dynamic_slice` clamps it (ROADMAP.md Queue 3).

The reference's sharding hooks are here: `set_shardings` and `constrain`
(the "act" and "logits" constraints), `set_param_gather` and `_gather`
(a block's FSDP just-in-time weight gather), called where the reference
calls them. Unset, each is a no-op. Set (`launch.train.
make_jitted_train_step`, `launch.serve.make_jitted_serve_fns`), the
weights, batch and caches are DTensors on a process mesh, `constrain`
redistributes to its sharding and `_gather` a block's weights to their
use-site specs; DTensor's op rules insert the collectives, and the
kernels and the attention cores run on each rank's local shards
(`shards.local_kernel`). Cache writes go through `shards.write_rows` /
`copy_into`, which keep a DTensor cache's placements. In a serving
step each block's mixer and MLP outputs are constrained to "act"
(their partial sums over "model" reduced there, the residual stream
whole in d): DTensor otherwise carries the partial sums into the next
block's products and runs them whole over "model". The MoE runs the
reference's expert parallelism when `layers.MOE_CTX["mesh"]` is set
(`launch.dryrun.moe_ctx_for` sets it as the reference's dry run does),
else the portable grouped dispatch under DTensor's rules.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.flash_attention import flash_attention
from . import layers as L
from .shards import (copy_into, decode_over_shards, is_dtensor,
                     local_kernel, merge_heads, placed, split_heads,
                     splits_slots, whole_dim, write_rows)
from . import rglru as R
from . import ssm as S
from .config import Block, ModelConfig

MAX_WHISPER_DEC = 448

# Optional sharding constraints installed by the launcher (launch/train.py,
# launch/serve.py). The model itself stays mesh-agnostic; when unset these
# are no-ops (one process).
_SHARDINGS = {"act": None, "logits": None}
_PARAM_GATHER = None


def set_shardings(**kw):
    """Install DTensor placements (`launch.sharding.placements`) by key
    ("act", "logits"); None removes one."""
    _SHARDINGS.update(kw)


def set_param_gather(fn):
    """Install a use-site weight resharding fn (FSDP just-in-time gather):
    {relative name: tensor} -> the same, redistributed; None disables. See
    launch/sharding.py::use_specs_fn."""
    global _PARAM_GATHER
    _PARAM_GATHER = fn


def serving(fn):
    """Run `fn` under `torch.inference_mode()`, or under `torch.no_grad()`
    while a sharding is installed: a view of a DTensor cannot be made in
    inference mode. Either way no graph is recorded."""
    @functools.wraps(fn)
    def run(*args, **kw):
        sharded = any(v is not None for v in _SHARDINGS.values())
        with torch.no_grad() if sharded else torch.inference_mode():
            return fn(*args, **kw)
    return run


def _gather(weights: Dict[str, torch.Tensor]):
    return _PARAM_GATHER(weights) if _PARAM_GATHER is not None else weights


class _Weights(dict):
    """A weight group's gathered tensors by attribute, as `L.Params`."""
    __getattr__ = dict.__getitem__


def _gathered(module: nn.Module):
    """`module` itself, or its weights after the installed gather."""
    if _PARAM_GATHER is None:
        return module
    return _Weights(_gather(dict(module.named_parameters())))


def constrain(x, key):
    """Redistribute a DTensor to the installed sharding `key` (a command,
    not the reference's hint); a plain tensor is the same on every rank and
    stays as it is. A mesh dim that would split a dim it does not divide
    (serve_long's sequence over "data" at a decode step's one token)
    replicates it instead, as the specs' rules do (`launch.sharding.
    _maybe`): uneven shards make DTensor reshuffle every product."""
    placements = _SHARDINGS.get(key)
    if placements is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    return placed(x, [Replicate() if isinstance(pl, Shard)
                      and x.shape[pl.dim] % mesh.size(i) else pl
                      for i, pl in enumerate(placements)])


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------

def _block_dff(cfg: ModelConfig, spec: Block) -> int:
    return spec.d_ff if spec.d_ff is not None else cfg.d_ff


def _rope_base_for(cfg: ModelConfig, spec: Block):
    if spec.window is None and cfg.rope_base_global is not None:
        return cfg.rope_base_global
    return cfg.rope_base


def _attend(fn, q, k, v, *rest, **kw):
    """An attention core (`layers.chunked_attention`, `decode_attention`,
    `decode_attention_ring`) on this rank's batch rows and heads: local
    under the specs (KV heads over "model"), so DTensors are handed over
    as local shards (`local_kernel`); `rest` holds the mask positions
    (B, S) when there are any."""
    return local_kernel(fn, (q, k, v) + rest, (True,) * (3 + len(rest)),
                        (2, 2, 2) + (None,) * len(rest), **kw)


class _Block(nn.Module):
    """Pre-norm residual block: mixer (a subclass's `mix`) then the MLP or
    the MoE."""

    def __init__(self, gen, cfg: ModelConfig, spec: Block, dtype):
        super().__init__()
        self.spec = spec
        dev = L.init_device(gen)
        self.norm1 = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        if cfg.post_norms:
            self.norm1_post = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        if spec.mlp is not None:
            self.norm2 = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
            if spec.mlp == "moe":
                self.moe = L.init_moe(gen, cfg, _block_dff(cfg, spec),
                                      dtype)
            else:
                self.mlp = L.init_mlp(gen, cfg.d_model,
                                      _block_dff(cfg, spec), spec.mlp, dtype)
            if cfg.post_norms:
                self.norm2_post = L.init_norm(cfg.d_model, cfg.norm, dtype,
                                              dev)

    def mix(self, h, cfg, ctx, cache):
        raise NotImplementedError

    def forward(self, x, cfg: ModelConfig, ctx, cache=None):
        """Returns (x, cache, moe_aux); moe_aux is None without an MoE or
        without ctx["aux"]. ctx keys: positions, pos (decode write index),
        decode (bool), aux (bool: compute the MoE aux)."""
        aux = None
        h = L.apply_norm(self.norm1, x, cfg.norm)
        o, cache = self.mix(h, cfg, ctx, cache)
        if cache is not None:   # a serving step's partial sums reduced
            o = constrain(o, "act")
        if cfg.post_norms:
            o = L.apply_norm(self.norm1_post, o, cfg.norm)
        x = x + o
        if self.spec.mlp is not None:
            h2 = L.apply_norm(self.norm2, x, cfg.norm)
            if self.spec.mlp == "moe":
                o2, aux = L.moe_forward(self.moe, h2, cfg,
                                        _block_dff(cfg, self.spec),
                                        aux=ctx["aux"])
            else:
                o2 = L.mlp_forward(self.mlp, h2, self.spec.mlp)
            if cache is not None:
                o2 = constrain(o2, "act")
            if cfg.post_norms:
                o2 = L.apply_norm(self.norm2_post, o2, cfg.norm)
            x = x + o2
        return x, cache, aux


def ring_slot(pos: int, window: int) -> int:
    """The slot of a ring of `window` slots that position `pos` goes to."""
    return pos % window


class AttnBlock(_Block):
    def __init__(self, gen, cfg, spec, dtype):
        super().__init__(gen, cfg, spec, dtype)
        self.attn = L.init_attn(gen, cfg, dtype)

    def mix(self, h, cfg, ctx, cache):
        W = self.spec.window
        q, k, v = L.attn_qkv(self.attn, h, cfg, ctx["positions"],
                             _rope_base_for(cfg, self.spec))
        # a windowed block's cache of `window` slots is a ring
        ring = (W is not None and cache is not None
                and cache["k"].shape[1] == W)
        if ctx["decode"]:
            pos = ctx["pos"]
            # the reference's dynamic_update_slice clamps the write index
            wpos = ring_slot(pos, W) if ring else min(
                max(pos, 0), cache["k"].shape[1] - 1)
            write_rows(cache["k"], k, wpos)
            write_rows(cache["v"], v, wpos)
            if splits_slots(cache["k"]):
                S_c = cache["k"].shape[1]
                o = decode_over_shards(
                    q, cache["k"], cache["v"],
                    functools.partial(L.decode_valid, pos, length=S_c,
                                      window=W, ring=ring),
                    softcap=cfg.attn_softcap)
            elif ring:
                o = _attend(L.decode_attention_ring, q, cache["k"],
                            cache["v"], pos=pos, window=W,
                            softcap=cfg.attn_softcap)
            else:
                o = _attend(L.decode_attention, q, cache["k"], cache["v"],
                            pos=pos, window=W, softcap=cfg.attn_softcap)
        else:
            # M-RoPE's (3, B, S) positions never reach the kernel; the
            # mask reads their temporal stream
            positions = ctx["positions"]
            if (cfg.use_flash_attention and W is None
                    and positions.dim() == 2):
                o = local_kernel(flash_attention, (q, k, v),
                                 (True,) * 3, (2, 2, 2),
                                 softcap=cfg.attn_softcap)
            else:
                mask_pos = positions[0] if positions.dim() == 3 else positions
                o = _attend(L.chunked_attention, q, k, v, mask_pos,
                            window=W, softcap=cfg.attn_softcap,
                            q_chunk=cfg.q_chunk)
            if cache is not None:      # prefill: write into the cache
                S_in = k.shape[1]
                if ring and S_in >= W:
                    # the last W tokens, rolled so token p lands in slot
                    # p mod W; copied into the cache's own tensors (a
                    # slot's view in the serving engine)
                    shift = (S_in - W) % W
                    copy_into(cache["k"],
                              torch.roll(k[:, S_in - W:], shift, 1))
                    copy_into(cache["v"],
                              torch.roll(v[:, S_in - W:], shift, 1))
                else:
                    write_rows(cache["k"], k, 0)
                    write_rows(cache["v"], v, 0)
        o = merge_heads(o, cfg.n_heads) @ self.attn.wo
        return o, cache


class SSMBlock(_Block):
    def __init__(self, gen, cfg, spec, dtype):
        super().__init__(gen, cfg, spec, dtype)
        self.ssm = S.init_ssm(gen, cfg, dtype)

    def mix(self, h, cfg, ctx, cache):
        return S.ssm_forward(self.ssm, h, cfg, cache)[0], cache


class RGLRUBlock(_Block):
    def __init__(self, gen, cfg, spec, dtype):
        super().__init__(gen, cfg, spec, dtype)
        self.rglru = R.init_rglru(gen, cfg, dtype)

    def mix(self, h, cfg, ctx, cache):
        return R.rglru_forward(self.rglru, h, cfg, cache)[0], cache


_BLOCKS = {"attn": AttnBlock, "ssm": SSMBlock, "rglru": RGLRUBlock}


def init_block(gen, cfg: ModelConfig, spec: Block, dtype):
    return _BLOCKS[spec.mixer](gen, cfg, spec, dtype)


def init_block_cache(cfg: ModelConfig, spec: Block, B: int, S_max: int,
                     dtype, device):
    if spec.mixer == "attn":
        # a sliding-window block keeps a ring of `window` slots: O(W)
        # memory whatever the context length
        S_alloc = min(S_max, spec.window) if spec.window else S_max
        shp = (B, S_alloc, cfg.n_kv, cfg.head_dim)
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}
    if spec.mixer == "rglru":
        return R.init_rglru_cache(cfg, B, dtype, device)
    return S.init_ssm_cache(cfg, B, dtype, device)


# ----------------------------------------------------------------------------
# the decoder
# ----------------------------------------------------------------------------

def _split_layers(cfg: ModelConfig) -> Tuple[int, int]:
    P = len(cfg.pattern)
    return cfg.n_layers // P, cfg.n_layers % P


def _generator(seed: int, device):
    """(device, a torch.Generator seeded with `seed` on it); no generator
    on "meta", where an init gives shapes only."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    return dev, gen


class Model(nn.Module):
    """Either LM structure: `Decoder` or `EncoderDecoder`."""

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def forward(self, batch):
        """`forward_train(self, batch)`: (loss, metrics). Lets
        `torch.func.functional_call` score the model under other weights
        (`optim.localdp.decoder_loss_fn`)."""
        return forward_train(self, batch)


class Decoder(Model):
    """The decoder-only stack. Weights are drawn from a `torch.Generator`
    seeded with `seed` on `device`; `device="meta"` gives shapes only."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev, gen = _generator(seed, device)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = L.init_embed(gen, cfg, dtype)
        self.blocks = nn.ModuleList(init_block(gen, cfg, spec, dtype)
                                    for spec in cfg.blocks())
        self.final_norm = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=DEFAULT_DEVICE):
    """A `Decoder`, or an `EncoderDecoder` when `cfg.is_encdec()`, with
    random weights drawn from `seed` (the port's own draws;
    `params_from_reference` carries the reference's)."""
    kind = EncoderDecoder if cfg.is_encdec() else Decoder
    return kind(cfg, seed=seed, device=device)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameters; `active_only` counts top_k experts of each MoE
    block in place of all E (at `cfg.d_ff`, as the reference does)."""
    total = sum(p.numel()
                for p in init_params(cfg, device="meta").parameters())
    if active_only and cfg.n_experts > 1:
        n_moe = sum(1 for b in cfg.blocks() if b.mlp == "moe")
        total -= (n_moe * (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model
                  * cfg.d_ff)
    return total


def init_cache(cfg: ModelConfig, B: int, S_max: int, device=DEFAULT_DEVICE):
    """The decoder's cache, one dict a layer; for an encoder-decoder
    `init_cache_encdec(cfg, B, S_max)`, S_max the frame count."""
    if cfg.is_encdec():
        return init_cache_encdec(cfg, B, S_max, device)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    return [init_block_cache(cfg, spec, B, S_max, dtype, dev)
            for spec in cfg.blocks()]


def _flatten(tree, prefix: str) -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name))
        else:
            out[name] = value
    return out


def reference_state(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The leaves of a reference `init_params(rng, cfg)` pytree (or any
    tree of its structure: grads, AdamW moments) under the port's
    `state_dict` names. Stacked leaves are unstacked: leaf k of period i
    in "scan" (shape (n_periods, ...)) is layer i * len(pattern) + k, and
    "rest" follows the periods; an encoder-decoder's "enc" and "dec"
    leaves (L, ...) are one layer each."""
    flat: Dict[str, Any] = {}

    def unstack(tree, n, name_of):
        for name, arr in _flatten(tree, "").items():
            for i in range(n):
                flat[f"{name_of(i)}{name}"] = arr[i]

    if cfg.is_encdec():
        for key in ("embed", "enc_final", "dec_final"):
            flat.update(_flatten(params[key], key))
        unstack(params["enc"], cfg.enc_layers, lambda i: f"enc.{i}")
        unstack(params["dec"], cfg.dec_layers, lambda i: f"dec.{i}")
        return flat
    n_full, _ = _split_layers(cfg)
    P = len(cfg.pattern)
    flat.update(_flatten(params["embed"], "embed"))
    flat.update(_flatten(params["final_norm"], "final_norm"))
    if n_full > 0:
        for j, period in enumerate(params["scan"]):
            unstack(period, n_full, lambda i: f"blocks.{i * P + j}")
    for i, blk in enumerate(params["rest"]):
        flat.update(_flatten(blk, f"blocks.{n_full * P + i}"))
    return flat


def params_from_reference(params, cfg: ModelConfig, device=DEFAULT_DEVICE):
    """A model (`init_params`' kind) holding the reference's
    `init_params(rng, cfg)` weights.

    `params` is that pytree as nested dicts (lists or tuples for "scan" and
    "rest") of numpy arrays; bfloat16 leaves may come as float32 and are
    cast back. `reference_state` names the leaves."""
    model = init_params(cfg, device=device)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in reference_state(params, cfg).items()}
    model.load_state_dict(state, strict=True)
    return model


def _embed_inputs(model: Decoder, batch, cfg: ModelConfig):
    if cfg.input_mode == "embeddings":
        x = batch["embeds"].to(getattr(torch, cfg.dtype))
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        return x
    return L.embed_tokens(_gathered(model.embed), batch["tokens"].long(),
                          cfg)


def _positions(cfg, batch, B, Sq, device):
    """A batch's own positions, else 0..Sq-1 for every row: (B, Sq), or
    (len(mrope_sections), B, Sq) under M-RoPE."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(Sq, dtype=torch.int32, device=device).expand(B, Sq)
    if cfg.mrope_sections is not None:
        pos = pos.expand(len(cfg.mrope_sections), B, Sq)
    return pos


# remat_policy "dots": keep the outputs of the matmuls without batch
# dimensions, recompute the rest (the counterpart of jax's
# dots_with_no_batch_dims_saveable). Under grad `x @ W` folds to mm; the
# attention's and the scan's einsums carry batch dimensions and lower to
# bmm, which is recomputed, so no (B, KV, G, C, T) score is kept.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(module, *args, policy: str = "nothing"):
    """`module(*args)` under `torch.utils.checkpoint`. The module's
    weights are taken now and handed to the recompute, so a backward
    under `torch.func.functional_call` recomputes with the weights the
    forward used, not the module's own. The installed FSDP gather runs
    inside, so the backward gathers again and keeps no gathered copy."""
    weights = dict(module.named_parameters())

    def run(weights, *args):
        return torch.func.functional_call(module, _gather(weights), args)

    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _dots_saveable)
               if policy == "dots" else noop_context_fn)
    return checkpoint(run, weights, *args, use_reentrant=False,
                      context_fn=context)


def _run_stack(model: Decoder, x, cfg, ctx, cache: Optional[List] = None):
    """All layers, then the final norm. Returns (x, cache, the MoE aux
    summed over the layers, or None when no block gave one). Under grad
    and `cfg.remat` (no cache), each block is rematerialized in the
    backward."""
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux_total = None
    for i, block in enumerate(model.blocks):
        if remat:
            x, _, aux = _remat(block, x, cfg, ctx, None,
                               policy=cfg.remat_policy)
        elif _PARAM_GATHER is not None:     # FSDP just-in-time gather
            x, _, aux = torch.func.functional_call(
                block, _gather(dict(block.named_parameters())),
                (x, cfg, ctx, None if cache is None else cache[i]))
        else:
            x, _, aux = block(x, cfg, ctx,
                              None if cache is None else cache[i])
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return L.apply_norm(model.final_norm, x, cfg.norm), cache, aux_total


def chunked_xent(model: Decoder, x, labels, mask, cfg):
    """Cross-entropy over sequence chunks, never holding (B, S, V)."""
    B, Sq, d = x.shape
    C = L.pick_chunk(Sq, cfg.loss_chunk)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, Sq, C):
        logits = constrain(L.lm_logits(_gathered(model.embed),
                                       x[:, c0:c0 + C], cfg), "logits")
        logz = torch.logsumexp(logits, dim=-1)
        ys = labels[:, c0:c0 + C].long()
        gold = torch.gather(whole_dim(logits, -1), -1, ys[..., None])[..., 0]
        ms = mask[:, c0:c0 + C]
        tot = tot + torch.sum((logz - gold) * ms)
        cnt = cnt + torch.sum(ms)
    return tot / torch.clamp_min(cnt, 1.0)


def forward_train(model: Model, batch, cfg: Optional[ModelConfig] = None):
    """The training and scoring forward. batch: tokens (or embeds, and
    positions under M-RoPE) + labels (+ loss_mask) tensors on the model's
    device; an encoder-decoder's (`forward_train_encdec`): frames, tokens,
    labels (+ loss_mask). Returns (xent + 0.01 · moe_aux, {"xent",
    "moe_aux"}); differentiable in the weights (`loss.backward()`,
    `launch.train`). Score under `torch.no_grad()`: the flash and scan
    kernels have no backward and refuse inputs that require grad."""
    cfg = cfg or model.cfg
    if cfg.is_encdec():
        return forward_train_encdec(model, batch, cfg)
    x = constrain(_embed_inputs(model, batch, cfg), "act")
    B, Sq = x.shape[:2]
    ctx = {"positions": _positions(cfg, batch, B, Sq, x.device), "pos": None,
           "decode": False, "aux": True}
    x, _, aux = _run_stack(model, x, cfg, ctx)
    x = constrain(x, "act")
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss = chunked_xent(model, x, labels, mask, cfg)
    return loss + 0.01 * aux, {"xent": loss, "moe_aux": aux}


@serving
def prefill(model: Decoder, batch, cache, cfg: Optional[ModelConfig] = None):
    """Fill the cache (in place) with a prompt; returns (last_logits,
    cache)."""
    cfg = cfg or model.cfg
    x = _embed_inputs(model, batch, cfg)
    B, Sq = x.shape[:2]
    ctx = {"positions": _positions(cfg, batch, B, Sq, x.device), "pos": 0,
           "decode": False, "aux": False}
    x, cache, _ = _run_stack(model, x, cfg, ctx, cache)
    return L.lm_logits(model.embed, x[:, -1:], cfg), cache


@serving
def decode_step(model: Model, cache, tokens, pos: int,
                cfg: Optional[ModelConfig] = None):
    """One decode step. tokens: (B,1) int; pos: int (write index, also the
    attended-up-to position; under M-RoPE the position of all three
    streams). Returns (logits (B,1,V), cache). An encoder-decoder's is
    `decode_step_encdec`."""
    cfg = cfg or model.cfg
    if cfg.is_encdec():
        return decode_step_encdec(model, cache, tokens, pos, cfg)
    x = L.embed_tokens(model.embed, tokens.long(), cfg)
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        posv = posv.expand(len(cfg.mrope_sections), B, 1)
    ctx = {"positions": posv, "pos": int(pos), "decode": True, "aux": False}
    x, cache, _ = _run_stack(model, x, cfg, ctx, cache)
    return L.lm_logits(model.embed, x, cfg), cache


# ----------------------------------------------------------------------------
# whisper-style encoder-decoder
# ----------------------------------------------------------------------------

def _enc_attention(p, x, cfg, positions):
    q, k, v = L.attn_qkv(p.attn, L.apply_norm(p.norm1, x, cfg.norm), cfg,
                         positions, None)
    o = _attend(L.chunked_attention, q, k, v, positions, causal=False,
                q_chunk=cfg.q_chunk)
    return x + merge_heads(o, cfg.n_heads) @ p.attn.wo


class EncLayer(nn.Module):
    """An encoder layer: bidirectional self-attention, then the GELU
    MLP."""

    def __init__(self, gen, cfg: ModelConfig, dtype):
        super().__init__()
        dev = L.init_device(gen)
        self.norm1 = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        self.attn = L.init_attn(gen, cfg, dtype)
        self.norm2 = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dtype)

    def forward(self, x, cfg: ModelConfig, positions):
        x = _enc_attention(self, x, cfg, positions)
        h = L.apply_norm(self.norm2, x, cfg.norm)
        return x + L.mlp_forward(self.mlp, h, "gelu")


def _dec_block(cfg, p, x, enc_kv, ctx, cache=None):
    """A decoder layer on x (B, Sq, d): causal self-attention (a decode
    step writes its K/V into `cache`, this layer's {"k", "v"}, in place),
    cross attention over `enc_kv` (its (B, T, KV, hd) K and V), the GELU
    MLP. Returns (x, cache)."""
    Sq = x.shape[1]
    h = L.apply_norm(p.norm1, x, cfg.norm)
    q, k, v = L.attn_qkv(p.self_attn, h, cfg, ctx["positions"], None)
    if ctx["decode"]:
        pos = ctx["pos"]
        write_rows(cache["k"], k, pos)
        write_rows(cache["v"], v, pos)
        o = _attend(L.decode_attention, q, cache["k"], cache["v"], pos=pos)
    else:
        o = _attend(L.chunked_attention, q, k, v, ctx["positions"],
                    q_chunk=min(cfg.q_chunk, Sq))
    x = x + merge_heads(o, cfg.n_heads) @ p.self_attn.wo
    # cross attention over the precomputed encoder K/V
    hx = L.apply_norm(p.norm_x, x, cfg.norm)
    qx = split_heads(hx @ p.cross_attn.wq, cfg.n_heads, cfg.head_dim)
    ek, ev = enc_kv
    if Sq == 1:
        o = _attend(L.decode_attention, qx, ek, ev, pos=ek.shape[1] - 1)
    else:
        o = _attend(L.chunked_attention, qx, ek, ev, ctx["positions"],
                    causal=False, q_chunk=min(cfg.q_chunk, Sq))
    x = x + merge_heads(o, cfg.n_heads) @ p.cross_attn.wo
    h2 = L.apply_norm(p.norm2, x, cfg.norm)
    return x + L.mlp_forward(p.mlp, h2, "gelu"), cache


class DecLayer(nn.Module):
    """A decoder layer (`_dec_block`)."""

    def __init__(self, gen, cfg: ModelConfig, dtype):
        super().__init__()
        dev = L.init_device(gen)
        self.norm1 = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        self.self_attn = L.init_attn(gen, cfg, dtype)
        self.norm_x = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        self.cross_attn = L.init_attn(gen, cfg, dtype)
        self.norm2 = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dtype)

    def forward(self, x, cfg: ModelConfig, ek, ev, ctx, cache=None):
        return _dec_block(cfg, self, x, (ek, ev), ctx, cache)


class EncoderDecoder(Model):
    """The whisper-style encoder-decoder: cfg.enc_layers encoder and
    cfg.dec_layers decoder layers. Weights are drawn from a
    `torch.Generator` seeded with `seed` on `device`; `device="meta"`
    gives shapes only."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev, gen = _generator(seed, device)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = L.Params(
            tok=L.dense_init(gen, (cfg.vocab, cfg.d_model), dtype,
                             scale=0.02),
            pos_dec=L.dense_init(gen, (MAX_WHISPER_DEC, cfg.d_model), dtype,
                                 scale=0.02))
        self.enc = nn.ModuleList(EncLayer(gen, cfg, dtype)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecLayer(gen, cfg, dtype)
                                 for _ in range(cfg.dec_layers))
        self.enc_final = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        self.dec_final = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)


def _sinusoid(S, d, dtype, device):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    ang = pos / (10000.0 ** (dim / d))
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]
    return pe.to(dtype)


def encode(model: EncoderDecoder, frames, cfg: Optional[ModelConfig] = None):
    """The encoder over frames (B, T, d), the conv front end's output
    (a stub: precomputed embeddings). Under grad and `cfg.remat` each
    layer is rematerialized in the backward."""
    cfg = cfg or model.cfg
    B, T, d = frames.shape
    dtype = getattr(torch, cfg.dtype)
    x = frames.to(dtype) + _sinusoid(T, d, dtype, frames.device)
    positions = torch.arange(T, dtype=torch.int32,
                             device=frames.device).expand(B, T)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.enc:
        x = (_remat(layer, x, cfg, positions) if remat
             else layer(x, cfg, positions))
    return L.apply_norm(model.enc_final, x, cfg.norm)


def _enc_kv_all(model: EncoderDecoder, enc_out, cfg):
    """Every decoder layer's cross K/V of the encoder output: two
    (L, B, T, KV, hd) tensors."""
    ks = [split_heads(enc_out @ layer.cross_attn.wk, cfg.n_kv, cfg.head_dim)
          for layer in model.dec]
    vs = [split_heads(enc_out @ layer.cross_attn.wv, cfg.n_kv, cfg.head_dim)
          for layer in model.dec]
    return torch.stack(ks), torch.stack(vs)


def logits_encdec(model: EncoderDecoder, batch,
                  cfg: Optional[ModelConfig] = None):
    """The decoder's float32 logits (B, Sd, V) over all of batch["tokens"]
    (B, Sd), teacher-forced, with the encoder over batch["frames"]: the
    cache-free counterpart of `prefill_encdec` then Sd decode steps.
    Raises ValueError past MAX_WHISPER_DEC tokens."""
    cfg = cfg or model.cfg
    toks = batch["tokens"].long()
    B, Sd = toks.shape
    if Sd > MAX_WHISPER_DEC:
        raise ValueError(f"{Sd} decoder tokens: the decoder's context is "
                         f"{MAX_WHISPER_DEC}")
    ek, ev = _enc_kv_all(model, encode(model, batch["frames"], cfg), cfg)
    x = L.embed_rows(model.embed.tok, toks) + model.embed.pos_dec[:Sd]
    ctx = {"positions": torch.arange(Sd, dtype=torch.int32,
                                     device=x.device).expand(B, Sd),
           "pos": None, "decode": False}
    remat = cfg.remat and torch.is_grad_enabled()
    for i, layer in enumerate(model.dec):
        x, _ = (_remat(layer, x, cfg, ek[i], ev[i], ctx) if remat
                else layer(x, cfg, ek[i], ev[i], ctx))
    x = L.apply_norm(model.dec_final, x, cfg.norm)
    return constrain((x @ model.embed.tok.T.to(x.dtype)).float(), "logits")


def forward_train_encdec(model: EncoderDecoder, batch,
                         cfg: Optional[ModelConfig] = None):
    """The encoder-decoder's training and scoring forward. batch: frames
    (B, T, d), tokens and labels (B, Sd), Sd <= MAX_WHISPER_DEC (+
    loss_mask). The cross-entropy over the whole (B, Sd, V), unchunked,
    as the reference's; returns (loss, {"xent": loss, "moe_aux": 0})."""
    cfg = cfg or model.cfg
    logits = logits_encdec(model, batch, cfg)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(whole_dim(logits, -1), -1, labels[..., None])[..., 0]
    loss = torch.sum((logz - gold) * mask) / torch.clamp_min(
        torch.sum(mask), 1.0)
    return loss, {"xent": loss,
                  "moe_aux": torch.zeros((), dtype=torch.float32,
                                         device=loss.device)}


def init_cache_encdec(cfg: ModelConfig, B: int, T_enc: int,
                      device=DEFAULT_DEVICE):
    """The reference's cache: {"self": {"k", "v"} (L, B, MAX_WHISPER_DEC,
    KV, hd), "cross": {"k", "v"} (L, B, T_enc, KV, hd)}, zeros."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    shp = (cfg.dec_layers, B, MAX_WHISPER_DEC, cfg.n_kv, cfg.head_dim)
    xshp = (cfg.dec_layers, B, T_enc, cfg.n_kv, cfg.head_dim)

    def zeros(shape):
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return {"self": zeros(shp), "cross": zeros(xshp)}


@serving
def prefill_encdec(model: EncoderDecoder, batch, cache,
                   cfg: Optional[ModelConfig] = None):
    """The encoder over batch["frames"] (B, T, d); `cache["cross"]` is
    replaced by their cross K/V (whatever T the cache was made for), the
    self cache kept. Returns the cache."""
    cfg = cfg or model.cfg
    ek, ev = _enc_kv_all(model, encode(model, batch["frames"], cfg), cfg)
    cache["cross"] = {"k": ek, "v": ev}
    return cache


@serving
def decode_step_encdec(model: EncoderDecoder, cache, tokens, pos: int,
                       cfg: Optional[ModelConfig] = None):
    """One decoder step. tokens: (B, 1) int; pos: int, the write index and
    the last attended position, 0 <= pos < MAX_WHISPER_DEC (ValueError
    otherwise: the reference clamps it). The self cache is written in
    place. Returns (float32 logits (B, 1, V), cache)."""
    cfg = cfg or model.cfg
    pos = int(pos)
    if not 0 <= pos < MAX_WHISPER_DEC:
        raise ValueError(f"decoder position {pos} is outside the decoder's "
                         f"context, 0..{MAX_WHISPER_DEC - 1}")
    x = (L.embed_rows(model.embed.tok, tokens.long())
         + model.embed.pos_dec[pos:pos + 1])
    B = x.shape[0]
    ctx = {"positions": torch.full((B, 1), pos, dtype=torch.int32,
                                   device=x.device),
           "pos": pos, "decode": True}
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    for i, layer in enumerate(model.dec):
        x, _ = layer(x, cfg, ck[i], cv[i], ctx, {"k": sk[i], "v": sv[i]})
    x = L.apply_norm(model.dec_final, x, cfg.norm)
    return (x @ model.embed.tok.T.to(x.dtype)).float(), cache
