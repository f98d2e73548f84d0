"""Serving steps (`repro.launch.serve` counterpart): prefill (fills the
KV/state caches in place; an encoder-decoder's encodes the frames into
the cross cache) and the greedy decode step, both under
`torch.inference_mode()` (`models.model.serving`): the weights are
trainable, serving records no graph. `make_jitted_serve_fns` runs them
on a process mesh."""
from __future__ import annotations

import torch

from ..models import model as M


@M.serving
def prefill_step(model, batch, cache, *, cfg=None):
    """Fill `cache` with the prompt; (last-position logits, cache). An
    encoder-decoder's batch is {"frames": (B, T, d)}: the encoder runs
    and the logits are zeros (B, 1, V), the decoder's first token (BOS)
    comes next."""
    cfg = cfg or model.cfg
    if cfg.is_encdec():
        cache = M.prefill_encdec(model, batch, cache, cfg)
        frames = batch["frames"]
        logits = torch.zeros((frames.shape[0], 1, cfg.vocab),
                             dtype=torch.float32, device=frames.device)
        return logits, cache
    return M.prefill(model, batch, cache, cfg)


@M.serving
def serve_step(model, cache, tokens, pos, *, cfg=None):
    """tokens: (B,1) int, pos: int. Greedy next token, (B,1) int32."""
    logits, cache = M.decode_step(model, cache, tokens, pos, cfg)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return nxt, cache


def make_jitted_serve_fns(cfg, mesh, mode: str = "serve"):
    """(jit_prefill(cache_shape, batch_shape), jit_decode(cache_shape)) on
    a process mesh (`launch.mesh.make_process_mesh`), mode "serve" or
    "serve_long": each returns a step that places its inputs by the specs
    (`launch.sharding`: the weights by `param_specs`, the batch and the
    tokens by `batch_specs`, the cache by `cache_specs`; whole tensors,
    the same on every rank, cut to this rank's slices) and returns the
    cache so placed. prefill(model, batch, cache) -> (whole logits,
    cache) with the FSDP gather installed; decode(model, cache, tokens,
    pos) -> (whole next tokens (B, 1), cache), the weights kept 2-D
    sharded. No jit: each op is a DTensor op, eagerly."""
    from . import sharding as Sh
    from .specs import abstract_params

    pspecs = Sh.param_specs(abstract_params(cfg), cfg, mesh, mode)
    layout = Sh.layout_for(mesh, mode)

    def _cache(cache_shape):
        return Sh.cache_specs(cache_shape, cfg, mesh, mode)

    def jit_prefill(cache_shape, batch_shape):
        cspecs = _cache(cache_shape)
        bspecs = Sh.batch_specs(batch_shape, cfg, mesh, mode)

        def prefill(model, batch, cache):
            Sh.place_model(model, pspecs, mesh, layout=layout)
            batch = Sh.place_tree(batch, bspecs, mesh, layout)
            cache = Sh.place_tree(cache, cspecs, mesh, layout)
            with Sh.installed(cfg, mesh, mode, gather=True):
                logits, cache = prefill_step(model, batch, cache, cfg=cfg)
                cache = Sh.place_tree(cache, cspecs, mesh, layout)
            return Sh.full(logits), cache
        return prefill

    def jit_decode(cache_shape):
        cspecs = _cache(cache_shape)

        def decode(model, cache, tokens, pos):
            Sh.place_model(model, pspecs, mesh, layout=layout)
            cache = Sh.place_tree(cache, cspecs, mesh, layout)
            tokens = Sh.place_tree(
                {"tokens": tokens},
                Sh.batch_specs({"tokens": tokens}, cfg, mesh, mode),
                mesh, layout)["tokens"]
            with Sh.installed(cfg, mesh, mode, gather=False):
                nxt, cache = serve_step(model, cache, tokens, pos, cfg=cfg)
                cache = Sh.place_tree(cache, cspecs, mesh, layout)
            return Sh.full(nxt), cache
        return decode

    return jit_prefill, jit_decode
