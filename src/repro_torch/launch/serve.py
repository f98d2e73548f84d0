"""Serving steps (`repro.launch.serve` counterpart): prefill (fills the
KV/state caches in place; an encoder-decoder's encodes the frames into
the cross cache) and the greedy decode step, both under
`torch.inference_mode()`: the weights are trainable, serving records no
graph."""
from __future__ import annotations

import torch

from ..models import model as M


@torch.inference_mode()
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


@torch.inference_mode()
def serve_step(model, cache, tokens, pos, *, cfg=None):
    """tokens: (B,1) int, pos: int. Greedy next token, (B,1) int32."""
    logits, cache = M.decode_step(model, cache, tokens, pos, cfg)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return nxt, cache
