"""Serving steps (`repro.launch.serve` counterpart): prefill (fills the
KV/state caches in place) and the greedy decode step, both under
`torch.inference_mode()`: the weights are trainable, serving records no
graph."""
from __future__ import annotations

import torch

from ..models import model as M


@torch.inference_mode()
def prefill_step(model, batch, cache, *, cfg=None):
    """Fill `cache` with the prompt; (last-position logits, cache)."""
    return M.prefill(model, batch, cache, cfg)


@torch.inference_mode()
def serve_step(model, cache, tokens, pos, *, cfg=None):
    """tokens: (B,1) int, pos: int. Greedy next token, (B,1) int32."""
    logits, cache = M.decode_step(model, cache, tokens, pos, cfg)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return nxt, cache
