"""RG-LRU recurrent block (Griffin / recurrentgemma-9b family;
`repro.models.rglru` counterpart).

Recurrent block:  x -> { branch_y: gelu(W_y x) ;
                         branch_x: W_x x -> causal conv1d -> RG-LRU }
                  out = W_o (branch_x * branch_y)

RG-LRU:  r_t = sigmoid(W_a u_t + b_a)          (recurrence gate)
         i_t = sigmoid(W_i u_t + b_i)          (input gate)
         a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The recurrence runs as `models.ssm`'s chunked scan (a loop over sequence
chunks carrying h, an associative scan inside a chunk), with N = 1. The
gates' biases and Lambda stay float32 in a bf16 model. Lambda's leaf is
named `lambda`, as the reference's, so the state_dict keys are the
reference's paths; reach it with `getattr(p, "lambda")`.

Caches are updated in place: `rglru_forward` with a state writes the new
h and conv tail into the state's tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params, dense_init, init_device, pick_chunk
from .shards import copy_into, reduced
from .ssm import _causal_conv, _scan_chunk

_C_RGLRU = 8.0


def init_rglru(gen, cfg, dtype):
    d, L, W = cfg.d_model, cfg.lru_width, cfg.conv_width
    dev = init_device(gen)
    # Lambda init so a in [0.9, 0.999] at r=1 (griffin appendix)
    u = torch.empty((L,), dtype=torch.float32, device=dev)
    u = u.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * _C_RGLRU)))
    f32 = dict(dtype=torch.float32, device=dev)
    return Params(**{
        "w_x": dense_init(gen, (d, L), dtype),
        "w_y": dense_init(gen, (d, L), dtype),
        "conv_w": dense_init(gen, (W, L), dtype, scale=1.0 / math.sqrt(W)),
        "conv_b": torch.zeros((L,), dtype=dtype, device=dev),
        "w_a": dense_init(gen, (L, L), dtype),
        "b_a": torch.zeros((L,), **f32),
        "w_i": dense_init(gen, (L, L), dtype),
        "b_i": torch.zeros((L,), **f32),
        "lambda": lam,
        "w_o": dense_init(gen, (L, d), dtype),
    })


def rglru_forward(p, x, cfg, state=None):
    """x: (B,S,d). state: None (scoring) or {"h": (B,L) f32,
    "conv": (B,W-1,L)} (prefill / decode), updated in place. Returns
    (y, new_state)."""
    B, S, d = x.shape
    # jax.nn.gelu defaults to the tanh approximation
    y_branch = F.gelu(x @ p.w_y, approximate="tanh")
    # partial sums over a sharded d_model reduced here, where DTensor
    # would carry them into the conv and gather w_a, w_i and w_o
    u = reduced(x @ p.w_x)
    conv_state = state["conv"] if state is not None else None
    u, new_conv = _causal_conv(u, p.conv_w, p.conv_b, conv_state)

    r = torch.sigmoid((u @ p.w_a).float() + p.b_a)
    i = torch.sigmoid((u @ p.w_i).float() + p.b_i)
    a = torch.exp(-_C_RGLRU * F.softplus(getattr(p, "lambda")) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * u.float()

    h = (state["h"] if state is not None
         else torch.zeros((B, cfg.lru_width), dtype=torch.float32,
                          device=x.device))
    C = pick_chunk(S, cfg.seq_chunk)
    hs = []
    for c0 in range(0, S, C):
        ac, bc = a[:, c0:c0 + C, :, None], gated[:, c0:c0 + C, :, None]
        hc, hl = _scan_chunk(h[:, :, None], ac, bc)
        hs.append(hc[..., 0])
        h = hl[:, :, 0]
    out = (torch.cat(hs, dim=1).to(x.dtype) * y_branch) @ p.w_o
    if state is None:
        return out, {"h": h, "conv": new_conv}
    copy_into(state["h"], h)
    copy_into(state["conv"], new_conv)
    return out, state


def init_rglru_cache(cfg, B, dtype, device):
    return {"h": torch.zeros((B, cfg.lru_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((B, cfg.conv_width - 1, cfg.lru_width),
                                dtype=dtype, device=device)}
