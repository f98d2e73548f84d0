"""Mamba-1 selective SSM block (falcon-mamba-7b family;
`repro.models.ssm` counterpart).

Linear time-varying diagonal recurrence
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,   y_t = C_t . h_t + D x_t
run as a *chunked scan*: a loop over sequence chunks carrying h, and
inside a chunk an associative (Hillis-Steele) scan, log2(chunk) steps of
whole-chunk products. Live memory is (B, chunk, d_inner, N), not
(B, S, d_inner, N). Decode is the O(1) single step. Under
`cfg.use_fused_ssm`, the scoring forward (no state in, none carried out)
runs the fused kernel `kernels.ssm_scan` instead.

Caches are updated in place: `ssm_forward` with a state writes the new h
and conv tail into the state's tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssm_scan
from .layers import Params, dense_init, init_device, pick_chunk
from .shards import copy_into, local_kernel, reduced


def init_ssm(gen, cfg, dtype):
    d, di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.conv_width)
    dev = init_device(gen)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None, :]
    u = torch.rand((di,), generator=gen, device=dev, dtype=torch.float32)
    return Params(
        in_proj=dense_init(gen, (d, 2 * di), dtype),
        conv_w=dense_init(gen, (W, di), dtype, scale=1.0 / math.sqrt(W)),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        x_proj=dense_init(gen, (di, R + 2 * N), dtype),
        dt_proj=dense_init(gen, (R, di), dtype, scale=R ** -0.5),
        dt_bias=torch.log(torch.expm1(torch.clamp(u * 0.099 + 0.001,
                                                  min=1e-4))),
        A_log=torch.log(A.repeat(di, 1)),                   # (di, N) f32
        D=torch.ones((di,), dtype=torch.float32, device=dev),
        out_proj=dense_init(gen, (di, d), dtype))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,di), w: (W,di). state: (B,W-1,di) tail
    from the previous segment (decode) or None (zeros)."""
    B, S, di = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                       # (B, S+W-1, di)
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return out + b, new_state


def _ssm_params(p, xin, cfg):
    """Input-dependent dt, B, C from x. xin: (B,S,di)."""
    N, R = cfg.ssm_state, cfg.dt_rank
    proj = reduced(xin @ p.x_proj)                          # (B,S,R+2N)
    dt = F.softplus((proj[..., :R] @ p.dt_proj).float() + p.dt_bias)
    Bm = proj[..., R:R + N].float()                         # (B,S,N)
    Cm = proj[..., R + N:].float()                          # (B,S,N)
    return dt, Bm, Cm


def _scan_chunk(h0, a, b):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t via an inclusive
    associative scan over dim 1 (the reference's combine,
    (al, bl) . (ar, br) = (al ar, ar bl + br)). a,b: (B,C,di,N) f32;
    h0: (B,di,N). Returns (h (B,C,di,N), h[:, -1])."""
    C = a.shape[1]
    off = 1
    while off < C:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    h = a * h0[:, None] + b                                 # include carry
    return h, h[:, -1]


def ssm_forward(p, x, cfg, state=None):
    """x: (B,S,d). state: None (scoring) or {"h": (B,di,N) f32,
    "conv": (B,W-1,di)} (prefill / decode), updated in place. Returns
    (y, new_state)."""
    B, S, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    # partial sums over a sharded d_model reduced here, where DTensor
    # would carry them into the conv and gather the next products' weights
    xz = reduced(x @ p.in_proj)
    xin, z = torch.chunk(xz, 2, dim=-1)                     # (B,S,di) each
    conv_state = state["conv"] if state is not None else None
    xin, new_conv = _causal_conv(xin, p.conv_w, p.conv_b, conv_state)
    xin = F.silu(xin)
    dt, Bm, Cm = _ssm_params(p, xin, cfg)
    A = -torch.exp(p.A_log)                                 # (di,N)
    h0 = (state["h"] if state is not None
          else torch.zeros((B, di, N), dtype=torch.float32, device=x.device))

    if cfg.use_fused_ssm and state is None:
        if di % 128:
            raise ValueError("use_fused_ssm requires d_inner % 128 == 0")
        # each rank scans its batch rows and, over "model", its d_inner
        y = local_kernel(ssm_scan, (xin.float(), dt, Bm, Cm, A, p.D),
                         (True,) * 4 + (False,) * 2, (2, 2, None, None, 0, 0))
        y = y.to(x.dtype) * F.silu(z)
        return y @ p.out_proj, {"h": h0, "conv": new_conv}

    C = pick_chunk(S, cfg.seq_chunk)
    xin32 = xin.float()
    h = h0
    ys = []
    for c0 in range(0, S, C):
        dtc, Bc, Cc, xc = (t[:, c0:c0 + C] for t in (dt, Bm, Cm, xin32))
        a = torch.exp(dtc[..., None] * A)                   # (B,C,di,N)
        b = (dtc * xc)[..., None] * Bc[:, :, None, :]       # (B,C,di,N)
        hs, h = _scan_chunk(h, a, b)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cc))    # (B,C,di)
    y = torch.cat(ys, dim=1) + xin32 * p.D
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p.out_proj
    if state is None:
        return out, {"h": h, "conv": new_conv}
    copy_into(state["h"], h)
    copy_into(state["conv"], new_conv)
    return out, state


def init_ssm_cache(cfg, B, dtype, device):
    return {"h": torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv_width - 1, cfg.d_inner),
                                dtype=dtype, device=device)}
