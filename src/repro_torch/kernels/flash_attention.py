"""Causal GQA flash attention: the CUDA kernel `csrc/flash_attention.cu`
and its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/flash_attention.py::_flash_kernel`.
q (B, S, H, hd), k/v (B, S, KV, hd) with H % KV == 0, float32 or bfloat16;
returns (B, S, H, hd) in q's dtype. Scores are (q.k) / sqrt(hd); they and
the running (m, l, acc) are float32; p is cast to v's dtype before p.v, as
in the reference. The ragged tail is masked in place (keys at or past S),
not padded.

`flash_attention` launches the kernel for CUDA tensors and runs
`flash_attention_plain` for CPU tensors; there is no fallback between the
two. The kernel has two instances, picked by dtype: bfloat16 on tensor
cores (mma.sync, 16-byte aligned inputs), float32 on SIMT FMAs (tensor
cores would round float32 to TF32). `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q rows per block of both kernels; keys per tile of the plain version and
# of the kernels but the bf16 one at hd 256 (BQ, BK and kv_tile in the .cu)
TILE = 64
NEG = -1e30
PAD = 8                   # bf16 elements padding a row of the bf16 tiles

LAUNCHES = 0


def kv_tile(hd: int, dtype: torch.dtype) -> int:
    """Keys per K/V tile of the kernel instance: 64, but 32 for the
    bfloat16 instance at hd 256 (its registers would not hold more)."""
    return 32 if dtype == torch.bfloat16 and hd >= 256 else TILE


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the (hd, dtype) instance
    (`simt::smem_floats` and `tc::smem_bytes` in the .cu): float32 stages
    q, K, V and p as float32; bfloat16 holds the q tile and a two-stage
    ring of K and V tiles in bf16, rows padded by 16 bytes."""
    if dtype == torch.bfloat16:
        return 2 * (hd + PAD) * (TILE + 4 * kv_tile(hd, dtype))
    if dtype == torch.float32:
        return 4 * (2 * TILE * (hd + 1) + TILE * hd + TILE * (TILE + 1))
    raise ValueError(f"flash_attention takes {list(DTYPES)}, got {dtype}")


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, S, H, hd) and k, v one (B, S, KV, "
                         f"hd) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd):
        raise ValueError(f"k, v must be {(B, S, KV, hd)}, got "
                         f"{tuple(k.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"n_heads {H} must be a multiple of n_kv {KV}")
    return B, S, H, KV, hd


def flash_attention_plain(q, k, v, *, softcap=None):
    """Plain PyTorch version: the kernel's schedule -- the online softmax
    over 64-key tiles -- for all query rows at once. Tiles past a row's
    diagonal add p = 0 with a correction of 1, so skipping them (as the
    kernel does) changes nothing. The bfloat16 kernel at hd 256 takes
    32-key tiles (`kv_tile`), so there p is rounded to bf16 against a
    running max that can differ from this version's; both stay within
    the tests' tolerance of the reference."""
    B, S, H, KV, hd = _check_shapes(q, k, v)
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 1, 3)                         # (B, KV, S, hd)
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((B, KV, G, S, 1), NEG, device=q.device)
    l = torch.zeros((B, KV, G, S, 1), device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, S, TILE):
        kc = kt[:, :, k0:k0 + TILE].float()
        s = torch.einsum("bkgqh,bkth->bkgqt", qg, kc) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + kc.shape[2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgqt,bkth->bkgqh", p.to(v.dtype).float(),
                          vt[:, :, k0:k0 + TILE].float())
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, softcap=None):
    """Causal GQA flash attention: the CUDA kernel on CUDA tensors,
    `flash_attention_plain` on CPU tensors; on "meta" tensors in the dry
    run's step counter nothing runs and `obs.cost.flash_attention` is
    declared. Forward only: raises NotImplementedError under grad when an
    input requires grad."""
    B, S, H, KV, hd = _check_shapes(q, k, v)
    build.refuse_dtensor("flash_attention", q, k, v)
    build.refuse_grad("flash_attention", "use_flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, softcap=softcap)
    if q.device.type == "meta" and build.counting():   # the dry run
        from ..obs import cost
        return build.declared(cost.flash_attention(
            B, S, H, KV, hd, q.element_size()), torch.empty_like(q))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {list(DTYPES)}, got "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"on {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    # float32 puts B * H on grid.y, bfloat16 the q tiles (grid.y <= 65,535)
    rows, what = ((B * H, "B * H") if q.dtype == torch.float32
                  else (-(-S // TILE), "ceil(S / 64)"))
    if rows > 65_535:
        raise ValueError(f"{what} = {rows} exceeds the grid's 65535 rows")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the bfloat16 kernel copies 16-byte chunks: q, k "
                         "and v must start at 16-byte aligned addresses")
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KV, hd, DTYPES[q.dtype], float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention", code)
    global LAUNCHES
    LAUNCHES += 1
    return out
