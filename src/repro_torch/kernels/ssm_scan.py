"""Fused mamba-1 selective scan: the CUDA kernel `csrc/ssm_scan.cu` and
its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/ssm_scan.py::_scan_kernel`:

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t + D x_t

xin, dt (B, S, di) f32; Bm, Cm (B, S, N) f32; A (di, N) f32 (negative);
D (di,) f32 -> y (B, S, di) f32, from h = 0. The kernel takes N <= 16 and
any di (the reference's block_d tiling is gone: one lane per (b, c, n)).

`ssm_scan` launches the kernel for CUDA tensors and runs `ssm_scan_plain`
for CPU tensors; there is no fallback between the two. `LAUNCHES` counts
kernel launches.
"""
from __future__ import annotations

import torch

from . import build

MAX_STATE = 16            # LANES in the .cu: one lane per state index

LAUNCHES = 0


def _check_shapes(xin, dt, Bm, Cm, A, D):
    if xin.dim() != 3:
        raise ValueError(f"xin must be (B, S, di), got {tuple(xin.shape)}")
    B, S, di = xin.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (B, S, di), "Bm": (B, S, N), "Cm": (B, S, N),
            "A": (di, N), "D": (di,)}
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A), ("D", D)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    return B, S, di, N


def ssm_scan_plain(xin, dt, Bm, Cm, A, D):
    """Plain PyTorch version: the sequential recurrence of
    `repro.kernels.ref.ssm_scan_ref`, one time step at a time."""
    B, S, di, N = _check_shapes(xin, dt, Bm, Cm, A, D)
    h = torch.zeros((B, di, N), dtype=torch.float32, device=xin.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t, :, None] * A[None])             # (B,di,N)
        h = decay * h + (dt[:, t] * xin[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]) + D * xin[:, t])
    return torch.stack(ys, dim=1)


def ssm_scan(xin, dt, Bm, Cm, A, D):
    """Fused selective scan: the CUDA kernel on CUDA tensors,
    `ssm_scan_plain` on CPU tensors."""
    B, S, di, N = _check_shapes(xin, dt, Bm, Cm, A, D)
    if xin.device.type == "cpu":
        return ssm_scan_plain(xin, dt, Bm, Cm, A, D)
    if xin.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, got {xin.device}")
    for name, t in (("xin", xin), ("dt", dt), ("Bm", Bm), ("Cm", Cm),
                    ("A", A), ("D", D)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != xin.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {xin.device}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size N={N} not in [1, {MAX_STATE}]")
    if B > 65_535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 rows")
    y = torch.empty((B, S, di), dtype=torch.float32, device=xin.device)
    lib = build.load("ssm_scan")
    code = lib.ssm_scan_launch(
        xin.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), B, S, di, N,
        torch.cuda.current_stream(xin.device).cuda_stream)
    build.check(lib, "ssm_scan", code)
    global LAUNCHES
    LAUNCHES += 1
    return y
