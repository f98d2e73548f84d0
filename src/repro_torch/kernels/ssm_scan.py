"""Fused mamba-1 selective scan: the CUDA kernel `csrc/ssm_scan.cu` and
its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/ssm_scan.py::_scan_kernel`:

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t + D x_t

xin, dt (B, S, di) f32; Bm, Cm (B, S, N) f32; A (di, N) f32 (negative);
D (di,) f32 -> y (B, S, di) f32, from h = 0. The kernel takes 1 <= N <= 16
and any di (the reference's block_d tiling is gone).

The kernel's launch (`scan_launch_plan`): a block holds CHANNELS = 32
channels, one a lane, and ceil(N / G) warps, a thread owning G states of
its channel; the streams are staged in chunks of CHUNK = 64 time steps,
two stages deep, with two sets of ceil(N / G) planes of y partials beside
them (`smem_bytes`). The library holds the G of GROUPS; DEFAULT_GROUP is
the fastest at the scoring shape (the sweep in PERF.md §6).

`ssm_scan` launches the kernel for CUDA tensors and runs `ssm_scan_plain`
for CPU tensors; there is no fallback between the two. `LAUNCHES` counts
kernel launches.
"""
from __future__ import annotations

import torch

from . import build

MAX_STATE = 16            # MAX_STATE in the .cu: B and C rows padded to it
CHANNELS = 32             # CH in the .cu: channels a block, one a lane
CHUNK = 64                # T in the .cu: time steps a chunk
GROUPS = (4, 8, 16)       # SSM_SCAN_GROUPS in the .cu: states a thread
DEFAULT_GROUP = 4
MAX_GRID_Y = 65_535       # the batch rides on grid.y

LAUNCHES = 0


def smem_bytes(N: int, group: int = DEFAULT_GROUP) -> int:
    """Dynamic shared memory of one block: two stages of x and dt (T x 32)
    and B and C (T x 16), and two sets of ceil(N / G) planes of y partials
    (T x 32), all float32."""
    stage = 2 * CHUNK * CHANNELS + 2 * CHUNK * MAX_STATE
    return 4 * (2 * stage + 2 * -(-N // group) * CHUNK * CHANNELS)


def scan_launch_plan(B: int, S: int, di: int, N: int,
                     group: int = DEFAULT_GROUP) -> dict:
    """The kernel's launch at (B, S, di, N): grid, threads a block, dynamic
    shared memory, and the chunks a block walks. Raises ValueError for
    what the kernel does not take."""
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size N={N} not in [1, {MAX_STATE}]")
    if group not in GROUPS:
        raise ValueError(f"group={group} is not an instance of the "
                         f"kernel: {GROUPS}")
    if not 1 <= B <= MAX_GRID_Y:
        raise ValueError(f"batch {B} not in [1, {MAX_GRID_Y}] (grid rows)")
    if S < 1 or di < 1:
        raise ValueError(f"S={S} and di={di} must be >= 1")
    return dict(grid=(-(-di // CHANNELS), B),
                threads=CHANNELS * -(-N // group),
                smem_bytes=smem_bytes(N, group), group=group,
                chunks=-(-S // CHUNK))


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


def ssm_scan(xin, dt, Bm, Cm, A, D, *, group: int = DEFAULT_GROUP):
    """Fused selective scan: the CUDA kernel on CUDA tensors (its
    instance of `group` states a thread), `ssm_scan_plain` on CPU
    tensors. Forward only: raises NotImplementedError under grad when an
    input requires grad."""
    B, S, di, N = _check_shapes(xin, dt, Bm, Cm, A, D)
    build.refuse_dtensor("ssm_scan", xin, dt, Bm, Cm, A, D)
    build.refuse_grad("ssm_scan", "use_fused_ssm", xin, dt, Bm, Cm, A, D)
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
    plan = scan_launch_plan(B, S, di, N, group)
    y = torch.empty((B, S, di), dtype=torch.float32, device=xin.device)
    lib = build.load("ssm_scan")
    code = lib.ssm_scan_launch(
        xin.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), B, S, di, N,
        plan["group"], torch.cuda.current_stream(xin.device).cuda_stream)
    build.check(lib, "ssm_scan", code)
    global LAUNCHES
    LAUNCHES += 1
    return y
