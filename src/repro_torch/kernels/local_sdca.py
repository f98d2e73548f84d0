"""LocalSDCA over dense rows: the CUDA kernel `csrc/local_sdca.cu` and its
plain PyTorch version.

Replaces the TPU kernel `repro/kernels/local_sdca.py::_sdca_kernel`. One
call runs one round for all K workers: `n_passes` passes over each worker's
nk rows in the order of its row of `perm`, from the shared start u = w,
emitting (dalpha (K, nk), du (K, d)) with du = scale * A_[k] dalpha.

The kernel walks the visit order in windows of `block_rows` rows (the
name of its counterpart in the reference's `local_sdca_pallas`): per window
it computes the rows' dots with the window's start u and their Gram matrix,
runs the window's closed-form updates in order on those, and applies the
window's rank-`block_rows` update to u -- the same walk in exact
arithmetic (see the source note). `dense_smem_budget` is its shared-memory
layout.

`local_sdca` launches the kernel for CUDA tensors and runs
`local_sdca_plain` for CPU tensors; there is no fallback between the two.
`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..core.losses import Loss
from . import build

CLOSED_FORM_LOSSES = ("hinge", "smooth_hinge", "squared", "absolute")
# bytes of dynamic shared memory a block may use on Hopper (opt-in limit)
MAX_SMEM_BYTES = 232_448
# the kernel's windows (template instances of csrc/local_sdca.cu) and the
# default, the fastest at epsilon's shape (PERF.md, the dense B sweep)
BLOCK_ROWS = (1, 2, 4, 8, 16, 32)
DEFAULT_BLOCK_ROWS = 8
# layout constants of csrc/local_sdca.cu: the block's warps, the words a
# warp's reduction buffer holds, and the windows of row ids in flight
WARPS, RED_WORDS, ID_SLOTS = 8, 64, 4

LAUNCHES = 0


def loss_code(loss: Loss):
    """(kernel loss id, smoothing g) -- `sdca::LossId` in sdca_common.cuh.
    Logistic has no closed form: use the eager solvers (core.solvers)."""
    for lid, prefix in enumerate(CLOSED_FORM_LOSSES):
        if loss.name.startswith(prefix):
            return lid, float(loss.smoothing)
    raise ValueError(
        f"kernel supports closed-form losses {CLOSED_FORM_LOSSES}, "
        f"got {loss.name!r}; use the core.solvers eager path instead")


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def dense_smem_budget(d: int, block_rows: int = DEFAULT_BLOCK_ROWS) -> dict:
    """Dynamic shared memory one block of the dense kernel uses, in bytes:
    u (d rounded up to 4 floats), a ring of two stages of B rows x d_tile
    floats, G (B x B), z0 and c (B each), two reduction buffers of 8 warps
    x 64 words and four windows of B row ids. d_tile is the whole (rounded)
    row where two stages of B rows fit, else the widest multiple of 4 that
    fits, evened out over the `chunks` column tiles a window then takes.
    `fits` is False when not even 4 columns fit beside u."""
    B = int(block_rows)
    if B not in BLOCK_ROWS:
        raise ValueError(f"block_rows must be one of {BLOCK_ROWS}, got {B}")
    dp = _round4(d)
    fixed = 4 * (dp + B * B + 2 * B + 2 * WARPS * RED_WORDS + ID_SLOTS * B)
    widest = (MAX_SMEM_BYTES - fixed) // (4 * 2 * B) // 4 * 4
    if widest >= dp:
        d_tile, chunks = dp, 1
    elif widest >= 4:
        chunks = -(-dp // widest)
        d_tile = _round4(-(-dp // chunks))
    else:
        d_tile, chunks = 4, -(-dp // 4)
    ring = 4 * 2 * B * d_tile
    total = fixed + ring
    return dict(u_bytes=4 * dp, ring_bytes=ring, d_tile=d_tile,
                chunks=chunks, total_bytes=total,
                fits=total <= MAX_SMEM_BYTES)


def check_u_fits(d: int, block_rows: int = DEFAULT_BLOCK_ROWS) -> dict:
    """u and the window's buffers live in shared memory: reject widths that
    do not fit (`dense_smem_budget`); returns the budget."""
    budget = dense_smem_budget(d, block_rows)
    if not budget["fits"]:
        raise ValueError(
            f"local_sdca: d={d} at block_rows={block_rows} needs "
            f"{budget['total_bytes']} bytes of shared memory per block (u "
            f"{budget['u_bytes']}, the rest "
            f"{budget['total_bytes'] - budget['u_bytes']}); the limit is "
            f"{MAX_SMEM_BYTES} bytes")
    return budget


def _check_shapes(X, y, alpha, mask, w, perm):
    if X.dim() != 3:
        raise ValueError(f"X must be (K, nk, d), got {tuple(X.shape)}")
    K, nk, d = X.shape
    for name, t in (("y", y), ("alpha", alpha), ("mask", mask),
                    ("perm", perm)):
        if tuple(t.shape) != (K, nk):
            raise ValueError(f"{name} must be {(K, nk)}, got "
                             f"{tuple(t.shape)}")
    if tuple(w.shape) != (d,):
        raise ValueError(f"w must be ({d},), got {tuple(w.shape)}")
    return K, nk, d


def local_sdca_plain(X, y, alpha, mask, w, scale, perm, *, loss: Loss,
                     n_passes: int = 1):
    """Plain PyTorch version: replays `repro.kernels.ref.local_sdca_ref`'s
    sequence (row perm[k, j] at step j) for all K workers at once."""
    loss_code(loss)
    K, nk, d = _check_shapes(X, y, alpha, mask, w, perm)
    ks = torch.arange(K, device=X.device)
    perm = perm.long()
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=X.device)
    u = w.float().expand(K, d).clone()
    for _ in range(n_passes):
        for j in range(nk):
            i = perm[:, j]
            x = X[ks, i]
            z = torch.sum(x * u, dim=-1)
            q = scale * torch.sum(x * x, dim=-1)
            abar = alpha[ks, i] + dalpha[ks, i]
            delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
            dalpha[ks, i] += delta
            u += (scale * delta)[:, None] * x
    return dalpha, u - w


def local_sdca(X, y, alpha, mask, w, scale, perm, *, loss: Loss,
               n_passes: int = 1, block_rows: int = DEFAULT_BLOCK_ROWS):
    """One round of LocalSDCA for all K workers: the CUDA kernel, in
    windows of `block_rows` rows, on CUDA tensors; `local_sdca_plain` on
    CPU tensors, whatever the window; on "meta" tensors in the dry run's
    step counter nothing runs and `obs.cost.dense_walk` is declared.

    X (K, nk, d) f32; y, alpha, mask (K, nk) f32; w (d,) f32; perm (K, nk)
    int32, each row a permutation of range(nk); scale = sigma'/(tau n).
    Returns (dalpha (K, nk), du (K, d)).

    The kernel indexes X with perm unchecked: a range check here would
    cost a device sync every launch, so `ops.perm_i32` checks perm on the
    host before it is copied over."""
    lid, g = loss_code(loss)
    K, nk, d = _check_shapes(X, y, alpha, mask, w, perm)
    dense_smem_budget(d, block_rows)            # a window the kernel has
    if X.device.type == "cpu":
        return local_sdca_plain(X, y, alpha, mask, w, scale, perm,
                                loss=loss, n_passes=n_passes)
    if X.device.type == "meta" and build.counting():   # the dry run
        from ..obs import cost
        return build.declared(
            cost.dense_walk(K, nk, d, steps=n_passes * nk),
            torch.empty((K, nk), dtype=torch.float32, device="meta"),
            torch.empty((K, d), dtype=torch.float32, device="meta"))
    if X.device.type != "cuda":
        raise ValueError(f"local_sdca runs on cuda or cpu, got {X.device}")
    for name, t in (("X", X), ("y", y), ("alpha", alpha), ("mask", mask),
                    ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != X.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {X.device}")
    if perm.dtype != torch.int32 or not perm.is_contiguous() \
            or perm.device != X.device:
        raise ValueError(f"perm must be a contiguous int32 tensor on "
                         f"{X.device}")
    budget = check_u_fits(d, block_rows)
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=X.device)
    du = torch.empty((K, d), dtype=torch.float32, device=X.device)
    lib = build.load("local_sdca")
    code = lib.local_sdca_launch(
        X.data_ptr(), y.data_ptr(), alpha.data_ptr(), mask.data_ptr(),
        w.data_ptr(), perm.data_ptr(), dalpha.data_ptr(), du.data_ptr(),
        K, nk, d, int(n_passes), float(scale), lid, g, int(block_rows),
        budget["d_tile"], torch.cuda.current_stream(X.device).cuda_stream)
    build.check(lib, "local_sdca", code)
    global LAUNCHES
    LAUNCHES += 1
    return dalpha, du
