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
arithmetic (see the source note). Each worker is a thread-block cluster of
C blocks, block r owning the columns [r dc, (r + 1) dc): the blocks
exchange their partial dots and Gram once a window and sum them in rank
order, so each runs the same updates. `dense_launch_plan` picks C from the
shapes and the clusters the card holds (`local_sdca_max_clusters`, asked
once a shape); `cluster=` forces it. `dense_smem_budget` is a block's
shared-memory layout.

`local_sdca` launches the kernel for CUDA tensors and runs
`local_sdca_plain` for CPU tensors; there is no fallback between the two,
and a cluster the card cannot hold raises. `LAUNCHES` counts kernel
launches; `LAST_DENSE_CONFIG` is the launch the last call ran (its plan;
form "plain" on the CPU).
"""
from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Union

import torch

from ..core.losses import Loss
from . import build

CLOSED_FORM_LOSSES = ("hinge", "smooth_hinge", "squared", "absolute")
# bytes of dynamic shared memory a block may use on Hopper (opt-in limit)
MAX_SMEM_BYTES = 232_448
# the kernel's windows (template instances of csrc/local_sdca.cu) and the
# default: 16 is faster at epsilon's shape, but slower at the paper cell's
# rank block, where its lookahead does not fit (PERF.md, PR 34's sweeps)
BLOCK_ROWS = (1, 2, 4, 8, 16, 32)
DEFAULT_BLOCK_ROWS = 8
# layout constants of csrc/local_sdca.cu: the column warps (the walk's
# warps but warp 0), the words a warp's reduction buffer holds, the
# deepest ring of row stages, the exchange's buffers, and the largest
# cluster (past 8 with the non-portable attribute)
COL_WARPS, RED_WORDS, RING_MAX, XBUFS, MAX_CLUSTER = 7, 64, 4, 4, 16
# the cluster sizes the plan takes, largest first, and the fewest columns a
# block of a cluster of C keeps, COLS_PER_PEER C: it pushes its partials
# to C peers a window (PERF.md, PR 34's cluster sweep)
CLUSTERS = (16, 8, 4, 2, 1)
COLS_PER_PEER = 16

LAUNCHES = 0
LAST_DENSE_CONFIG = None
_HELD = {}                  # (d, B, C) -> clusters of C the card holds


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


def partials(block_rows: int, ahead: bool) -> int:
    """Floats a window exchanges: G's upper triangle with its diagonal,
    then the dots -- B (B + 3) / 2 -- and with the lookahead (`ahead`) H,
    the window's rows against the window before's, B^2 more."""
    B = block_rows
    return B * (B + 3) // 2 + (B * B if ahead else 0)


def slice_cols(d: int, cluster: int) -> int:
    """The columns each block of a cluster of C owns: ceil(d / C) rounded
    up to 4 (the last block fewer, or none)."""
    return _round4(-(-d // cluster))


def dense_smem_budget(d: int, block_rows: int = DEFAULT_BLOCK_ROWS,
                      cluster: int = 1) -> dict:
    """Dynamic shared memory one block of the dense kernel uses in a
    cluster of `cluster` blocks, in bytes: a full and an empty mbarrier a
    ring stage, one an exchange buffer and the two of c, a ring of `ring`
    stages of B rows x d_tile floats, u's slice (dc floats, `slice_cols`;
    two, the window's start u and the next one's, with the lookahead),
    the exchange's four buffers of C P partials (`partials`), the block's
    own partials (P, for column tiles) and their rank-order sums (P), c and
    the row ids (two slots of B each) and two reduction buffers of 7 warps
    x 64 words. Whole slices (d_tile = dc) with the lookahead (`ahead`: the
    next window's partials taken during this one's updates) in the deepest
    ring of 4 .. 2 stages that fits; else, without it, two stages of the
    widest multiple of 4 columns that fits, evened out over the `chunks`
    column tiles a window then takes. `fits` is False when not even 4
    columns fit."""
    B, C = int(block_rows), int(cluster)
    if B not in BLOCK_ROWS:
        raise ValueError(f"block_rows must be one of {BLOCK_ROWS}, got {B}")
    if not 1 <= C <= MAX_CLUSTER:
        raise ValueError(f"cluster must be 1..{MAX_CLUSTER}, got {C}")
    dc = slice_cols(d, C)

    def words(dt, ring, ahead):
        P = partials(B, ahead)
        return (2 * (2 * ring + XBUFS + 2) + ring * B * dt
                + (2 if ahead else 1) * dc + XBUFS * C * P + 2 * P + 4 * B
                + 2 * COL_WARPS * RED_WORDS)
    for ring in range(RING_MAX, 1, -1):
        if 4 * words(dc, ring, True) <= MAX_SMEM_BYTES:
            d_tile, chunks, ahead = dc, 1, True
            break
    else:
        ring, ahead = 2, False
        widest = (MAX_SMEM_BYTES // 4 - words(0, 2, False)) // (2 * B) \
            // 4 * 4
        if widest >= 4:
            chunks = -(-dc // widest)
            d_tile = _round4(-(-dc // chunks))
        else:
            d_tile, chunks = 4, dc // 4
    total = 4 * words(d_tile, ring, ahead)
    return dict(cluster=C, dc=dc, d_tile=d_tile, chunks=chunks, ring=ring,
                ahead=ahead, u_bytes=4 * dc * (2 if ahead else 1),
                ring_bytes=4 * ring * B * d_tile,
                exchange_bytes=4 * XBUFS * C * partials(B, ahead),
                total_bytes=total, fits=total <= MAX_SMEM_BYTES)


def dense_launch_plan(K: int, nk: int, d: int, block_rows: int, *,
                      resident: Union[int, Mapping[int, int]],
                      cluster: Optional[int] = None) -> dict:
    """How a round runs on the card -- shape arithmetic only; what the
    card holds comes in as `resident`: the clusters of each C it holds at
    once (`local_sdca_max_clusters`), a {C: clusters} mapping or one count
    for every C. Takes the largest C of `CLUSTERS` whose block fits shared
    memory, keeps at least `COLS_PER_PEER` C columns a block and has all K
    clusters resident at once; C = 1 (a block a worker, in waves past what
    the card holds) wherever it fits; past that the smallest C that fits
    and that the card holds. `cluster` forces C; a forced cluster the card
    holds none of raises ValueError. Returns the budget's layout (`dc`,
    `d_tile`, `chunks`, `ring`, `ahead`, `smem_bytes`, `fits`) with
    `cluster`,
    `block_rows`, `blocks` (K C), `windows` a pass and `held`, the
    clusters of C resident."""
    B = int(block_rows)

    def held(C):
        return resident.get(C, 0) if isinstance(resident, Mapping) \
            else int(resident)

    def plan(C):
        b = dense_smem_budget(d, B, C)
        return dict(cluster=C, block_rows=B, blocks=K * C,
                    windows=-(-nk // B), dc=b["dc"],
                    d_tile=b["d_tile"], chunks=b["chunks"], ring=b["ring"],
                    ahead=b["ahead"], smem_bytes=b["total_bytes"],
                    fits=b["fits"],
                    held=held(C))
    if cluster is not None:
        got = plan(int(cluster))
        if got["fits"] and got["held"] < 1:
            raise ValueError(f"local_sdca: the card holds no cluster of "
                             f"{cluster} blocks of {got['smem_bytes']} bytes "
                             f"(d={d}, block_rows={B})")
        return got
    plans = [plan(C) for C in CLUSTERS]
    usable = [p for p in plans if p["fits"] and p["held"] >= 1]
    for p in usable:
        if p["cluster"] == 1 or (p["dc"] >= COLS_PER_PEER * p["cluster"]
                                 and K <= p["held"]):
            return p
    return usable[-1] if usable else plans[-1]


def check_u_fits(d: int, block_rows: int = DEFAULT_BLOCK_ROWS,
                 cluster: int = 1) -> dict:
    """u's slice and the window's buffers live in shared memory: reject
    widths that do not fit (`dense_smem_budget`); returns the budget."""
    budget = dense_smem_budget(d, block_rows, cluster)
    if not budget["fits"]:
        raise ValueError(
            f"local_sdca: d={d} at block_rows={block_rows} in clusters of "
            f"{cluster} needs {budget['total_bytes']} bytes of shared memory "
            f"per block (u's slice {budget['u_bytes']}, the rest "
            f"{budget['total_bytes'] - budget['u_bytes']}); the limit is "
            f"{MAX_SMEM_BYTES} bytes")
    return budget


def _held(lib, d: int, B: int, C: int) -> int:
    """cudaOccupancyMaxActiveClusters of the layout: how many clusters of
    C blocks the card holds at once (0: none), asked once a shape."""
    key = (d, B, C)
    if key not in _HELD:
        out = ctypes.c_int(0)
        code = lib.local_sdca_max_clusters(d, B, C, ctypes.byref(out))
        build.check(lib, "local_sdca", code)
        _HELD[key] = out.value
    return _HELD[key]


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
               n_passes: int = 1, block_rows: int = DEFAULT_BLOCK_ROWS,
               cluster: Optional[int] = None):
    """One round of LocalSDCA for all K workers: the CUDA kernel, in
    windows of `block_rows` rows, on CUDA tensors -- K clusters of the C
    blocks `dense_launch_plan` picks, or of `cluster` blocks where given
    (a cluster the card cannot hold raises; nothing runs in its place);
    `local_sdca_plain` on CPU tensors, whatever the window and cluster; on
    "meta" tensors in the dry run's step counter nothing runs and
    `obs.cost.dense_walk` is declared.

    X (K, nk, d) f32; y, alpha, mask (K, nk) f32; w (d,) f32; perm (K, nk)
    int32, each row a permutation of range(nk); scale = sigma'/(tau n).
    Returns (dalpha (K, nk), du (K, d)).

    The kernel indexes X with perm unchecked: a range check here would
    cost a device sync every launch, so `ops.perm_i32` checks perm on the
    host before it is copied over."""
    lid, g = loss_code(loss)
    K, nk, d = _check_shapes(X, y, alpha, mask, w, perm)
    B = int(block_rows)
    dense_smem_budget(d, B, 1 if cluster is None else cluster)  # one it has
    global LAUNCHES, LAST_DENSE_CONFIG
    if X.device.type == "cpu":
        LAST_DENSE_CONFIG = dict(form="plain", block_rows=B, cluster=None)
        return local_sdca_plain(X, y, alpha, mask, w, scale, perm,
                                loss=loss, n_passes=n_passes)
    if X.device.type == "meta" and build.counting():   # the dry run
        from ..obs import cost
        LAST_DENSE_CONFIG = dict(form="declared", block_rows=B, cluster=None)
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
    lib = build.load("local_sdca")
    sizes = CLUSTERS if cluster is None else (int(cluster),)
    resident = {C: _held(lib, d, B, C) for C in sizes
                if dense_smem_budget(d, B, C)["fits"]}
    plan = dense_launch_plan(K, nk, d, B, resident=resident, cluster=cluster)
    C = plan["cluster"]
    check_u_fits(d, B, C)
    # each block's own copy of dalpha (rank 0's is the result)
    dalpha = torch.zeros((C, K, nk), dtype=torch.float32, device=X.device)
    du = torch.empty((K, d), dtype=torch.float32, device=X.device)
    code = lib.local_sdca_launch(
        X.data_ptr(), y.data_ptr(), alpha.data_ptr(), mask.data_ptr(),
        w.data_ptr(), perm.data_ptr(), dalpha.data_ptr(), du.data_ptr(),
        K, nk, d, int(n_passes), float(scale), lid, g, B, C,
        torch.cuda.current_stream(X.device).cuda_stream)
    build.check(lib, "local_sdca", code)
    LAUNCHES += 1
    LAST_DENSE_CONFIG = dict(form="cluster", forced=cluster is not None,
                             **{k: plan[k] for k in (
                                 "block_rows", "cluster", "dc", "d_tile",
                                 "chunks", "ring", "ahead", "smem_bytes",
                                 "held")})
    return dalpha[0], du
