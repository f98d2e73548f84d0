"""LocalSDCA over padded-ELL rows, with the fused prox: the CUDA kernels
`csrc/sparse_sdca_pipelined.cu` and `csrc/sparse_sdca_zx.cu`, and their
plain PyTorch versions.

`sparse_local_sdca` replaces the TPU kernels `repro/kernels/sparse_sdca.py::
_sparse_sdca_kernel` (buffer_depth 1) and `_sparse_sdca_pipelined_kernel`
(buffer_depth >= 2) with one kernel templated on its ring depth: at depth 1
each row is fetched in its own step, at depth >= 2 the next rows are
prefetched. One call runs one round for all K workers: per row an
r_max gather-dot `sum_r prox(u[c_r]) * v_r` (prox only when `prox_kappa`
is set), `q = scale * sum_r v_r^2`, the closed-form update, then an r_max
scatter-axpy into raw u. Padding slots (col 0, val 0) are exact no-ops and
duplicate column ids in a row all land. With the prox fused the caller
passes w = v, so u lives in v-space; du = u - w = scale * A_[k] dalpha.
Every depth walks the same visit order and gives the same results.

`sparse_local_sdca_zx` replaces `_sparse_sdca_zx_kernel`: the z-exchange
schedule of a feature-sharded (data=K, model=M) mesh, on one card. Each
invocation walks one block of `block_rows` rows of the visit order against
the exchanged (model-summed) partial dots, with q from the global row
norms, then emits the next block's partial dots at the updated u.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors. `LAUNCHES` counts the 1-D kernel's launches at
depth 1 (the counterpart of `_sparse_sdca_kernel`), `PIPELINED_LAUNCHES`
those at depth >= 2, `ZX_LAUNCHES` the zx kernel's (one a round: the
round's invocations run inside it, one thread-block cluster of M blocks
per worker) and `ZX_STEPS` the invocations those launches ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.losses import Loss
from ..core.regularizers import soft_threshold
from . import build
from .local_sdca import MAX_SMEM_BYTES, loss_code

LAUNCHES = 0                # csrc/sparse_sdca_pipelined.cu at depth 1
PIPELINED_LAUNCHES = 0      # the same kernel at depth >= 2
ZX_LAUNCHES = 0             # csrc/sparse_sdca_zx.cu, one per round
ZX_STEPS = 0                # the invocations (blocks of rows) they ran
MAX_DEPTH = 8               # ring stages the 1-D kernel is built for
STAGE_SCALARS = 8           # words of a 1-D ring stage after cols and vals
ZX_MAX_CLUSTER = 16         # with the non-portable cluster-size attribute
ZX_ID_SLOTS, ZX_SCALARS = 4, 5   # ID_SLOTS, SCALARS in the .cu
ZX_ROADMAP = ("ROADMAP.md Queue 2, 'The z-exchange round beyond one "
              "cluster'")


def stage_row_words(r_max: int) -> int:
    """Words a 1-D ring stage gives one row's cols (and its vals): the row
    and up to 3 words before it, from its 16-byte chunk on, rounded up to
    16 bytes (`row_words` in csrc/sparse_sdca_pipelined.cu)."""
    return (r_max + 6) // 4 * 4


def smem_budget(*, d: int, r_max: int, nk: Optional[int] = None,
                buffer_depth: int = 1, block_rows: int = 16,
                zx: bool = False) -> dict:
    """Dynamic shared memory one block of the launch uses, in bytes (the
    counterpart of the reference's `vmem_budget`). The 1-D kernel (a walk
    warp and a fetch warp a worker, no reduction scratch) holds u (4 d)
    and a ring of
    min(buffer_depth, nk) rows: cols and vals, each in a region of
    `stage_row_words(r_max)` words (the row's 16-byte chunks), then y,
    alpha, mask, dalpha, the row id and three spare words
    (`STAGE_SCALARS`), and the stage's two 8-byte mbarriers.

    The zx kernel (d = d_local, r_max = r_loc) holds the two z buffers and
    a coefficient per block row (scratch), its prefetch (two row stages of
    B rows' cols, vals and five scalars, and four slots of B row ids:
    ring), and u (4 d) when that fits beside them; else u stays in device
    memory (`u_in_smem` False, `u_bytes` 0)."""
    if zx:
        B = block_rows
        scratch = 4 * 3 * B
        ring = 4 * (ZX_ID_SLOTS * B + 2 * (2 * B * r_max + ZX_SCALARS * B))
        u_in_smem = 4 * d + ring + scratch <= MAX_SMEM_BYTES
        u = 4 * d if u_in_smem else 0
    else:
        u, scratch, u_in_smem = 4 * d, 0, True
        stages = min(buffer_depth, nk) if nk is not None else buffer_depth
        ring = stages * (4 * (2 * stage_row_words(r_max) + STAGE_SCALARS)
                         + 16)          # and two 8-byte mbarriers a stage
    total = u + ring + scratch
    return dict(u_bytes=u, ring_bytes=ring, scratch_bytes=scratch,
                total_bytes=total, fits=total <= MAX_SMEM_BYTES,
                u_in_smem=u_in_smem)


def _enforce_smem(budget: dict, where: str) -> None:
    """Reject a launch whose shared memory does not fit a block."""
    if not budget["fits"]:
        raise ValueError(
            f"{where}: needs {budget['total_bytes']} bytes of shared memory "
            f"per block (u {budget['u_bytes']}, ring {budget['ring_bytes']}, "
            f"scratch {budget['scratch_bytes']}); the limit is "
            f"{MAX_SMEM_BYTES} bytes")


def _require(device, **tensors):
    """Every tensor contiguous, on `device`, float32 (int32 for cols and
    perm): what the kernels take."""
    for name, t in tensors.items():
        want = torch.int32 if name in ("cols", "perm") else torch.float32
        if t.dtype != want or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be a contiguous {want} tensor on "
                             f"{device}")


def _check_shapes(cols, vals, y, alpha, mask, w, perm):
    if cols.dim() != 3 or tuple(vals.shape) != tuple(cols.shape):
        raise ValueError(f"cols/vals must both be (K, nk, r_max), got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    K, nk, r_max = cols.shape
    for name, t in (("y", y), ("alpha", alpha), ("mask", mask),
                    ("perm", perm)):
        if tuple(t.shape) != (K, nk):
            raise ValueError(f"{name} must be {(K, nk)}, got "
                             f"{tuple(t.shape)}")
    if w.dim() != 1:
        raise ValueError(f"w must be (d,), got {tuple(w.shape)}")
    return K, nk, r_max, w.shape[0]


def sparse_local_sdca_plain(cols, vals, y, alpha, mask, w, scale, perm, *,
                            loss: Loss, n_passes: int = 1,
                            prox_kappa: Optional[float] = None):
    """Plain PyTorch version: replays `repro.kernels.ref.
    sparse_local_sdca_ref`'s sequence (row perm[k, j] at step j) for all K
    workers at once; scatter_add_ lands duplicate columns one by one."""
    loss_code(loss)
    K, nk, r_max, d = _check_shapes(cols, vals, y, alpha, mask, w, perm)
    ks = torch.arange(K, device=vals.device)
    perm = perm.long()
    cols = cols.long()
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=vals.device)
    u = w.float().expand(K, d).clone()
    for _ in range(n_passes):
        for j in range(nk):
            i = perm[:, j]
            ci, vi = cols[ks, i], vals[ks, i]
            uv = u.gather(1, ci)
            if prox_kappa is not None:
                uv = soft_threshold(uv, prox_kappa)
            z = torch.sum(uv * vi, dim=-1)
            q = scale * torch.sum(vi * vi, dim=-1)
            abar = alpha[ks, i] + dalpha[ks, i]
            delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
            dalpha[ks, i] += delta
            u.scatter_add_(1, ci, (scale * delta)[:, None] * vi)
    return dalpha, u - w


def sparse_local_sdca(cols, vals, y, alpha, mask, w, scale, perm, *,
                      loss: Loss, n_passes: int = 1,
                      prox_kappa: Optional[float] = None,
                      buffer_depth: int = 1):
    """One round of sparse LocalSDCA for all K workers: on CUDA tensors the
    kernel with a ring of buffer_depth rows (clamped to nk: see its source
    note), which at depth >= 2 prefetches the next rows; on CPU tensors
    `sparse_local_sdca_plain`, whatever the depth.

    cols (K, nk, r_max) int32 (padding col 0); vals (K, nk, r_max) f32
    (padding 0); y, alpha, mask (K, nk) f32; w (d,) f32; perm (K, nk) int32;
    scale = sigma'/(tau n). Returns (dalpha (K, nk), du (K, d)).

    The kernels index with perm and cols unchecked: a range check here
    would cost device syncs and a pass over cols every launch, so perm is
    checked on the host by `ops.perm_i32` and the column ids once where the
    shards are built (`data.sparse`)."""
    lid, g = loss_code(loss)
    K, nk, r_max, d = _check_shapes(cols, vals, y, alpha, mask, w, perm)
    if not 1 <= buffer_depth <= MAX_DEPTH:
        raise ValueError(f"buffer_depth must lie in [1, {MAX_DEPTH}], got "
                         f"{buffer_depth}")
    if vals.device.type == "cpu":
        return sparse_local_sdca_plain(cols, vals, y, alpha, mask, w, scale,
                                       perm, loss=loss, n_passes=n_passes,
                                       prox_kappa=prox_kappa)
    if vals.device.type != "cuda":
        raise ValueError(f"sparse_local_sdca runs on cuda or cpu, got "
                         f"{vals.device}")
    _require(vals.device, vals=vals, y=y, alpha=alpha, mask=mask, w=w,
             cols=cols, perm=perm)
    _enforce_smem(smem_budget(d=d, r_max=r_max, nk=nk,
                              buffer_depth=buffer_depth),
                  "sparse_local_sdca")
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=vals.device)
    du = torch.empty((K, d), dtype=torch.float32, device=vals.device)
    lib = build.load("sparse_sdca_pipelined")
    depth = min(buffer_depth, nk)   # the ring never reaches past the pass
    code = lib.sparse_sdca_pipelined_launch(
        cols.data_ptr(), vals.data_ptr(), y.data_ptr(), alpha.data_ptr(),
        mask.data_ptr(), w.data_ptr(), perm.data_ptr(), dalpha.data_ptr(),
        du.data_ptr(), K, nk, r_max, d, int(n_passes), float(scale), lid, g,
        int(prox_kappa is not None),
        float(prox_kappa) if prox_kappa is not None else 0.0,
        depth, torch.cuda.current_stream(vals.device).cuda_stream)
    build.check(lib, "sparse_sdca_pipelined", code)
    global LAUNCHES, PIPELINED_LAUNCHES
    if depth == 1:
        LAUNCHES += 1
    else:
        PIPELINED_LAUNCHES += 1
    return dalpha, du


# ----------------------------------------------------------------------------
# the z-exchange schedule (feature-sharded, M model shards per worker)
# ----------------------------------------------------------------------------

def zx_exchanges(nk: int, block_rows: int, n_passes: int = 1) -> int:
    """Model-axis exchanges of `block_rows` floats one zx round performs:
    one per scheduled block (ceil(nk / block_rows) blocks a pass) plus the
    prologue priming block 0 at u = w."""
    return n_passes * (-(-nk // block_rows)) + 1


def zx_launch_plan(K: int, M: int, nk: int, d_loc: int, B: int, *,
                   r_loc: int, n_passes: int = 1) -> dict:
    """How the zx kernel runs one round on the card -- shape arithmetic
    only: `launches` (1) of K thread-block clusters of `cluster` (M)
    blocks; `steps` invocations inside it; `u_in_smem`, `smem_bytes` and
    `fits` from `smem_budget(zx=True)`. Raises ValueError for M above 16,
    the largest cluster the card schedules (the CPU plain version takes
    any M)."""
    if not 1 <= M <= ZX_MAX_CLUSTER:
        raise ValueError(
            f"the zx kernel runs a worker's M = {M} model shards as one "
            f"thread-block cluster, at most {ZX_MAX_CLUSTER} blocks on this "
            f"card; see {ZX_ROADMAP}")
    budget = smem_budget(d=d_loc, r_max=r_loc, block_rows=B, zx=True)
    return dict(launches=1, cluster=M,
                steps=n_passes * (-(-nk // B)),
                u_in_smem=budget["u_in_smem"],
                smem_bytes=budget["total_bytes"], fits=budget["fits"])


def _zx_clusters_fit(lib, M: int, B: int, r_loc: int, d_loc: int,
                     u_in_smem: bool) -> int:
    """cudaOccupancyMaxActiveClusters of the instance: how many clusters
    of M blocks the card holds at once (0: a cluster does not fit)."""
    out = ctypes.c_int(0)
    code = lib.sparse_sdca_zx_max_clusters(M, B, r_loc, d_loc,
                                           int(u_in_smem), ctypes.byref(out))
    build.check(lib, "sparse_sdca_zx", code)
    return out.value


def _check_zx_shapes(cols, vals, y, alpha, mask, w, sqnorms, perm):
    if cols.dim() != 4 or tuple(vals.shape) != tuple(cols.shape):
        raise ValueError(f"cols/vals must both be (K, M, nk, r_loc), got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    K, M, nk, r_loc = cols.shape
    for name, t in (("y", y), ("alpha", alpha), ("mask", mask),
                    ("sqnorms", sqnorms), ("perm", perm)):
        if tuple(t.shape) != (K, nk):
            raise ValueError(f"{name} must be {(K, nk)}, got "
                             f"{tuple(t.shape)}")
    if w.dim() != 1 or w.shape[0] % M:
        raise ValueError(f"w must be the padded (M * d_local,) vector, got "
                         f"{tuple(w.shape)} for M={M}")
    return K, M, nk, r_loc, w.shape[0] // M


def _block_rows_of(perm, nk: int, B: int, b: int):
    """Row ids of block b of the visit order, (K, <= B) (the last ragged)."""
    return perm[:, b * B:min((b + 1) * B, nk)]


def zx_partial_dots(cols, vals, u, rows, prox_kappa: Optional[float] = None):
    """Each shard's partial gather-dots of the rows `rows` (K, R) at u
    (K, M, d_loc): (K, M, R). The prologue of both versions (block 0 at
    u = w, as the reference's `z0`) and the plain version's next dots."""
    K, M, nk, r_loc = cols.shape
    R = rows.shape[1]
    idx = rows.long()[:, None, :, None].expand(K, M, R, r_loc)
    c = cols.gather(2, idx).long()
    v = vals.gather(2, idx)
    uv = u.gather(2, c.reshape(K, M, R * r_loc)).reshape(K, M, R, r_loc)
    if prox_kappa is not None:
        uv = soft_threshold(uv, prox_kappa)
    return torch.sum(uv * v, dim=-1)


def sparse_local_sdca_zx_plain(cols, vals, y, alpha, mask, w, scale,
                               sqnorms, perm, *, loss: Loss,
                               n_passes: int = 1, block_rows: int = 16,
                               prox_kappa: Optional[float] = None):
    """Plain PyTorch version: replays the reference's scan
    (`sparse_local_sdca_zx` at repro/kernels/sparse_sdca.py:476) for all
    (k, m) at once. The rows of a block update together against the
    block's exchanged z; their scatter_add_ lands row after row, slot after
    slot, as the reference's walk does."""
    loss_code(loss)
    K, M, nk, r_loc, d_loc = _check_zx_shapes(cols, vals, y, alpha, mask, w,
                                              sqnorms, perm)
    B = int(block_rows)
    nb = -(-nk // B)
    w3 = w.float().reshape(1, M, d_loc)
    u = w3.expand(K, M, d_loc).clone()
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=vals.device)
    perm = perm.long()
    z = zx_partial_dots(cols, vals, u, _block_rows_of(perm, nk, B, 0),
                        prox_kappa)
    for gi in range(n_passes * nb):
        rows = _block_rows_of(perm, nk, B, gi % nb)
        R = rows.shape[1]
        z_ex = z[:, 0]
        for m in range(1, M):                 # the psum, in a fixed order
            z_ex = z_ex + z[:, m]
        dai = dalpha.gather(1, rows)
        delta = loss.cd_update(alpha.gather(1, rows) + dai, z_ex,
                               scale * sqnorms.gather(1, rows),
                               y.gather(1, rows)) * mask.gather(1, rows)
        dalpha.scatter_(1, rows, dai + delta)
        idx = rows[:, None, :, None].expand(K, M, R, r_loc)
        c = cols.gather(2, idx).long().reshape(K, M, R * r_loc)
        v = vals.gather(2, idx)
        u.scatter_add_(2, c, ((scale * delta)[:, None, :, None] * v)
                       .reshape(K, M, R * r_loc))
        z = zx_partial_dots(cols, vals, u,
                            _block_rows_of(perm, nk, B, (gi + 1) % nb),
                            prox_kappa)
    return dalpha, (u - w3).reshape(K, M * d_loc)


def sparse_local_sdca_zx(cols, vals, y, alpha, mask, w, scale, sqnorms,
                         perm, *, loss: Loss, n_passes: int = 1,
                         block_rows: int = 16,
                         prox_kappa: Optional[float] = None):
    """One round of the z-exchange schedule for all K workers and M model
    shards: on CUDA tensors one launch of the zx kernel, K clusters of M
    blocks walking the round's n_passes * ceil(nk / block_rows)
    invocations (`zx_launch_plan`; M <= 16), on CPU tensors
    `sparse_local_sdca_zx_plain` (any M).

    cols/vals (K, M, nk, r_loc) with shard-local ids (a `FeatureShards`);
    y, alpha, mask (K, nk) f32; w the padded (M d_local,) f32 vector;
    sqnorms (K, nk) the global row norms; perm (K, nk) int32, the visit
    order every shard of worker k walks. Returns (dalpha (K, nk),
    du (K, M d_local))."""
    lid, g = loss_code(loss)
    K, M, nk, r_loc, d_loc = _check_zx_shapes(cols, vals, y, alpha, mask, w,
                                              sqnorms, perm)
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if vals.device.type == "cpu":
        return sparse_local_sdca_zx_plain(
            cols, vals, y, alpha, mask, w, scale, sqnorms, perm, loss=loss,
            n_passes=n_passes, block_rows=block_rows, prox_kappa=prox_kappa)
    if vals.device.type != "cuda":
        raise ValueError(f"sparse_local_sdca_zx runs on cuda or cpu, got "
                         f"{vals.device}")
    _require(vals.device, vals=vals, y=y, alpha=alpha, mask=mask, w=w,
             sqnorms=sqnorms, cols=cols, perm=perm)
    B = int(block_rows)
    plan = zx_launch_plan(K, M, nk, d_loc, B, r_loc=r_loc,
                          n_passes=int(n_passes))
    if not plan["fits"]:
        raise ValueError(
            f"sparse_local_sdca_zx: needs {plan['smem_bytes']} bytes of "
            f"shared memory per block for B = {B} rows of r_loc = {r_loc} "
            f"(z buffers and prefetch stage); the limit is {MAX_SMEM_BYTES} "
            f"bytes")
    lib = build.load("sparse_sdca_zx")
    if _zx_clusters_fit(lib, M, B, r_loc, d_loc, plan["u_in_smem"]) < 1:
        raise ValueError(
            f"sparse_local_sdca_zx: a cluster of M = {M} blocks of "
            f"{plan['smem_bytes']} bytes of shared memory does not fit this "
            f"card; see {ZX_ROADMAP}")
    w3 = w.reshape(1, M, d_loc)
    # a copy even at K = 1, where the expanded view is w itself: the kernel
    # updates u in place
    u = w3.expand(K, M, d_loc).clone()
    dalpha = torch.zeros((K, M, nk), dtype=torch.float32, device=vals.device)
    z0 = torch.zeros((K, M, B), dtype=torch.float32, device=vals.device)
    z0[:, :, :min(B, nk)] = zx_partial_dots(
        cols, vals, u, _block_rows_of(perm, nk, B, 0), prox_kappa)
    code = lib.sparse_sdca_zx_launch(
        cols.data_ptr(), vals.data_ptr(), y.data_ptr(), alpha.data_ptr(),
        mask.data_ptr(), sqnorms.data_ptr(), perm.data_ptr(), u.data_ptr(),
        dalpha.data_ptr(), z0.data_ptr(), K, M, nk, r_loc, d_loc, B,
        int(n_passes), float(scale), lid, g, int(prox_kappa is not None),
        float(prox_kappa) if prox_kappa is not None else 0.0,
        int(plan["u_in_smem"]),
        torch.cuda.current_stream(vals.device).cuda_stream)
    build.check(lib, "sparse_sdca_zx", code)
    global ZX_LAUNCHES, ZX_STEPS
    ZX_LAUNCHES += 1
    ZX_STEPS += plan["steps"]
    return dalpha[:, 0].contiguous(), (u - w3).reshape(K, M * d_loc)
