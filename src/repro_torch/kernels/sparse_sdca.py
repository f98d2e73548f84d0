"""LocalSDCA over padded-ELL rows, with the fused prox: the CUDA kernels
`csrc/sparse_sdca_pipelined.cu`, `csrc/sparse_sdca_zx.cu` and
`csrc/sparse_sdca_zx_block.cu`, and their plain PyTorch versions.

`sparse_local_sdca` replaces the TPU kernels `repro/kernels/sparse_sdca.py::
_sparse_sdca_kernel` (buffer_depth 1) and `_sparse_sdca_pipelined_kernel`
(buffer_depth >= 2) with one kernel templated on its ring depth. The
depth is the TPU's VMEM double-buffering knob and changes no result, so on
the card the ring runs at least `D_CARD` deep where u stays in shared
memory (`ring_plan`). One call runs one round for all K workers: per row an
r_max gather-dot `sum_r prox(u[c_r]) * v_r` (prox only when `prox_kappa`
is set), `q = scale * sum_r v_r^2`, the closed-form update, then an r_max
scatter-axpy into raw u. Padding slots (col 0, val 0) are exact no-ops and
duplicate column ids in a row all land. With the prox fused the caller
passes w = v, so u lives in v-space; du = u - w = scale * A_[k] dalpha.
Every depth walks the same visit order and gives the same results. u sits
in shared memory where it fits beside the ring (`smem_budget`), else in
device memory: the kernel takes any width d whose ring fits. There each
lane's gathers of a row go out together (`device_u_walk(r_max)`: the
registers a lane gathers into, and two walk warps for rows past 128
slots).

`sparse_local_sdca_zx` replaces `_sparse_sdca_zx_kernel`: the z-exchange
schedule of a feature-sharded (data=K, model=M) mesh. Each invocation
walks one block of `block_rows` rows of the visit order against the
exchanged (model-summed) partial dots, with q from the global row norms,
then emits the next block's partial dots at the updated u. Three forms
(`zx_launch_plan`): on one card a round is one launch of K thread-block
clusters of M blocks where such a cluster fits (M <= 16); past that, one
cooperative launch of persistent blocks exchanging tagged partial dots
through device memory (the grid form, in the same source): K M blocks
where the card holds them all at once, else ceil(K / W) M blocks, each
walking W workers' shards in lockstep, for the smallest W of
`ZX_GRID_WORKERS` whose blocks the card holds; otherwise -- M past what
the card holds, a ring that does not fit, and every process mesh (each
rank one block, the exchange an all_reduce over its model column) -- one
launch per invocation of the per-block kernel, the reference's own
granularity, with the exchange between launches.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors. `LAUNCHES` counts the 1-D kernel's launches asked
at depth 1 (the counterpart of `_sparse_sdca_kernel`, whatever ring ran),
`PIPELINED_LAUNCHES` those asked at depth >= 2, `DEVICE_U_LAUNCHES` those
of either that held u in device memory, `LAST_RING_DEPTH` the ring the
last one ran (None on the CPU), `ZX_LAUNCHES` the cluster kernel's (one a
round: the round's invocations run inside it), `ZX_GRID_LAUNCHES` the
grid form's at one worker a block (one a round), `ZX_LOCKSTEP_LAUNCHES`
the grid form's at W > 1 workers a block (one a round),
`ZX_BLOCK_LAUNCHES` the per-block kernel's (one an invocation) and
`ZX_STEPS` the invocations of all of them. `LAST_ZX_FORM` names the form the last zx call ran ("plain"
on the CPU), `LAST_ZX_WORKERS` its workers a block (None on the CPU).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Mapping, Optional, Union

import torch

from ..core.losses import Loss
from ..core.regularizers import soft_threshold
from . import build
from .local_sdca import MAX_SMEM_BYTES, loss_code

LAUNCHES = 0                # csrc/sparse_sdca_pipelined.cu at depth 1
PIPELINED_LAUNCHES = 0      # the same kernel at depth >= 2
DEVICE_U_LAUNCHES = 0       # either, with u in device memory
ZX_LAUNCHES = 0             # csrc/sparse_sdca_zx.cu, one per round
ZX_GRID_LAUNCHES = 0        # its grid form at W = 1, one per round
ZX_LOCKSTEP_LAUNCHES = 0    # its grid form at W > 1, one per round
ZX_BLOCK_LAUNCHES = 0       # csrc/sparse_sdca_zx_block.cu, one per step
ZX_STEPS = 0                # the invocations (blocks of rows) they ran
MAX_DEPTH = 8               # ring stages the 1-D kernel is built for
# the ring the card runs at least, with u in shared memory: the fastest of
# rings 3-8 at rcv1's shape, 40.2 ms against ring 4's 43.8 (H100 at 700 W;
# PERF.md, the 1-D walk's ring sweep)
D_CARD = 8
LAST_RING_DEPTH = None      # the ring the last 1-D launch ran
STAGE_SCALARS = 8           # words of a 1-D ring stage after cols and vals
ZX_MAX_CLUSTER = 16         # with the non-portable cluster-size attribute
ZX_GRID_WORKERS = (1, 2, 3, 4)   # the grid form's instances: workers a block
# the device-u walk's instances, (walk warps, SLOTS), in the order the
# wrapper tries them: one warp up to 128 slots a row, two past that
DEVICE_U_WALKS = ((1, 4), (2, 8), (2, 16))
ZX_ID_SLOTS, ZX_SCALARS = 4, 5   # ID_SLOTS, SCALARS in the .cu
ZX_WARPS, ZX_XS_STRIDE = 8, 33   # NWARPS, XS_STRIDE in the .cu
ZX_RING_MAX = 4             # RING_MAX in the .cu: the cluster form's
                            # deepest ring of stages of B rows
LAST_ZX_FORM = None         # "cluster", "grid", "block" or "plain"
LAST_ZX_WORKERS = None      # the last zx launch's workers a block


def stage_row_words(r_max: int) -> int:
    """Words a 1-D ring stage gives one row's cols (and its vals): the row
    and up to 3 words before it, from its 16-byte chunk on, rounded up to
    16 bytes (`row_words` in csrc/sparse_sdca_pipelined.cu)."""
    return (r_max + 6) // 4 * 4


def device_u_walk(r_max: int) -> tuple:
    """(walk warps, SLOTS) of the 1-D walk with u in device memory: the
    first of `DEVICE_U_WALKS` whose warps' registers hold the row (one
    warp of 4 a lane up to 128 slots, two of 8 up to 512, two of 16 up
    to 1,024), else the last, whose batches then walk the rest
    (csrc/sparse_sdca_pipelined.cu, whose note gives the times that
    chose these instances)."""
    return next((w for w in DEVICE_U_WALKS if 32 * w[0] * w[1] >= r_max),
                DEVICE_U_WALKS[-1])


def zx_poll_rows(workers: int) -> int:
    """Rows of each worker a warp of the zx grid form polls at once
    (`zrows` in csrc/sparse_sdca_zx.cu): two, one past two workers a
    block, so a lane holds at most four words in flight."""
    return 2 if workers <= 2 else 1


def smem_budget(*, d: int, r_max: int, nk: Optional[int] = None,
                buffer_depth: int = 1, block_rows: int = 16,
                zx: bool = False, workers: int = 1,
                cluster: Optional[int] = None) -> dict:
    """Dynamic shared memory one block of the launch uses, in bytes (the
    counterpart of the reference's `vmem_budget`). The 1-D kernel (a walk
    warp and a fetch warp a worker, no reduction scratch) holds a ring of
    min(buffer_depth, nk) rows: cols and vals, each in a region of
    `stage_row_words(r_max)` words (the row's 16-byte chunks), then y,
    alpha, mask, dalpha, the row id and three spare words
    (`STAGE_SCALARS`), and the stage's two 8-byte mbarriers; and u (4 d)
    when that fits beside the ring, else u stays in device memory
    (`u_in_smem` False, `u_bytes` 0). `fits` is False only when the ring
    alone does not fit.

    The zx kernel (d = d_local, r_max = r_loc) holds its prefetch (ring)
    and u (4 d) when that fits beside the rest; else u stays in device
    memory (`u_in_smem` False, `u_bytes` 0). Its cluster form (`cluster`
    = M shards) holds a ring of stages of B rows, each row's cols and vals
    in `stage_row_words(r_loc)` words (its 16-byte chunks), then its five
    scalars and its id, each stage with two 8-byte mbarriers: as many
    stages as fit, `ZX_RING_MAX` down to 2, u in shared memory where it
    fits beside two (`zx_cluster_ring`); and the exchange's two buffers of
    B rows' M partials and their two mbarriers (scratch). Its grid form's
    block of `workers` workers (`cluster` None) holds, for each worker,
    two row stages of B rows' cols, vals and five scalars and four slots
    of B row ids (ring), the two z buffers and a coefficient per block row
    (scratch) beside them (u in shared memory only where all W copies
    fit) and, past one worker, each warp's staging rows of the exchange
    (`zx_poll_rows(workers)` rows a worker of `ZX_XS_STRIDE` floats:
    scratch)."""
    if zx and cluster is not None:
        B = block_rows
        scratch = 8 * B * cluster + 16
        depth, u_in_smem = zx_cluster_ring(d=d, r_max=r_max, block_rows=B,
                                           cluster=cluster)
        ring = depth * (4 * _zx_stage_words(B, r_max) + 16)
        u = 4 * d if u_in_smem else 0
    elif zx:
        B, W = block_rows, workers
        scratch = W * 4 * 3 * B + (
            4 * ZX_WARPS * W * zx_poll_rows(W) * ZX_XS_STRIDE if W > 1 else 0)
        ring = W * 4 * (ZX_ID_SLOTS * B
                        + 2 * (2 * B * r_max + ZX_SCALARS * B))
        u_in_smem = W * 4 * d + ring + scratch <= MAX_SMEM_BYTES
        u = W * 4 * d if u_in_smem else 0
    else:
        scratch = 0
        stages = min(buffer_depth, nk) if nk is not None else buffer_depth
        ring = stages * (4 * (2 * stage_row_words(r_max) + STAGE_SCALARS)
                         + 16)          # and two 8-byte mbarriers a stage
        u_in_smem = 4 * d + ring <= MAX_SMEM_BYTES
        u = 4 * d if u_in_smem else 0
    total = u + ring + scratch
    return dict(u_bytes=u, ring_bytes=ring, scratch_bytes=scratch,
                total_bytes=total, fits=total <= MAX_SMEM_BYTES,
                u_in_smem=u_in_smem)


def _zx_stage_words(B: int, r_loc: int) -> int:
    """Words of one stage of the zx cluster form's ring: B rows' cols and
    vals in `stage_row_words(r_loc)` words each, then their five scalars
    and ids, rounded up to 16 bytes (`ring_stage_words` in
    csrc/sparse_sdca_zx.cu)."""
    return (2 * B * stage_row_words(r_loc) + (ZX_SCALARS + 1) * B + 3) \
        // 4 * 4


def zx_cluster_ring(*, d: int, r_max: int, block_rows: int,
                    cluster: int) -> tuple:
    """(stages, u_in_smem) of the zx cluster form's block of `cluster` (M)
    shards -- shape arithmetic only: u in shared memory where it fits
    beside a ring of two stages, then the deepest ring of `ZX_RING_MAX`
    .. 2 stages that fits beside the rest (2 where none does; `fits` then
    says so). `cluster_ring` in csrc/sparse_sdca_zx.cu."""
    B, M = block_rows, cluster

    def total(depth, u_smem):
        return (depth * (4 * _zx_stage_words(B, r_max) + 16) + 8 * B * M
                + 16 + (4 * d if u_smem else 0))

    u_in_smem = total(2, True) <= MAX_SMEM_BYTES
    depth = next((k for k in range(ZX_RING_MAX, 2, -1)
                  if total(k, u_in_smem) <= MAX_SMEM_BYTES), 2)
    return depth, u_in_smem


def ring_plan(buffer_depth: int, *, nk: int, d: int, r_max: int) -> dict:
    """The ring the 1-D kernel runs on the card for an asked
    `buffer_depth` -- shape arithmetic only. Where u fits shared memory
    beside the asked ring (clamped to nk), the ring is max(buffer_depth,
    `D_CARD`), clamped to nk and `MAX_DEPTH`, and cut back to the deepest
    that still leaves u in shared memory; where it does not, u goes to
    device memory and the asked ring runs. Returns {"depth", "u_in_smem"}.
    Every depth gives the same results (see the kernel's note)."""
    asked = min(buffer_depth, nk)

    def fits(depth):
        return smem_budget(d=d, r_max=r_max, nk=nk,
                           buffer_depth=depth)["u_in_smem"]

    if not fits(asked):
        return dict(depth=asked, u_in_smem=False)
    want = min(max(buffer_depth, D_CARD), nk, MAX_DEPTH)
    depth = next(k for k in range(want, asked - 1, -1) if fits(k))
    return dict(depth=depth, u_in_smem=True)


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
    kernel with the ring `ring_plan` gives for buffer_depth (at least
    `D_CARD` rows where u stays in shared memory, never past nk: see the
    kernel's source note); on CPU tensors `sparse_local_sdca_plain`,
    whatever the depth.

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
    global LAST_RING_DEPTH
    if vals.device.type == "cpu":
        LAST_RING_DEPTH = None
        return sparse_local_sdca_plain(cols, vals, y, alpha, mask, w, scale,
                                       perm, loss=loss, n_passes=n_passes,
                                       prox_kappa=prox_kappa)
    if vals.device.type != "cuda":
        raise ValueError(f"sparse_local_sdca runs on cuda or cpu, got "
                         f"{vals.device}")
    _require(vals.device, vals=vals, y=y, alpha=alpha, mask=mask, w=w,
             cols=cols, perm=perm)
    plan = ring_plan(buffer_depth, nk=nk, d=d, r_max=r_max)
    depth = plan["depth"]
    budget = smem_budget(d=d, r_max=r_max, nk=nk, buffer_depth=depth)
    _enforce_smem(budget, "sparse_local_sdca")
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=vals.device)
    # with u in device memory the kernel keeps u in du and leaves u - w
    du = torch.empty((K, d), dtype=torch.float32, device=vals.device)
    lib = build.load("sparse_sdca_pipelined")
    code = lib.sparse_sdca_pipelined_launch(
        cols.data_ptr(), vals.data_ptr(), y.data_ptr(), alpha.data_ptr(),
        mask.data_ptr(), w.data_ptr(), perm.data_ptr(), dalpha.data_ptr(),
        du.data_ptr(), K, nk, r_max, d, int(n_passes), float(scale), lid, g,
        int(prox_kappa is not None),
        float(prox_kappa) if prox_kappa is not None else 0.0,
        depth, int(budget["u_in_smem"]),
        *((4, 1) if budget["u_in_smem"] else device_u_walk(r_max)[::-1]),
        torch.cuda.current_stream(vals.device).cuda_stream)
    build.check(lib, "sparse_sdca_pipelined", code)
    global LAUNCHES, PIPELINED_LAUNCHES, DEVICE_U_LAUNCHES
    LAST_RING_DEPTH = depth
    # keyed on the TPU kernel asked for: the ring never reaches past nk
    if min(buffer_depth, nk) == 1:
        LAUNCHES += 1
    else:
        PIPELINED_LAUNCHES += 1
    if not budget["u_in_smem"]:
        DEVICE_U_LAUNCHES += 1
    return dalpha, du


# ----------------------------------------------------------------------------
# the z-exchange schedule (feature-sharded, M model shards per worker)
# ----------------------------------------------------------------------------

def zx_exchanges(nk: int, block_rows: int, n_passes: int = 1) -> int:
    """Model-axis exchanges of `block_rows` floats one zx round performs:
    one per scheduled block (ceil(nk / block_rows) blocks a pass) plus the
    prologue priming block 0 at u = w."""
    return n_passes * (-(-nk // block_rows)) + 1


def zx_block_smem_bytes(B: int) -> int:
    """Dynamic shared memory of a per-block kernel's block: a coefficient
    and a row id per block row (`smem_bytes` in csrc/sparse_sdca_zx_block.cu)."""
    return 8 * B


def zx_launch_plan(K: int, M: int, nk: int, d_loc: int, B: int, *,
                   r_loc: int, n_passes: int = 1, cluster: bool = True,
                   resident: Union[int, Mapping[int, int]] = 0) -> dict:
    """How a zx round runs on the card -- shape arithmetic only; what the
    card holds comes in as arguments. `form` "cluster": one launch
    (`launches` 1) of K thread-block clusters of `cluster` (M) blocks,
    `steps` invocations inside it, with `u_in_smem`, `smem_bytes` and
    `fits` from `smem_budget(zx=True, cluster=M)`; taken for M <= 16
    unless `cluster` is False (a cluster the card cannot hold, or a
    process mesh). `form`
    "grid": one cooperative launch (`cluster` 1) of `groups` (K' =
    ceil(K / W)) groups of M blocks, each block walking `workers_per_block`
    (W) workers' shards in lockstep, with the shared memory of
    `smem_budget(zx=True, workers=W)`; taken otherwise for the smallest W
    of `ZX_GRID_WORKERS` whose block fits shared memory and whose K' M
    blocks are `resident`: the blocks of W's instance the card holds at
    once (from `_zx_grid_resident`), a {W: blocks} mapping or one count
    for every W (0, the default, on a process mesh). W = 1 wherever all K M
    blocks are resident. `form` "block": one launch of the per-block
    kernel per invocation (`launches` = `steps`), u in device memory;
    taken where none fits. Raises ValueError only for M < 1."""
    if M < 1:
        raise ValueError(f"the zx round needs M >= 1 model shards, got {M}")
    steps = n_passes * (-(-nk // B))
    budget = smem_budget(d=d_loc, r_max=r_loc, block_rows=B, zx=True,
                         cluster=M)
    if budget["fits"] and cluster and M <= ZX_MAX_CLUSTER:
        return dict(form="cluster", launches=1, cluster=M, steps=steps,
                    u_in_smem=budget["u_in_smem"],
                    smem_bytes=budget["total_bytes"], fits=True)
    for W in ZX_GRID_WORKERS:
        held = resident.get(W, 0) if isinstance(resident, Mapping) \
            else resident
        grid = smem_budget(d=d_loc, r_max=r_loc, block_rows=B, zx=True,
                           workers=W)
        groups = -(-K // W)
        if grid["fits"] and groups * M <= held:
            return dict(form="grid", launches=1, cluster=1, steps=steps,
                        u_in_smem=grid["u_in_smem"],
                        smem_bytes=grid["total_bytes"], fits=True,
                        workers_per_block=W, groups=groups)
    smem = zx_block_smem_bytes(B)
    return dict(form="block", launches=steps, cluster=1, steps=steps,
                u_in_smem=False, smem_bytes=smem,
                fits=smem <= MAX_SMEM_BYTES)


def _zx_clusters_fit(lib, M: int, B: int, r_loc: int, d_loc: int,
                     u_in_smem: bool) -> int:
    """cudaOccupancyMaxActiveClusters of the instance: how many clusters
    of M blocks the card holds at once (0: a cluster does not fit)."""
    out = ctypes.c_int(0)
    code = lib.sparse_sdca_zx_max_clusters(M, B, r_loc, d_loc,
                                           int(u_in_smem), ctypes.byref(out))
    build.check(lib, "sparse_sdca_zx", code)
    return out.value


def _zx_grid_resident(lib, B: int, r_loc: int, d_loc: int,
                      u_in_smem: bool, workers: int = 1) -> int:
    """How many blocks of the grid form's instance of `workers` workers a
    block the card holds at once (its blocks an SM,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs; 0 where
    it takes no cooperative launch): the grid form needs ceil(K / workers)
    M of them."""
    out = ctypes.c_int(0)
    code = lib.sparse_sdca_zx_grid_resident(B, r_loc, d_loc, int(u_in_smem),
                                            int(workers), ctypes.byref(out))
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
                               prox_kappa: Optional[float] = None,
                               model_sum: Optional[Callable] = None):
    """Plain PyTorch version: replays the reference's scan
    (`sparse_local_sdca_zx` at repro/kernels/sparse_sdca.py:476) for all
    (k, m) at once, as the per-block host loop (`zx_block_loop`) over
    `zx_block_step_plain`. The rows of a block update together against the
    block's exchanged z; their scatter_add_ lands row after row, slot after
    slot, as the reference's walk does. `model_sum` is the exchange of a
    process mesh's rank block (K = M = 1, `sparse_local_sdca_zx`); None:
    each invocation sums the M partials the previous one left."""
    loss_code(loss)
    K, M, nk, r_loc, d_loc = _check_zx_shapes(cols, vals, y, alpha, mask, w,
                                              sqnorms, perm)
    B = int(block_rows)
    w3 = w.float().reshape(1, M, d_loc)
    u = w3.expand(K, M, d_loc).clone()
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=vals.device)
    perm = perm.long()
    z0 = zx_partial_dots(cols, vals, u, _block_rows_of(perm, nk, B, 0),
                         prox_kappa)
    zx_block_loop(
        lambda g, zin, want: zx_block_step_plain(
            cols, vals, y, alpha, mask, sqnorms, perm, u, dalpha, zin, g,
            scale, loss=loss, block_rows=B, prox_kappa=prox_kappa,
            want_next=want),
        (lambda z: z) if model_sum is None else model_sum, z0,
        n_passes * -(-nk // B))
    return dalpha, (u - w3).reshape(K, M * d_loc)


def zx_block_step_plain(cols, vals, y, alpha, mask, sqnorms, perm, u,
                        dalpha, zin, step: int, scale, *, loss: Loss,
                        block_rows: int,
                        prox_kappa: Optional[float] = None,
                        want_next: bool = True):
    """Plain version of one per-block launch: invocation `step` for every
    (k, m) block. zin (K, Min, >= R) holds the exchanged z of block
    step % nb (Min partials summed here in rank order, or one already
    summed); u (K, M, d_loc) and dalpha (K, nk) are updated in place.
    Returns the next block's partial dots (K, M, R') at the updated u, or
    None when not `want_next`."""
    K, M, nk, r_loc = cols.shape
    B = int(block_rows)
    nb = -(-nk // B)
    rows = _block_rows_of(perm, nk, B, step % nb)
    R = rows.shape[1]
    z_ex = zin[:, 0, :R]
    for m in range(1, zin.shape[1]):          # the psum, in a fixed order
        z_ex = z_ex + zin[:, m, :R]
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
    if not want_next:
        return None
    return zx_partial_dots(cols, vals, u,
                           _block_rows_of(perm, nk, B, (step + 1) % nb),
                           prox_kappa)


def zx_block_loop(step, exchange, z0, n_steps: int) -> None:
    """The per-block round's host loop: `z = exchange(z0)`, then for each
    invocation g < n_steps `z = exchange(step(g, z, g + 1 < n_steps))`
    (the last invocation's next dots are not needed). `step(g, zin,
    want_next)` runs one invocation (a launch, or `zx_block_step_plain`)
    and returns its partial dots; `exchange` sums them over the model
    shards (a process mesh's all_reduce over the model column), or passes
    them on for the next invocation to sum. That is n_steps exchanges,
    one fewer than `zx_exchanges` counts: the reference's scan also
    exchanges the last invocation's dots, which nothing reads."""
    z = exchange(z0)
    for g in range(n_steps):
        zn = step(g, z, g + 1 < n_steps)
        if zn is not None:
            z = exchange(zn)


def sparse_local_sdca_zx(cols, vals, y, alpha, mask, w, scale, sqnorms,
                         perm, *, loss: Loss, n_passes: int = 1,
                         block_rows: int = 16,
                         prox_kappa: Optional[float] = None,
                         model_sum: Optional[Callable] = None):
    """One round of the z-exchange schedule for all K workers and M model
    shards: on CUDA tensors the form `zx_launch_plan` picks from the
    shapes and the card's occupancy queries, before anything launches --
    one launch of the cluster kernel, one cooperative launch of its grid
    form (W workers a block, `zx_launch_plan`), or one launch of the
    per-block kernel per invocation (a launch
    the card refuses raises; no form stands in for another) -- on CPU
    tensors the plain version (any M).

    cols/vals (K, M, nk, r_loc) with shard-local ids (a `FeatureShards`);
    y, alpha, mask (K, nk) f32; w the padded (M d_local,) f32 vector;
    sqnorms (K, nk) the global row norms; perm (K, nk) int32, the visit
    order every shard of worker k walks. Returns (dalpha (K, nk),
    du (K, M d_local)).

    `model_sum` set: a process mesh's rank block (K = M = 1 here, its
    shard-local slice), and `model_sum` the sum over its model column
    (`comm.Topology.model_sum`), called on the prologue's partial dots and
    after every invocation; the per-block kernel runs (its plain version
    on the CPU) between the calls."""
    lid, g = loss_code(loss)
    K, M, nk, r_loc, d_loc = _check_zx_shapes(cols, vals, y, alpha, mask, w,
                                              sqnorms, perm)
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    dev = vals.device
    if model_sum is not None and (K, M) != (1, 1):
        raise ValueError(f"a process mesh's rank holds one block, K = M = "
                         f"1, got K={K}, M={M}")
    global LAST_ZX_FORM, LAST_ZX_WORKERS
    if dev.type == "cpu":
        LAST_ZX_FORM, LAST_ZX_WORKERS = "plain", None
        return sparse_local_sdca_zx_plain(
            cols, vals, y, alpha, mask, w, scale, sqnorms, perm, loss=loss,
            n_passes=n_passes, block_rows=block_rows, prox_kappa=prox_kappa,
            model_sum=model_sum)
    if dev.type != "cuda":
        raise ValueError(f"sparse_local_sdca_zx runs on cuda or cpu, got "
                         f"{dev}")
    _require(dev, vals=vals, y=y, alpha=alpha, mask=mask, w=w,
             sqnorms=sqnorms, cols=cols, perm=perm)
    B = int(block_rows)
    w3 = w.reshape(1, M, d_loc)
    # a copy even at K = 1, where the expanded view is w itself: the
    # kernels update u in place
    u = w3.expand(K, M, d_loc).clone()
    z0 = torch.zeros((K, M, B), dtype=torch.float32, device=dev)
    z0[:, :, :min(B, nk)] = zx_partial_dots(
        cols, vals, u, _block_rows_of(perm, nk, B, 0), prox_kappa)
    if model_sum is not None:
        dalpha = _zx_rank_round(cols, vals, y, alpha, mask, sqnorms, perm, u,
                                z0, model_sum, B, int(n_passes), scale, loss,
                                prox_kappa)
        LAST_ZX_FORM, LAST_ZX_WORKERS = "block", 1
        return dalpha, (u - w3).reshape(K, M * d_loc)
    # what the card holds: clusters of M blocks, else blocks of each grid
    # instance whose shared memory fits
    budget = smem_budget(d=d_loc, r_max=r_loc, block_rows=B, zx=True,
                         cluster=M)
    lib = build.load("sparse_sdca_zx")
    clusters, resident = 0, {}
    if budget["fits"] and M <= ZX_MAX_CLUSTER:
        clusters = _zx_clusters_fit(lib, M, B, r_loc, d_loc,
                                    budget["u_in_smem"])
    if clusters < 1:
        for W in ZX_GRID_WORKERS:
            grid = smem_budget(d=d_loc, r_max=r_loc, block_rows=B, zx=True,
                               workers=W)
            if grid["fits"]:
                resident[W] = _zx_grid_resident(lib, B, r_loc, d_loc,
                                                grid["u_in_smem"], W)
    plan = zx_launch_plan(K, M, nk, d_loc, B, r_loc=r_loc,
                          n_passes=int(n_passes), cluster=clusters >= 1,
                          resident=resident)
    _fits(plan, B)
    dalpha = torch.zeros((K, M, nk), dtype=torch.float32, device=dev)
    kappa = (int(prox_kappa is not None),
             float(prox_kappa) if prox_kappa is not None else 0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    global ZX_LAUNCHES, ZX_GRID_LAUNCHES, ZX_LOCKSTEP_LAUNCHES, \
        ZX_BLOCK_LAUNCHES, ZX_STEPS
    if plan["form"] == "cluster":
        code = lib.sparse_sdca_zx_launch(
            cols.data_ptr(), vals.data_ptr(), y.data_ptr(),
            alpha.data_ptr(), mask.data_ptr(), sqnorms.data_ptr(),
            perm.data_ptr(), u.data_ptr(), dalpha.data_ptr(),
            z0.data_ptr(), K, M, nk, r_loc, d_loc, B, int(n_passes),
            float(scale), lid, g, *kappa, int(plan["u_in_smem"]), stream)
        build.check(lib, "sparse_sdca_zx", code)
        ZX_LAUNCHES += 1
    elif plan["form"] == "grid":
        # the exchange's tagged words, (2, K, B, M): a row's M partials
        # side by side, the float's bits beside step 0's tag 0
        z = torch.zeros((2, K, B, M), dtype=torch.int64, device=dev)
        z[0] = (z0.view(torch.int32).to(torch.int64)
                & 0xFFFFFFFF).transpose(1, 2)
        W = plan["workers_per_block"]
        code = lib.sparse_sdca_zx_grid_launch(
            cols.data_ptr(), vals.data_ptr(), y.data_ptr(),
            alpha.data_ptr(), mask.data_ptr(), sqnorms.data_ptr(),
            perm.data_ptr(), u.data_ptr(), dalpha.data_ptr(), z.data_ptr(),
            K, M, nk, r_loc, d_loc, B, int(n_passes), float(scale), lid, g,
            *kappa, int(plan["u_in_smem"]), W, stream)
        build.check(lib, "sparse_sdca_zx", code)
        if W == 1:
            ZX_GRID_LAUNCHES += 1
        else:
            ZX_LOCKSTEP_LAUNCHES += 1
    else:
        lib = build.load("sparse_sdca_zx_block")
        z = torch.stack([z0, torch.zeros_like(z0)])
        code = lib.sparse_sdca_zx_block_round(
            cols.data_ptr(), vals.data_ptr(), y.data_ptr(),
            alpha.data_ptr(), mask.data_ptr(), sqnorms.data_ptr(),
            perm.data_ptr(), u.data_ptr(), dalpha.data_ptr(), z.data_ptr(),
            K, M, nk, r_loc, d_loc, B, plan["steps"], float(scale), lid, g,
            *kappa, stream)
        build.check(lib, "sparse_sdca_zx_block", code)
        ZX_BLOCK_LAUNCHES += plan["launches"]
    ZX_STEPS += plan["steps"]
    LAST_ZX_FORM = plan["form"]
    LAST_ZX_WORKERS = plan.get("workers_per_block", 1)
    return dalpha[:, 0].contiguous(), (u - w3).reshape(K, M * d_loc)


def _fits(plan: dict, B: int) -> None:
    if not plan["fits"]:
        raise ValueError(
            f"sparse_local_sdca_zx: needs {plan['smem_bytes']} bytes of "
            f"shared memory per block for B = {B} rows; the limit is "
            f"{MAX_SMEM_BYTES} bytes")


def _zx_rank_round(cols, vals, y, alpha, mask, sqnorms, perm, u, z0,
                   model_sum, B, n_passes, scale, loss, prox_kappa):
    """A process mesh rank's zx round on the card (K = M = 1):
    `zx_block_loop` with the per-block kernel and `model_sum` as the
    exchange. Updates u; returns dalpha (1, nk)."""
    _, _, nk, r_loc = cols.shape
    d_loc = u.shape[-1]
    n_steps = n_passes * (-(-nk // B))
    plan = zx_launch_plan(1, 1, nk, d_loc, B, r_loc=r_loc,
                          n_passes=n_passes, cluster=False)
    _fits(plan, B)
    lib = build.load("sparse_sdca_zx_block")
    lid, g = loss_code(loss)
    kappa = (int(prox_kappa is not None),
             float(prox_kappa) if prox_kappa is not None else 0.0)
    dalpha = torch.zeros((1, 1, nk), dtype=torch.float32, device=u.device)
    # two output buffers in turn: an exchange that hands its input back
    # must not make a launch's zin its own zout
    zouts = (torch.zeros_like(z0), torch.zeros_like(z0))
    ptrs = (cols.data_ptr(), vals.data_ptr(), y.data_ptr(),
            alpha.data_ptr(), mask.data_ptr(), sqnorms.data_ptr(),
            perm.data_ptr(), u.data_ptr(), dalpha.data_ptr())
    stream = torch.cuda.current_stream(u.device).cuda_stream

    def step(gi, zin, want):
        global ZX_BLOCK_LAUNCHES, ZX_STEPS
        zin, zout = zin.contiguous(), zouts[gi % 2]
        code = lib.sparse_sdca_zx_block_launch(
            *ptrs, zin.data_ptr(), zout.data_ptr(), 1, 1, 1, nk, r_loc,
            d_loc, B, gi, int(want), float(scale), lid, g, *kappa, stream)
        build.check(lib, "sparse_sdca_zx_block", code)
        ZX_BLOCK_LAUNCHES += 1
        ZX_STEPS += 1
        return zout if want else None

    zx_block_loop(step, model_sum, z0, n_steps)
    return dalpha[:, 0]
