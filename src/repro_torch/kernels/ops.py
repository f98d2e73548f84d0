"""The kernels as CoCoA+ local solvers (`repro.kernels.ops` counterpart).

Each block solver does what the reference's wrapper does around its
pallas_call, minus the padding and the permuted copy: the kernel reads row
perm[k, j] in place and writes dalpha at the original row index.

  * hoist the conjugate map w0 = grad g*(tau v) to once per round (dense,
    and sparse without a fused prox),
  * take scale = sigma'/(tau n),
  * map H onto whole passes, n_passes = max(1, int(round(H / nk))) with
    Python's round, as the reference does,
  * take the per-worker visit permutation as an explicit (K, nk) input.

The sparse solver resolves its launch configuration as the reference's does
(explicit > the autotune cache > default, `kernels.autotune`) and records
the launch that ran in `LAST_SPARSE_CONFIG`. On feature-sharded shards (a
`FeatureShards`, M model shards per worker) it runs the z-exchange
schedule; its wire plan is `sparse_zx_plan`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..comm.placement import WSpec
from ..comm.tracer import model_hops
from ..core.losses import Loss
from ..core.regularizers import L2, Regularizer
from ..core.solvers import SDCAResult
from .autotune import resolve_sparse_config
from .local_sdca import local_sdca
from .sparse_sdca import sparse_local_sdca, sparse_local_sdca_zx, \
    zx_exchanges

# The launch the sparse dispatch last ran: {"block_rows", "buffer_depth",
# "source", "clamped", "model_shards", "prox_fused", "zx"} (the reference's
# keys but its TPU-only "slot_unroll"). block_rows is the value after the
# clamp to the shard (what the zx schedule ran with; the 1-D kernel walks
# row by row and only records it); buffer_depth is the ring the 1-D kernel
# ran with, after its clamp to nk.
LAST_SPARSE_CONFIG = None


def n_passes_of(H: int, nk: int) -> int:
    return max(1, int(round(H / max(nk, 1))))


def perm_i32(perm: torch.Tensor, nk: int,
             device: torch.device) -> torch.Tensor:
    """The visit permutation as the kernels take it: contiguous int32 on
    `device`. A perm that is still on the host is range-checked here, before
    the copy -- the kernels index with it unchecked, and checking it on the
    card would cost a sync every launch."""
    if perm.device.type == "cpu" and perm.numel() and (
            int(perm.min()) < 0 or int(perm.max()) >= nk):
        raise ValueError(f"perm entries must lie in [0, {nk})")
    return perm.to(device=device, dtype=torch.int32).contiguous()


def local_sdca_block(X, y, alpha, mask, v, perm, loss: Loss, lam: float, n,
                     sigma_p: float, H: int,
                     reg: Regularizer = L2) -> SDCAResult:
    """Drop-in solver: permutation-epoch SDCA through the dense kernel, for
    all K workers in one launch. The conjugate map is hoisted outside the
    kernel (the exact subproblem under L2, the linearized one otherwise)."""
    w0 = reg.conj_grad(v, lam).float().contiguous()
    K, nk, _ = X.shape
    n_passes = n_passes_of(H, nk)
    scale = sigma_p / (reg.tau(lam) * float(n))
    dalpha, du = local_sdca(X, y, alpha, mask, w0, scale,
                            perm_i32(perm, nk, X.device), loss=loss,
                            n_passes=n_passes)
    return SDCAResult(dalpha, du, n_passes * nk)


def prox_kappa_of(reg: Regularizer, lam: float) -> Optional[float]:
    """The fused-prox threshold for `reg`, or None for the hoisted map.
    kappa = 0 (L2) is not fused: the identity needs no work."""
    if reg.prox_kappa is None:
        return None
    kappa = float(reg.prox_kappa(lam))
    return kappa if kappa != 0.0 else None


def sparse_local_sdca_block(shard, y, alpha, mask, v, perm, loss: Loss,
                            lam: float, n, sigma_p: float, H: int,
                            *, block_rows: Optional[int] = None,
                            buffer_depth: Optional[int] = None,
                            model_axis: Optional[str] = None,
                            sqnorms: Optional[torch.Tensor] = None,
                            zx: Optional[bool] = None,
                            reg: Regularizer = L2) -> SDCAResult:
    """Drop-in solver: permutation-epoch SDCA over padded-ELL shards, all K
    workers in one launch. A scalar soft-threshold regularizer is fused
    into the kernel's gather (u stays in v-space, w = v); L2 and maps
    without `prox_kappa` keep the hoisted round-level map.

    `shard` is a `SparseShards` (cols (K, nk, r_max)) or a `FeatureShards`
    (cols (K, M, nk, r_loc), shard-local ids, v the padded (M d_local,)
    vector). `model_axis` set runs the z-exchange schedule over the M
    shards, with `sqnorms` (K, nk) the global row norms (summed over the
    shards here when not given); `zx=True` forces that schedule at M = 1,
    and `zx=False` with a model axis is refused, as in the reference. The
    launch knobs are resolved by `autotune.resolve_sparse_config`."""
    cols, vals = shard.cols, shard.vals
    sharded = cols.dim() == 4
    M = cols.shape[1] if sharded else 1
    use_zx = (model_axis is not None) if zx is None else zx
    if model_axis is not None and not use_zx:
        raise ValueError(
            "sparse_local_sdca_block: model_axis set but zx=False -- the "
            "kernel's only feature-sharded schedule is the z-exchange; "
            "use the eager 'sdca_sparse' solver to opt out")
    if M > 1 and not use_zx:
        raise ValueError("sparse_local_sdca_block: FeatureShards with M > 1 "
                         "need the z-exchange schedule (model_axis=...)")
    if sharded:
        K, _, nk, r_max = cols.shape
    else:
        K, nk, r_max = cols.shape
    d = v.shape[0] // M
    kappa = prox_kappa_of(reg, lam)
    cfg = resolve_sparse_config(d=d, r_max=r_max, block_rows=block_rows,
                                buffer_depth=buffer_depth,
                                backend=vals.device.type,
                                reg_family=reg.family,
                                model_shards=M if use_zx else 1)
    br = min(cfg["block_rows"], max(8, nk))
    depth = cfg["buffer_depth"]
    global LAST_SPARSE_CONFIG
    LAST_SPARSE_CONFIG = {**cfg, "block_rows": br,
                          "buffer_depth": depth if use_zx or depth == 1
                          else min(depth, nk),
                          "clamped": br != cfg["block_rows"],
                          "model_shards": M, "prox_fused": kappa is not None,
                          "zx": use_zx}
    w_in = (v if kappa is not None else reg.conj_grad(v, lam)
            ).float().contiguous()
    n_passes = n_passes_of(H, nk)
    scale = sigma_p / (reg.tau(lam) * float(n))
    order = perm_i32(perm, nk, vals.device)
    if use_zx:
        if not sharded:
            cols, vals = cols[:, None], vals[:, None]
        if sqnorms is None:       # exact at M = 1: the local norms
            sqnorms = torch.sum(vals * vals, dim=(1, 3))
        dalpha, du = sparse_local_sdca_zx(
            cols, vals, y, alpha, mask, w_in, scale,
            sqnorms.float().contiguous(), order, loss=loss,
            n_passes=n_passes, block_rows=br, prox_kappa=kappa)
    else:
        if sharded:
            cols, vals = cols[:, 0], vals[:, 0]
        dalpha, du = sparse_local_sdca(
            cols, vals, y, alpha, mask, w_in, scale, order, loss=loss,
            n_passes=n_passes, prox_kappa=kappa, buffer_depth=depth)
    return SDCAResult(dalpha, du, n_passes * nk)


def sparse_zx_plan(nk: int, d: int, H: int, *, r_max: int,
                   block_rows: Optional[int] = None,
                   reg_family: str = "l2", model_shards: int = 1,
                   backend: str = "cuda") -> dict:
    """The z-exchange wire plan the dispatch above launches with -- shape
    arithmetic only (resolve, clamp): `exchanges` exchanges of `block_rows`
    floats per round per shard. `d` is the local width d_local; `backend`
    the device type."""
    cfg = resolve_sparse_config(d=d, r_max=r_max, block_rows=block_rows,
                                buffer_depth=1, backend=backend,
                                reg_family=reg_family,
                                model_shards=model_shards)
    br = min(cfg["block_rows"], max(8, nk))
    n_passes = n_passes_of(H, nk)
    nb = -(-nk // br)
    return dict(block_rows=br, n_passes=n_passes, blocks=nb,
                exchanges=zx_exchanges(nk, br, n_passes))


def sparse_zx_model_hops(X, H: int, reg: Regularizer = L2) -> tuple:
    """The z-exchange schedule's model-axis wire plan on the
    `FeatureShards` X: every (worker, shard) sends `exchanges` partial-dot
    vectors of `block_rows` floats (`LocalSolver.model_hop` of
    `sdca_sparse_kernel`)."""
    K, M, nk, r_loc = X.cols.shape
    plan = sparse_zx_plan(nk, X.d_local, H, r_max=r_loc,
                          reg_family=reg.family, model_shards=M,
                          backend=X.cols.device.type)
    return model_hops(WSpec(X.d, M, "model"), K, H, zx_plan=plan)
