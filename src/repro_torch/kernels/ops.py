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
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.losses import Loss
from ..core.regularizers import L2, Regularizer
from ..core.solvers import SDCAResult
from .local_sdca import local_sdca
from .sparse_sdca import sparse_local_sdca


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
                            reg: Regularizer = L2) -> SDCAResult:
    """Drop-in solver: permutation-epoch SDCA over padded-ELL shards, all K
    workers in one launch. A scalar soft-threshold regularizer is fused
    into the kernel's gather (u stays in v-space, w = v); L2 and maps
    without `prox_kappa` keep the hoisted round-level map."""
    kappa = prox_kappa_of(reg, lam)
    w_in = v if kappa is not None else reg.conj_grad(v, lam)
    K, nk, _ = shard.cols.shape
    n_passes = n_passes_of(H, nk)
    scale = sigma_p / (reg.tau(lam) * float(n))
    dalpha, du = sparse_local_sdca(
        shard.cols, shard.vals, y, alpha, mask, w_in.float().contiguous(),
        scale, perm_i32(perm, nk, shard.vals.device), loss=loss,
        n_passes=n_passes, prox_kappa=kappa)
    return SDCAResult(dalpha, du, n_passes * nk)
