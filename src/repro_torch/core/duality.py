"""Primal/dual objectives, the alpha -> v map and the duality-gap certificate.

Port of `repro.core.duality`. X is a dense (K, nk, d) tensor, a
`data.sparse.SparseShards`, or a `FeatureShards` with w and v the padded
(M d_local,) vectors (the padded coordinates carry no data, stay exactly
zero and add nothing to P or D); labels, duals and the {0,1} row mask are
(K, nk). Every objective takes the global effective n (the mask's sum), so
padded partitions reproduce the unpadded math exactly.

    P(w)     = (1/n) sum_i l_i(x_i^T w) + g(w)
    D(alpha) = -(1/n) sum_i l_i*(-alpha_i) - g*(tau v),  v = A alpha/(tau n)

with the primal recovered through w = grad g*(tau v) (`Regularizer.conj_grad`,
the identity under L2).

The per-row terms are float32, as in the reference, but P and D are summed
and returned in float64: near the optimum both sit close together (about
0.93 at rcv1's shape), so a float32 P - D cannot resolve a gap below ~1e-7,
and at 677k rows one round already gets there.
"""
from __future__ import annotations

import torch

from ..data import sparse as sparse_data
from ..data.sparse import FeatureShards, SparseShards

_SPARSE = (SparseShards, FeatureShards)
from .losses import Loss
from .regularizers import L2, Regularizer


def effective_n(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask)


def _Atw(X, w: torch.Tensor) -> torch.Tensor:
    """Per-row predictions z = A^T w, shape (K, nk)."""
    if isinstance(X, _SPARSE):
        return sparse_data.matvec(X, w)
    return torch.einsum("kid,d->ki", X, w)


def v_of_alpha(X, alpha: torch.Tensor, lam: float, n,
               reg: Regularizer = L2) -> torch.Tensor:
    """v(alpha) = A alpha / (tau n); the paper's w(alpha) under L2."""
    tau = reg.tau(lam)
    if isinstance(X, _SPARSE):
        return sparse_data.rmatvec(X, alpha) / (tau * n)
    return torch.einsum("kid,ki->d", X, alpha) / (tau * n)


def primal(w: torch.Tensor, X, y: torch.Tensor, mask: torch.Tensor,
           loss: Loss, lam: float, reg: Regularizer = L2) -> torch.Tensor:
    n = effective_n(mask)
    z = _Atw(X, w)
    vals = loss.value(z, y) * mask
    return (torch.sum(vals, dtype=torch.float64) / n
            + reg.value(w.double(), lam))


def dual_at_v(v: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor, loss: Loss, lam: float,
              reg: Regularizer = L2) -> torch.Tensor:
    """D(alpha) evaluated at a precomputed v = v_of_alpha(...)."""
    n = effective_n(mask)
    conj = loss.conj(alpha, y) * mask
    return (-torch.sum(conj, dtype=torch.float64) / n
            - reg.conj(v.double(), lam))


def gap_decomposed(alpha, X, y, mask, loss, lam, reg: Regularizer = L2):
    """(P, D, gap) sharing the one v(alpha) rmatvec between both sides."""
    n = effective_n(mask)
    v = v_of_alpha(X, alpha, lam, n, reg)
    w = reg.conj_grad(v, lam)
    p = primal(w, X, y, mask, loss, lam, reg)
    d = dual_at_v(v, alpha, y, mask, loss, lam, reg)
    return p, d, p - d


def gap_at_v(v, alpha, X, y, mask, loss, lam, reg: Regularizer = L2):
    """(P(w), D(alpha), gap) for a carried v-space iterate: certifies the
    primal point w = grad g*(tau v) the run serves."""
    w = reg.conj_grad(v, lam)
    p = primal(w, X, y, mask, loss, lam, reg)
    n = effective_n(mask)
    d = dual_at_v(v_of_alpha(X, alpha, lam, n, reg), alpha, y, mask, loss,
                  lam, reg)
    return p, d, p - d
