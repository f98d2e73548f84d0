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

from .losses import Loss
from .regularizers import L2, Regularizer

_SPARSE = (SparseShards, FeatureShards)


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


def w_of_alpha(X, alpha: torch.Tensor, lam: float, n,
               reg: Regularizer = L2) -> torch.Tensor:
    """w(alpha) = grad g*(tau v(alpha)) -- eq. 3 through the conjugate map
    (the identity under L2)."""
    return reg.conj_grad(v_of_alpha(X, alpha, lam, n, reg), lam)


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


def dual(alpha: torch.Tensor, X, y: torch.Tensor, mask: torch.Tensor,
         loss: Loss, lam: float, reg: Regularizer = L2) -> torch.Tensor:
    n = effective_n(mask)
    v = v_of_alpha(X, alpha, lam, n, reg)
    return dual_at_v(v, alpha, y, mask, loss, lam, reg)


def duality_gap(alpha, X, y, mask, loss: Loss, lam: float,
                reg: Regularizer = L2) -> torch.Tensor:
    """G(alpha) = P(w(alpha)) - D(alpha) (eq. 4); >= 0 by weak duality."""
    return gap_decomposed(alpha, X, y, mask, loss, lam, reg)[2]


def gap_decomposed(alpha, X, y, mask, loss, lam, reg: Regularizer = L2):
    """(P, D, gap) sharing the one v(alpha) rmatvec between both sides."""
    n = effective_n(mask)
    v = v_of_alpha(X, alpha, lam, n, reg)
    w = reg.conj_grad(v, lam)
    p = primal(w, X, y, mask, loss, lam, reg)
    d = dual_at_v(v, alpha, y, mask, loss, lam, reg)
    return p, d, p - d


def gap_at_w(w, alpha, X, y, mask, loss, lam, reg: Regularizer = L2):
    """(P(w), D(alpha), P(w) - D(alpha)) for any primal iterate w. Under
    compressed communication the carried v drifts from v(alpha); weak
    duality still gives P(w) >= D(alpha) for every w, so certifying the w
    the run serves stays a valid gap certificate."""
    p = primal(w, X, y, mask, loss, lam, reg)
    d = dual(alpha, X, y, mask, loss, lam, reg)
    return p, d, p - d


def gap_at_v(v, alpha, X, y, mask, loss, lam, reg: Regularizer = L2):
    """`gap_at_w` for a carried v-space iterate: certifies the primal
    point w = grad g*(tau v) the run serves."""
    return gap_at_w(reg.conj_grad(v, lam), alpha, X, y, mask, loss, lam, reg)


def u_vector(w: torch.Tensor, X, y: torch.Tensor, loss: Loss) -> torch.Tensor:
    """u with -u_i in d l_i(x_i^T w) (eq. 17)."""
    return loss.u_subgrad(_Atw(X, w), y)
