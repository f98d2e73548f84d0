"""The sigma'-damped data-local subproblem G_k^{sigma'} (paper eq. 9),
generalized over the regularizer g. Port of `repro.core.subproblem`:

    G_k(da; w, a_k) = -(1/n) sum_{i in P_k} l_i*(-(a_i + da_i))
                      - (1/K) g(w)
                      - (1/n) w^T A da
                      - (sigma' tau / 2) || A da / (tau n) ||^2

with w = grad g*(tau v) the round's primal point and tau = reg.tau(lam).
Under L2 every term is the paper's eq. 9.
"""
from __future__ import annotations

import torch

from .losses import Loss
from .regularizers import L2, Regularizer


def subproblem_value(dalpha_k: torch.Tensor, w: torch.Tensor,
                     alpha_k: torch.Tensor, X_k: torch.Tensor,
                     y_k: torch.Tensor, mask_k: torch.Tensor, loss: Loss,
                     lam: float, n, K: int, sigma_p: float,
                     reg: Regularizer = L2) -> torch.Tensor:
    """G_k^{sigma'} for one worker. X_k (nk, d); the vectors are (nk,)."""
    tau = reg.tau(lam)
    conj = loss.conj(alpha_k + dalpha_k, y_k) * mask_k
    Ada = X_k.T @ (dalpha_k * mask_k)                 # A da  (d,)
    quad = (0.5 * sigma_p / tau) * torch.dot(Ada, Ada) / (n * n)
    return (-torch.sum(conj) / n
            - reg.value(w, lam) / K
            - torch.dot(w, Ada) / n
            - quad)


def subproblem_sum(dalpha, w, alpha, X, y, mask, loss, lam, n, K, sigma_p,
                   reg: Regularizer = L2) -> torch.Tensor:
    """sum_k G_k over the stacked (K, nk, ...) layout."""
    return torch.sum(torch.stack([
        subproblem_value(dalpha[k], w, alpha[k], X[k], y[k], mask[k], loss,
                         lam, n, K, sigma_p, reg)
        for k in range(X.shape[0])]))
