"""Partition-difficulty quantities. Port of `repro.core.sigma`: sigma_k
(eq. 19), sigma (Lemma 6), sigma'_min (eq. 11) and the Table-1 ratio
(n^2/K) / sigma.

    sigma_k    = ||A_[k]||_2^2  (top squared singular value of the block)
    sigma      = sum_k sigma_k n_k
    sigma'_min = gamma max_a ||A a||^2 / sum_k ||A a_[k]||^2
               = gamma lambda_max(B^{-1/2} G B^{-1/2}),  G = A^T A,
                 B = blockdiag(A_[k]^T A_[k])

Power iterations draw their start vectors from a threefry key in the
reference; here they are inputs (`v0`, `a0`) for parity, and otherwise
come from a CPU `torch.Generator` seeded with `seed`. X is the dense
(K, nk, d) partition; the matvecs are batched over the K workers.
"""
from __future__ import annotations

from typing import Optional

import torch


def lemma3_safe_sigma(gamma: float, K: int) -> float:
    """The Lemma-3/4 safe subproblem bound sigma' = gamma * K, >= sigma'_min
    (eq. 11) for any data partition."""
    return float(gamma) * K


def _normal(shape, seed: int, like: torch.Tensor) -> torch.Tensor:
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(shape, generator=gen).to(like.device, like.dtype)


def sigma_k(X: torch.Tensor, mask: torch.Tensor, iters: int = 50,
            seed: int = 0, v0: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Per-worker top squared singular value, (K, nk, d) -> (K,), by
    `iters` power iterations from the (K, d) start vectors `v0`. Runs at
    full width: two batched matvecs over X an iteration."""
    K, nk, d = X.shape
    Xm = X * mask[..., None]
    v = _normal((K, d), seed, X) if v0 is None else v0.to(X.device, X.dtype)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        u = torch.einsum("kid,kd->ki", Xm, v)
        v2 = torch.einsum("kid,ki->kd", Xm, u)
        v = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + 1e-30)
    u = torch.einsum("kid,kd->ki", Xm, v)
    return torch.sum(u * u, dim=-1) / (torch.sum(v * v, dim=-1) + 1e-30)


def sigma_total(X: torch.Tensor, mask: torch.Tensor, **kw) -> torch.Tensor:
    """sigma = sum_k sigma_k n_k (Lemma 6)."""
    sk = sigma_k(X, mask, **kw)
    return torch.sum(sk * torch.sum(mask, dim=1))


def table1_ratio(X: torch.Tensor, mask: torch.Tensor, **kw) -> torch.Tensor:
    """(n^2 / K) / sigma -- the paper's Table 1 entries (>= 1; larger means
    the safe bound sigma <= n^2/K is looser, the data easier than the
    worst case)."""
    K = X.shape[0]
    n = torch.sum(mask)
    return (n * n / K) / sigma_total(X, mask, **kw)


def sigma_prime_min(X: torch.Tensor, mask: torch.Tensor, gamma: float = 1.0,
                    iters: int = 200, seed: int = 0,
                    a0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generalized power iteration for eq. (11): a <- B^{-1} G a,
    B-norm-normalized, from the (K, nk) start `a0`. G a = A^T (A a) uses
    global matvecs; B^{-1} applies the per-block pseudo-inverses
    pinv(A_[k] A_[k]^T) (rtol 1e-6, as the reference).

    Cut shapes only: the K pseudo-inverses are (nk, nk) each, 80 GB at
    epsilon's nk = 50,000 for K = 8."""
    K, nk, d = X.shape
    Xm = X * mask[..., None]
    Binv = torch.linalg.pinv(Xm @ Xm.transpose(1, 2), rtol=1e-6)
    a = _normal((K, nk), seed, X) if a0 is None else a0.to(X.device, X.dtype)
    a = a * mask
    for _ in range(iters):
        v = torch.einsum("kid,ki->d", Xm, a)              # A a
        ga = torch.einsum("kid,d->ki", Xm, v)             # A^T A a
        a2 = torch.einsum("kij,kj->ki", Binv, ga) * mask
        Ak = torch.einsum("kid,ki->kd", Xm, a2)
        a = a2 / (torch.sqrt(torch.sum(Ak * Ak)) + 1e-30)
    Aa = torch.einsum("kid,ki->d", Xm, a)
    Ak = torch.einsum("kid,ki->kd", Xm, a)
    return gamma * torch.dot(Aa, Aa) / (torch.sum(Ak * Ak) + 1e-30)


def check_lemma4(X, mask, gamma: float, **kw):
    """(sigma'_min, gamma K, holds?) -- the Lemma 4 sanity object."""
    K = X.shape[0]
    smin = sigma_prime_min(X, mask, gamma, **kw)
    return smin, gamma * K, bool(smin <= gamma * K + 1e-4)
