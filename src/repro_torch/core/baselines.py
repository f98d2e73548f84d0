"""Baselines the paper compares against (section 6 / Figure 2). Port of
`repro.core.baselines`.

* mini-batch SGD: distributed subgradient descent; every step communicates a
  full d-gradient -- the "communication == computation" regime the paper
  criticizes.
* mini-batch SDCA (CD): each worker computes b independent coordinate updates
  against the *stale* w, aggregated with the conservative 1/(K b) scaling that
  mini-batch theory requires (convergence degrades to batch-gradient as b
  grows -- section 6).
* one-shot averaging: each worker fully solves its local problem once and the
  models are averaged (known not to converge to the optimum in general).

All share the (K, nk, d) layout of core.cocoa, so Figure-2 style
comparisons are apples-to-apples in rounds and communicated vectors.

Randomness. The reference draws from a threefry key; here each function
draws from an explicit CPU `torch.Generator` seeded with `seed`, and takes
an optional hook that supplies the draws instead (as `solve`'s
`visit_orders`): `draws(t)` the (K, b_local) row ids of SGD step or CD
round t, `rows` the (K, H) row ids of the one-shot local solves. The
parity tests replay the reference's `jax.random` draws through them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import duality
from .losses import Loss, get_loss
from .solvers import local_sdca

Draws = Optional[Callable[[int], torch.Tensor]]


class SGDState(NamedTuple):
    w: torch.Tensor
    rng: torch.Generator     # the CPU generator of the steps' draws
    step: int


def _batch(X, y, mask, idx: torch.Tensor):
    """Rows `idx` (K, b) of every worker: xb (K, b, d), yb, mb (K, b)."""
    idx = idx.to(X.device, torch.long)
    ks = torch.arange(X.shape[0], device=X.device)[:, None]
    return X[ks, idx], y[ks, idx], mask[ks, idx], idx


def _draw(rng: torch.Generator, K: int, b_local: int, nk: int
          ) -> torch.Tensor:
    return torch.randint(0, nk, (K, b_local), generator=rng)


def minibatch_sgd_step(state: SGDState, X, y, mask, *, loss: Loss,
                       lam: float, b_local: int, lr0: float,
                       idx: Optional[torch.Tensor] = None) -> SGDState:
    """One synchronous mini-batch SGD step; batch = K * b_local rows,
    `idx` (K, b_local) or drawn from the state's generator."""
    K, nk, _ = X.shape
    if idx is None:
        idx = _draw(state.rng, K, b_local, nk)
    xb, yb, mb, _ = _batch(X, y, mask, idx)
    z = torch.einsum("kbd,d->kb", xb, state.w)
    # -u in dl(z) -> subgradient of loss at z is -u
    g_loss = -loss.u_subgrad(z, yb) * mb
    grad = torch.einsum("kbd,kb->d", xb, g_loss) / torch.clamp(
        torch.sum(mb), min=1)
    grad = grad + lam * state.w
    lr = lr0 / (1.0 + lam * lr0 * state.step)   # 1/(lambda t)-style decay
    return SGDState(state.w - lr * grad, state.rng, state.step + 1)


def run_minibatch_sgd(X, y, mask, *, loss_name: str, lam: float, steps: int,
                      b_local: int = 1, lr0: float = 1.0, seed: int = 0,
                      eval_every: int = 10, draws: Draws = None):
    """`steps` SGD steps from w = 0; the history holds `step`, `primal`
    and `comm_vectors` (K a step) every `eval_every` steps and the last."""
    loss = get_loss(loss_name)
    K = X.shape[0]
    state = SGDState(torch.zeros(X.shape[-1], dtype=X.dtype,
                                 device=X.device),
                     torch.Generator().manual_seed(seed), 0)
    hist = {"step": [], "primal": [], "comm_vectors": []}
    for t in range(steps):
        state = minibatch_sgd_step(
            state, X, y, mask, loss=loss, lam=lam, b_local=b_local, lr0=lr0,
            idx=None if draws is None else draws(t))
        if (t + 1) % eval_every == 0 or t == steps - 1:
            hist["step"].append(t + 1)
            hist["primal"].append(float(duality.primal(state.w, X, y, mask,
                                                       loss, lam)))
            hist["comm_vectors"].append((t + 1) * K)
    return state, hist


def minibatch_cd_round(w, alpha, rng, X, y, mask, *, loss: Loss, lam: float,
                       b_local: int, idx: Optional[torch.Tensor] = None):
    """Synchronous mini-batch dual CD: b_local independent coordinate updates
    per worker against stale w (sigma' = 1 per coordinate), conservative
    1/(K*b_local) averaging; duplicate rows in a batch add. Returns
    (w, alpha, rng)."""
    K, nk, _ = X.shape
    n = duality.effective_n(mask)
    if idx is None:
        idx = _draw(rng, K, b_local, nk)
    xb, yb, mb, idx = _batch(X, y, mask, idx)
    ab = torch.gather(alpha, 1, idx)
    z = torch.einsum("kbd,d->kb", xb, w)
    q = torch.sum(xb * xb, dim=-1) / (lam * n)
    delta = loss.cd_update(ab, z, q, yb) * mb
    scale = 1.0 / (K * b_local)
    alpha = alpha + scale * torch.zeros_like(alpha).scatter_add_(1, idx,
                                                                 delta)
    dw = scale * torch.einsum("kbd,kb->d", xb, delta) / (lam * n)
    return w + dw, alpha, rng


def run_minibatch_cd(X, y, mask, *, loss_name: str, lam: float, rounds: int,
                     b_local: int, seed: int = 0, eval_every: int = 10,
                     draws: Draws = None):
    """`rounds` CD rounds from alpha = 0; the history holds `round`, `gap`,
    `primal` and `comm_vectors` (K a round) every `eval_every` rounds and
    the last. Returns ((w, alpha), history)."""
    loss = get_loss(loss_name)
    K, nk, d = X.shape
    w = torch.zeros(d, dtype=X.dtype, device=X.device)
    alpha = torch.zeros((K, nk), dtype=X.dtype, device=X.device)
    rng = torch.Generator().manual_seed(seed)
    hist = {"round": [], "gap": [], "primal": [], "comm_vectors": []}
    for t in range(rounds):
        w, alpha, rng = minibatch_cd_round(
            w, alpha, rng, X, y, mask, loss=loss, lam=lam, b_local=b_local,
            idx=None if draws is None else draws(t))
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            p, _, g = duality.gap_decomposed(alpha, X, y, mask, loss, lam)
            hist["round"].append(t + 1)
            hist["gap"].append(float(g))
            hist["primal"].append(float(p))
            hist["comm_vectors"].append((t + 1) * K)
    return (w, alpha), hist


def one_shot_average(X, y, mask, *, loss_name: str, lam: float, H: int,
                     seed: int = 0, rows: Optional[torch.Tensor] = None):
    """Each worker solves its local problem (as if it were the full problem
    on its shard: n = its nk_eff, sigma' = 1) with H steps of the eager
    `core.solvers.local_sdca`, and the w's are averaged. No iteration;
    known to be biased. `rows` (K, H) are the steps' row ids (default:
    drawn from a generator seeded with `seed`).

    The workers' nk_eff may differ while `local_sdca` takes one scalar n
    (the dense kernel, likewise, one scalar scale), so the workers are
    solved in groups of equal nk_eff, one call a group."""
    loss = get_loss(loss_name)
    K, nk, d = X.shape
    if rows is None:
        rows = torch.randint(0, nk, (K, H),
                             generator=torch.Generator().manual_seed(seed))
    rows = rows.to(X.device, torch.long)
    nks = torch.sum(mask, dim=1)
    ws = torch.empty((K, d), dtype=X.dtype, device=X.device)
    for nk_eff in torch.unique(nks).tolist():
        ks = torch.nonzero(nks == nk_eff).squeeze(1)
        # one group of all K: no copy of X
        sel = slice(None) if len(ks) == K else ks
        Xg, mg = X[sel], mask[sel]
        res = local_sdca(Xg, y[sel], torch.zeros_like(mg), mg,
                         torch.zeros(d, dtype=X.dtype, device=X.device),
                         rows[sel], loss, lam, nk_eff, 1.0, H)
        ws[sel] = torch.einsum("kid,ki->kd", Xg, res.dalpha * mg) / (
            lam * nk_eff)
    return torch.mean(ws, dim=0)
