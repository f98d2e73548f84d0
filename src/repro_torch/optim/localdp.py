"""CoCoA-DP: the paper's additive aggregation carried over to data-parallel
training of non-convex models (`repro.optim.localdp` counterpart; beyond
the paper, no convex theory claimed).

Per round, every data-parallel worker k runs H plain SGD steps on its own
batch, starting from the shared params theta, on the sigma'-damped local
objective

    L_k(theta_k) = loss_k(theta_k) + (prox/2) ||theta_k - theta||^2 ,
    prox = prox0 * sigma'        (sigma' = gamma K, the paper's safe bound)

then the deltas are aggregated additively:

    theta <- theta + gamma * sum_k (theta_k - theta)

gamma = 1/K with prox = 0 is local-SGD averaging; gamma = 1 with the
damped subproblem is the CoCoA+ rule. One delta crosses the wire a round
instead of one gradient a step. Optional int8 / top-k compression with
error feedback on the summed delta (`comm.compress`).

Params and deltas are dicts of tensors (`named_parameters()` names).
The reference's vmap over K becomes a loop over the workers that keeps
one running sum of the deltas, never K stacked copies of the model; its
shard_map becomes a process mesh with one all_reduce of the delta per
leaf a round (`make_round_sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..comm import compress as C
from ..comm.collectives import all_reduce

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LocalDPConfig:
    K: int
    H: int = 8
    gamma: float = 1.0
    prox0: float = 0.5             # prox = prox0 * sigma' (under-damping diverges, mirroring the paper's naive-adding failure)
    sigma_p: Optional[float] = None   # None -> gamma * K (safe bound)
    inner_lr: float = 1e-2
    compress: str = "none"

    def resolved_sigma(self) -> float:
        return self.sigma_p if self.sigma_p is not None else self.gamma * self.K

    @staticmethod
    def averaging(K: int, **kw) -> "LocalDPConfig":
        return LocalDPConfig(K=K, gamma=1.0 / K, prox0=0.0, sigma_p=1.0, **kw)

    @staticmethod
    def adding(K: int, **kw) -> "LocalDPConfig":
        return LocalDPConfig(K=K, gamma=1.0, sigma_p=float(K), **kw)


class LocalDPState(NamedTuple):
    params: Tree
    ef: object            # error-feedback state (or None)
    rounds: torch.Tensor


def init_state(params: Tree, cfg: LocalDPConfig) -> LocalDPState:
    ef = C.ef_init(params) if cfg.compress != "none" else None
    some = next(iter(params.values()))
    return LocalDPState(params, ef,
                        torch.zeros((), dtype=torch.int32,
                                    device=some.device))


def decoder_loss_fn(model) -> Callable:
    """`loss_fn(params, batch)` of a `models.model.Decoder` or
    `EncoderDecoder`: its `forward_train` loss under the weights `params`
    (every `named_parameters()` name), through
    `torch.func.functional_call`."""
    def loss_fn(params: Tree, batch):
        return torch.func.functional_call(model, params, (batch,))[0]
    return loss_fn


def _take(batches, k: int):
    """Worker k's batch of a tree with a leading (K, ...) axis."""
    if isinstance(batches, dict):
        return {n: _take(b, k) for n, b in batches.items()}
    if isinstance(batches, (list, tuple)):
        return type(batches)(_take(b, k) for b in batches)
    return batches[k]


def _local_delta(loss_fn: Callable, cfg: LocalDPConfig, theta: Tree,
                 batch) -> Tree:
    """theta_k - theta after H SGD steps on worker k's damped objective."""
    prox = cfg.prox0 * cfg.resolved_sigma()
    theta = {n: t.detach() for n, t in theta.items()}
    p = dict(theta)
    for _ in range(cfg.H):
        p = {n: t.detach().requires_grad_() for n, t in p.items()}
        with torch.enable_grad():
            reg = sum(torch.sum((p[n] - theta[n]) ** 2) for n in theta)
            damped = loss_fn(p, batch) + 0.5 * prox * reg
            grads = torch.autograd.grad(damped, list(p.values()))
        with torch.no_grad():
            p = {n: w - cfg.inner_lr * g
                 for (n, w), g in zip(p.items(), grads)}
    return {n: p[n] - theta[n] for n in theta}


def make_round_fn(loss_fn: Callable, cfg: LocalDPConfig):
    """loss_fn(params, batch) -> scalar. Batches: a tree with a leading
    (K, ...) worker axis. The simulation backend: the K workers in turn,
    their deltas summed as they finish."""

    def round_fn(state: LocalDPState, batches) -> LocalDPState:
        summed = None
        for k in range(cfg.K):
            delta = _local_delta(loss_fn, cfg, state.params,
                                 _take(batches, k))
            if summed is None:
                summed = delta
            else:
                for n in summed:
                    summed[n] += delta[n]
            del delta
        # compression with error feedback on the summed delta, as the
        # reference simulates it
        if cfg.compress != "none":
            summed, ef = C.compress(summed, state.ef, cfg.compress)
        else:
            ef = state.ef
        with torch.no_grad():
            new_params = {n: p + cfg.gamma * summed[n]
                          for n, p in state.params.items()}
        return LocalDPState(new_params, ef, state.rounds + 1)

    return round_fn


def make_round_sharded(loss_fn: Callable, cfg: LocalDPConfig, mesh,
                       data_axis: str = "data"):
    """The process-mesh path: `round_fn(params, batches) -> params`, run on
    every rank of `mesh` (`launch.mesh.make_process_mesh`). Batches carry
    the global (K, ...) axis, K = the data axis's size; each rank trains
    on its own row, then one all_reduce of each leaf's delta over the
    data group (no compression, as the reference's shard_map path)."""
    if not mesh.is_process:
        raise ValueError("make_round_sharded runs on a process mesh "
                         "(make_process_mesh); on one card use "
                         "make_round_fn")
    group = mesh.subgroup((data_axis,))
    me = mesh.coords()[data_axis]

    def round_fn(params: Tree, batches) -> Tree:
        delta = _local_delta(loss_fn, cfg, params, _take(batches, me))
        with torch.no_grad():
            return {n: p + cfg.gamma * all_reduce(delta[n], group)
                    for n, p in params.items()}

    return round_fn
