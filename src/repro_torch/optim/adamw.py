"""AdamW with float32 master weights (`repro.optim.adamw` counterpart).

Params, grads and the state are dicts of tensors keyed by
`named_parameters()` names, the reference pytree's counterpart: {master,
m, v} all float32 plus a 0-d int32 step. The arithmetic is the
reference's: the global norm over float32 squares, one clip scale
`min(1, clip / max(norm, 1e-12))`, bias corrections as float32 powers of
the float32 step, weight decay on every leaf (norm gains and embeddings
included), new params cast from the masters.

On a process mesh the leaves are DTensors (`launch.train.
make_jitted_train_step`): masters and moments take the params'
placements (`launch.sharding.opt_specs`), the update runs on each rank's
shards, and the global norm is the norm of the whole gradient (DTensor
sums the shards' squares across the ranks before the square root).

The update writes master, m and v in place, leaf by leaf: the returned
state holds the same tensors as the one passed in, which the caller drops
(the reference's jit donates them). On one card that keeps the state at
12 B a parameter instead of 24 during the update.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    master: Tree     # float32 copies of params
    m: Tree
    v: Tree
    step: torch.Tensor


def adamw_init(params: Tree) -> AdamWState:
    """Masters (float32 copies, never aliasing a float32 param), zero
    moments and step 0, each on its param's device."""
    some = next(iter(params.values()))
    return AdamWState(
        master={k: p.detach().to(torch.float32, copy=True)
                for k, p in params.items()},
        m={k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=some.device),
    )


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree, *, lr=3e-4,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 grad_clip=1.0) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm). `state`'s master, m and
    v are updated in place."""
    step = state.step + 1
    gsq = sum(torch.sum(torch.square(grads[k].float())) for k in params)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    f32 = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=f32.device), f32)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=f32.device), f32)
    new_params = {}
    for k, p in params.items():
        g = grads[k].float()
        m, v, w = state.m[k], state.v[k], state.master[k]
        m.mul_(b1).add_((1 - b1) * g * scale)
        v.mul_(b2).add_((1 - b2) * torch.square(g * scale))
        w.sub_(lr * (m / bc1 / (torch.sqrt(v / bc2) + eps)
                     + weight_decay * w))
        new_params[k] = w.to(p.dtype, copy=True)
    return new_params, AdamWState(state.master, state.m, state.v,
                                  step), gnorm
