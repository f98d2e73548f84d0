"""The LM training step and its loop (`repro.launch.train` counterpart),
for either model structure (`models.model.Decoder` or
`EncoderDecoder`).

The step is the forward (`models.model.forward_train`),
`loss.backward()` and AdamW with float32 masters (`optim.adamw`); the
new params are copied into the module's own tensors. The backward runs through the plain
attention and scan: the flash and scan kernels have no backward, as the
reference's Pallas kernels have no VJP, and refuse a graph.

`make_jitted_train_step` and its sharding rules are not ported (ROADMAP.md
Queue 1 item 13f): `run_training` runs on one device, and a mesh raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..optim.adamw import AdamWState, adamw_init, adamw_update

_ITEM13F = ("a mesh needs make_jitted_train_step's sharding rules, not "
            "ported yet (ROADMAP.md Queue 1 item 13f)")


def init_opt(model: M.Model) -> AdamWState:
    """`adamw_init` of the model's weights, by `named_parameters()` name."""
    return adamw_init({n: p.detach() for n, p in model.named_parameters()})


def train_step(model: M.Model, opt: AdamWState, batch, *,
               cfg: Optional[ModelConfig] = None, lr: float = 3e-4):
    """One step: (model, opt, metrics), the model's weights and `opt`
    updated in place. metrics: xent, moe_aux, loss, grad_norm (0-d
    tensors). The grads stay on the parameters (`p.grad`) until the next
    step; a weight the loss does not reach gets a zero grad, as
    `jax.grad` gives."""
    model.zero_grad(set_to_none=True)
    loss, metrics = M.forward_train(model, batch, cfg)
    loss.backward()
    named = dict(model.named_parameters())
    params = {n: p.detach() for n, p in named.items()}
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in named.items()}
    new_params, opt, gnorm = adamw_update(grads, opt, params, lr=lr)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(new_params[n])
    del new_params
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update({"loss": loss.detach(), "grad_norm": gnorm})
    return model, opt, metrics


def _on_device(batch, device: torch.device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run_training(cfg: ModelConfig, mesh, data_iter, *, steps: int,
                 lr: float = 3e-4, log_every: int = 10, on_step=None,
                 params: Optional[M.Model] = None,
                 opt: Optional[AdamWState] = None, start_step: int = 0,
                 device=DEFAULT_DEVICE):
    """A synchronous trainer loop with the hook `on_step(step, model, opt,
    metrics)`. `params` is a model (default: `init_params(cfg)` on
    `device`, seed 0) and `opt` its AdamW state; batches from `data_iter`
    (numpy or tensors) go to the model's device. `mesh=None` is one
    device; a mesh raises (item 13f)."""
    if mesh is not None:
        raise NotImplementedError(_ITEM13F)
    if params is None:
        params = M.init_params(cfg, device=resolve_device(device))
    if opt is None:
        opt = init_opt(params)
    metrics = {}
    for t in range(start_step, steps):
        batch = _on_device(next(data_iter), params.device)
        params, opt, metrics = train_step(params, opt, batch, cfg=cfg,
                                          lr=lr)
        if (t + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {t + 1}: " + " ".join(f"{k}={v:.4f}"
                                               for k, v in m.items()))
        if on_step is not None:
            on_step(t + 1, params, opt, metrics)
    return params, opt, metrics
