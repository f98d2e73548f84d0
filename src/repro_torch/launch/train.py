"""The LM training step and its loop (`repro.launch.train` counterpart),
for either model structure (`models.model.Decoder` or
`EncoderDecoder`).

The step is the forward (`models.model.forward_train`),
`loss.backward()` and AdamW with float32 masters (`optim.adamw`); the
new params are copied into the module's own tensors. The backward runs through the plain
attention and scan: the flash and scan kernels have no backward, as the
reference's Pallas kernels have no VJP, and refuse a graph.

`make_jitted_train_step` is the same step on a process mesh: the
weights, the AdamW state and the batch are DTensors placed by
`launch.sharding`'s rules, and the model's hooks are installed for the
step (`sharding.installed`). `run_training` runs on one device or on a
process mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..optim.adamw import AdamWState, adamw_init, adamw_update

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


def make_jitted_train_step(cfg: ModelConfig, mesh, lr: float = 3e-4):
    """`train_step` on a process mesh (`launch.mesh.make_process_mesh`):
    step(model, opt, batch) -> (model, opt, metrics).

    There is no jit: the step runs eagerly, each op a DTensor op. The
    reference's in_shardings become placements made on entry: the
    model's weights by `param_specs`, the AdamW state by `opt_specs`,
    the batch by `batch_specs` (whole tensors, the same on every rank, are
    cut to this rank's slices; DTensors are redistributed), and they
    stay so on the way out (out_shardings). Inside, the "act" and
    "logits" constraints and the FSDP gather are installed. metrics are
    whole tensors on every rank. The mode is the reference's default,
    "train". The update in place stands in for the reference's donation
    of the model and the state: the step returns the model and the
    AdamW tensors it was given, updated, and the caller keeps no old
    copy."""
    from . import sharding as Sh
    from .specs import abstract_params

    mode = "train"
    pspecs = Sh.param_specs(abstract_params(cfg), cfg, mesh, mode)
    ospecs = Sh.opt_specs(pspecs)
    layout = Sh.layout_for(mesh, mode)

    def step(model: M.Model, opt: AdamWState, batch):
        Sh.place_model(model, pspecs, mesh, layout=layout)
        opt = Sh.place_opt(opt, ospecs, mesh, layout)
        batch = Sh.place_tree(batch, Sh.batch_specs(batch, cfg, mesh, mode),
                              mesh, layout)
        with Sh.installed(cfg, mesh, mode, gather=True):
            model, opt, metrics = train_step(model, opt, batch, cfg=cfg,
                                             lr=lr)
        return model, opt, {k: Sh.full(v) for k, v in metrics.items()}

    return step


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
    device. A process mesh (`launch.mesh.make_process_mesh`) steps
    through `make_jitted_train_step` on the mesh's device: every rank
    draws the same batches and keeps its slices, and rank 0 logs. A
    one-card mesh of more than one position raises: a sharded step needs
    a process mesh with one rank a position."""
    if mesh is not None and not mesh.is_process:
        if mesh.size > 1:
            raise ValueError(
                f"a sharded step needs a process mesh with one rank a "
                f"position (launch.mesh.make_process_mesh); the one-card "
                f"mesh {mesh.shape} has no ranks")
        mesh = None
    if mesh is not None:
        device = mesh.device
    if params is None:
        params = M.init_params(cfg, device=resolve_device(device))
    if mesh is not None:        # the AdamW state is made on the shards
        from . import sharding as Sh
        Sh.place_model(params, Sh.param_specs(params, cfg, mesh), mesh,
                       layout=Sh.layout_for(mesh, "train"))
    if opt is None:
        opt = init_opt(params)
    step = (make_jitted_train_step(cfg, mesh, lr=lr) if mesh is not None
            else lambda m, o, b: train_step(m, o, b, cfg=cfg, lr=lr))
    loud = mesh is None or mesh.rank == 0
    metrics = {}
    for t in range(start_step, steps):
        batch = _on_device(next(data_iter), params.device)
        params, opt, metrics = step(params, opt, batch)
        if loud and (t + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {t + 1}: " + " ".join(f"{k}={v:.4f}"
                                               for k, v in m.items()))
        if on_step is not None:
            on_step(t + 1, params, opt, metrics)
    return params, opt, metrics
