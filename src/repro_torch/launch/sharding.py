"""Partitioning rules (`repro.launch.sharding` counterpart): param,
optimizer, batch and cache specs per mode, and their placement on a
process mesh.

Mesh axes: ("pod", "data", "model") multi-pod or ("data", "model") single
pod (launch/mesh.py). Logical roles:

  train mode
    batch    -> (pod, data)                      pure DP over pods + data
    TP dim   -> model       (heads, d_ff, vocab, experts, d_inner, lru)
    FSDP dim -> (pod, data) (the non-TP dim of every big matrix; optimizer
                             states inherit it => ZeRO-3-style memory)
  serve mode
    same TP; FSDP dim -> data only (weights stream via all-gather; pods are
    independent replicas of the serving fleet);
    KV cache: batch -> (pod, data), KV heads -> model (else the sequence,
    else head_dim)
    long-context (batch=1): KV seq -> data, head_dim -> model; SSM/RG-LRU
    state width -> model.

A spec (`P`) is a tuple with one entry per tensor dim: None, an axis name
or a tuple of axis names; a spec shorter than the tensor replicates the
dims it leaves out. Rules match on (path, leaf name, ndim) as the
reference's. The port's leaves are unstacked (`models.model.
reference_state` maps the names), so a leaf takes the reference's stacked
spec without its leading None; an encoder-decoder cache's "self" and
"cross" leaves keep their leading layer axis, as the reference's.

Placement: `placements(mesh, spec)` turns a spec into DTensor placements
on the `torch.distributed` DeviceMesh of a process mesh
(`launch.mesh.device_mesh`), the counterpart of `NamedSharding`; a dim
split over a tuple of axes is sharded over them in mesh order, outer
first. In train mode (pod, data) is one DeviceMesh dim (`layout_for`):
DTensor's planning grows with the mesh's dims. `shard_state` cuts whole
tensors to a rank's slices, `place` / `place_model` make DTensors of
them, `gather_state` gathers them whole again. The reference's model is
mesh-agnostic and GSPMD inserts the collectives; here DTensor's op rules
do, eagerly, op by op, under `implicit_replication` (a plain tensor is
the same on every rank). No analogue: GSPMD's propagation across a whole
program (DTensor decides one op at a time, so it may gather where GSPMD
would have kept a shard), and `with_sharding_constraint` as a hint: the
port's `models.model.constrain` and `use_specs_fn` redistribute, a
command. The hand-written kernels and the attention cores take local
shards (`models.shards.local_kernel`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig


class P(tuple):
    """A PartitionSpec: `P("data", None)`, `P(("pod", "data"), "model")`,
    `P()` (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Axes:
    dp: object          # batch / pure-DP axes, e.g. ("pod","data")
    fsdp: object        # weight-sharding axis(es)
    tp: object = "model"
    seq: Optional[str] = None      # sequence sharding for long-context serve


def axes_for(mesh, mode: str) -> Axes:
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp = dp[0] if len(dp) == 1 else dp
    if mode == "train":
        return Axes(dp=dp, fsdp=dp)
    if mode == "serve":
        return Axes(dp=dp, fsdp="data")
    if mode == "serve_long":
        return Axes(dp=None, fsdp="data", seq="data")
    raise ValueError(mode)


def _axes(axis) -> tuple:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _divisible(mesh, axis, size) -> bool:
    if axis is None:
        return False
    total = math.prod(mesh.shape[a] for a in _axes(axis))
    return size % total == 0


def _maybe(mesh, axis, size):
    """Use axis only if it divides the dim (else replicate that dim)."""
    return axis if _divisible(mesh, axis, size) else None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _param_rule(path: str, shape, ax: Axes, mesh) -> P:
    """Spec for one parameter leaf, identified by '/'-joined path."""
    nd = len(shape)
    f = lambda i, a: _maybe(mesh, a, shape[i])
    name = path.split("/")[-1]

    # --- norms / biases / scalars: replicate
    if nd <= 1 or name in ("g", "b", "dt_bias", "D", "conv_b", "b_a", "b_i",
                           "lambda"):
        return P()
    # --- embeddings
    if name == "tok":
        return P(f(0, ax.tp), f(1, ax.fsdp))
    if name == "head":
        return P(f(0, ax.fsdp), f(1, ax.tp))
    if name == "pos_dec":
        return P()
    # --- MoE expert tensors (E, d, ff) / (E, ff, d): experts -> tp,
    #     second dim -> fsdp
    if name in ("wi", "wg", "wo") and nd == 3:
        return P(f(0, ax.tp), f(1, ax.fsdp), None)
    if name == "router":
        return P(f(0, ax.fsdp), None)
    # --- attention
    if name in ("wq", "wk", "wv"):
        return P(f(0, ax.fsdp), f(1, ax.tp))
    if name == "wo" and ("attn" in path or "self_attn" in path
                         or "cross_attn" in path):
        return P(f(0, ax.tp), f(1, ax.fsdp))
    # --- dense MLP
    if name in ("wi", "wg"):
        return P(f(0, ax.fsdp), f(1, ax.tp))
    if name == "wo":
        return P(f(0, ax.tp), f(1, ax.fsdp))
    # --- mamba
    if name == "in_proj":
        return P(f(0, ax.fsdp), f(1, ax.tp))
    if name == "x_proj":
        return P(f(0, ax.tp), f(1, ax.fsdp))
    if name == "dt_proj":
        return P(f(0, ax.fsdp), f(1, ax.tp))
    if name == "A_log":
        return P(f(0, ax.tp), None)
    if name == "conv_w":
        return P(None, f(1, ax.tp))
    if name == "out_proj":
        return P(f(0, ax.tp), f(1, ax.fsdp))
    # --- rg-lru
    if name in ("w_x", "w_y"):
        return P(f(0, ax.fsdp), f(1, ax.tp))
    if name in ("w_a", "w_i"):
        return P(f(0, ax.tp), f(1, ax.fsdp))
    if name == "w_o":
        return P(f(0, ax.tp), f(1, ax.fsdp))
    return P()


def _path(name: str) -> str:
    return name.replace(".", "/")


def _named_tensors(params) -> Dict[str, Any]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, cfg: ModelConfig, mesh, mode: str = "train"
                ) -> Dict[str, P]:
    """{state_dict name: spec} of a model (a meta one will do:
    `launch.specs.abstract_params`) or of a {name: tensor} dict."""
    ax = axes_for(mesh, mode)
    return {n: _param_rule(_path(n), t.shape, ax, mesh)
            for n, t in _named_tensors(params).items()}


def use_specs(params, cfg: ModelConfig, mesh, mode: str = "train"
              ) -> Dict[str, P]:
    """The use-site specs: the storage specs without the fsdp axes
    (weights gathered over (pod, data) just in time, TP kept)."""
    ax_use = dataclasses.replace(axes_for(mesh, mode), fsdp=None)
    return {n: _param_rule(_path(n), t.shape, ax_use, mesh)
            for n, t in _named_tensors(params).items()}


def use_specs_fn(cfg: ModelConfig, mesh, mode: str = "train"):
    """Returns gather(named) -> {name: tensor}: a block's weights
    ({relative state_dict name: DTensor}) redistributed to their use-site
    spec (`use_specs`). The FSDP just-in-time gather that
    `models.model.set_param_gather` installs."""
    def gather(named):
        specs = use_specs(named, cfg, mesh, mode)
        return {n: redistribute(t, mesh, specs[n]) for n, t in named.items()}
    return gather


def opt_specs(pspecs):
    """AdamW state specs: master/m/v mirror param specs; step replicated."""
    from ..optim.adamw import AdamWState
    return AdamWState(master=pspecs, m=pspecs, v=pspecs, step=P())


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(batch, cfg: ModelConfig, mesh, mode: str = "train"
                ) -> Dict[str, P]:
    ax = axes_for(mesh, mode)

    def one(name, shape):
        if name == "positions" and len(shape) == 3:     # M-RoPE (3,B,S)
            return P(None, _maybe(mesh, ax.dp, shape[1]), None)
        if len(shape) == 0:
            return P()
        b = _maybe(mesh, ax.dp, shape[0])
        if name in ("embeds", "frames"):
            return P(b, _maybe(mesh, ax.seq, shape[1]), None)
        return P(*([b] + [_maybe(mesh, ax.seq, shape[1])
                          if len(shape) > 1 else None]
                   + [None] * (len(shape) - 2)))

    return {k: one(k, tuple(v.shape)) for k, v in batch.items()}


def _cache_rule(name: str, shape, lead: int, ax: Axes, mesh) -> P:
    core = shape[lead:]
    if name in ("k", "v"):
        B, S, KV, hd = core
        # kv-head sharding keeps GQA attention local per rank; when KV
        # doesn't divide |tp|, shard the sequence dim instead, else head_dim
        if _divisible(mesh, ax.tp, KV):
            spec = (_maybe(mesh, ax.dp, B), _maybe(mesh, ax.seq, S),
                    ax.tp, None)
        elif ax.seq is None and _divisible(mesh, ax.tp, S):
            spec = (_maybe(mesh, ax.dp, B), ax.tp, None, None)
        else:
            spec = (_maybe(mesh, ax.dp, B), _maybe(mesh, ax.seq, S),
                    None, _maybe(mesh, ax.tp, hd))
    elif name == "h" and len(core) == 3:            # ssm state
        B, di, N = core
        spec = (_maybe(mesh, ax.dp, B), _maybe(mesh, ax.tp, di), None)
    elif name == "h":                                # rglru state
        B, L = core
        spec = (_maybe(mesh, ax.dp, B), _maybe(mesh, ax.tp, L))
    elif name == "conv":
        B, W1, width = core
        spec = (_maybe(mesh, ax.dp, B), None, _maybe(mesh, ax.tp, width))
    else:
        spec = (None,) * len(core)
    return P(*([None] * lead), *spec)


def cache_specs(cache, cfg: ModelConfig, mesh, mode: str):
    """KV/state cache specs, in the cache's structure: one dict a layer
    (k/v: (B, S, KV, hd); ssm h: (B, di, N); rglru h: (B, L); conv:
    (B, W-1, width)), or an encoder-decoder's {"self", "cross"} of
    (L, B, S, KV, hd) leaves."""
    ax = axes_for(mesh, mode)
    if isinstance(cache, dict):
        return {part: {n: _cache_rule(n, tuple(t.shape), 1, ax, mesh)
                       for n, t in leaves.items()}
                for part, leaves in cache.items()}
    return [{n: _cache_rule(n, tuple(t.shape), 0, ax, mesh)
             for n, t in layer.items()} for layer in cache]


def activation_spec(mesh, mode: str) -> P:
    """(B,S,d) constraint at block boundaries."""
    ax = axes_for(mesh, mode)
    return P(ax.dp, ax.seq, None)


# ---------------------------------------------------------------------------
# placement on a process mesh
# ---------------------------------------------------------------------------

def layout_for(mesh, mode: str) -> Tuple[Tuple[str, ...], ...]:
    """The DeviceMesh dims of a mode: one a mesh axis, except that the
    axes every spec of the mode splits together (train's dp = (pod,
    data)) are one dim, so DTensor plans its collectives over fewer
    dims. Row-major over the mesh axes either way."""
    ax = axes_for(mesh, mode)
    merged = ax.dp if mode == "train" and isinstance(ax.dp, tuple) else ()
    groups = []
    for a in mesh.axis_names:
        if a not in merged:
            groups.append((a,))
        elif a == merged[0]:
            groups.append(tuple(merged))
    return tuple(groups)


def _layout(mesh, layout):
    return (tuple(layout) if layout is not None
            else tuple((a,) for a in mesh.axis_names))


def placements(mesh, spec, layout=None) -> tuple:
    """The DTensor placements of `spec` on the DeviceMesh of `layout`, one
    a dim: Shard(i) for a dim whose axes split tensor dim i, Replicate()
    otherwise. The axes of a tensor dim must come in mesh order and cover
    whole DeviceMesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    groups = _layout(mesh, layout)
    out = [Replicate()] * len(groups)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        hit = [g for g in groups if set(g) & set(axes)]
        if sum(hit, ()) != axes:
            raise ValueError(f"spec {spec}: the axes {axes} of dim {dim} do "
                             f"not cover whole dims of the layout {groups} "
                             f"in mesh order")
        for g in hit:
            out[groups.index(g)] = Shard(dim)
    return tuple(out)


def local_slices(shape, spec, mesh, coords: Dict[str, int]) -> tuple:
    """The slice of each dim of a `shape` tensor that the rank at `coords`
    holds under `spec`: dim i split over axes (a1, a2, ...) in even
    chunks, row-major over the axes (`Mesh.coords`' order)."""
    out = [slice(None)] * len(shape)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        c = shape[dim] // n
        out[dim] = slice(idx * c, (idx + 1) * c)
    return tuple(out)


def shard_state(state, specs, mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices (`mesh.coords()`) of a whole state
    {name: tensor or array} under {name: spec}, as contiguous tensors on
    the mesh's device. A reference tree goes through
    `models.model.reference_state` first."""
    coords = mesh.coords()
    out = {}
    for n, t in state.items():
        t = torch.as_tensor(t)
        out[n] = t[local_slices(t.shape, specs[n], mesh, coords)].to(
            mesh.device, copy=True).contiguous()
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def gather_state(state, specs=None, mesh=None) -> Dict[str, torch.Tensor]:
    """The whole tensors of a state: DTensors gathered (`full_tensor`),
    local slices under {name: spec} on `mesh` gathered the same way, plain
    tensors without specs as they are. A collective: every rank calls it."""
    out = {}
    for n, t in state.items():
        if not _is_dtensor(t) and specs is not None:
            t = from_local(t, mesh, specs[n])
        out[n] = t.full_tensor() if _is_dtensor(t) else t
    return out


def from_local(local: torch.Tensor, mesh, spec, layout=None):
    """A DTensor of this rank's slice `local` under `spec`."""
    from torch.distributed.tensor import DTensor
    from .mesh import device_mesh
    return DTensor.from_local(local, device_mesh(mesh, _layout(mesh, layout)),
                              placements(mesh, spec, layout),
                              run_check=False)


def _layout_of(t) -> tuple:
    return tuple(tuple(n.split("+")) for n in t.device_mesh.mesh_dim_names)


def place(t, mesh, spec, layout=None):
    """`t` as a DTensor under `spec`: a DTensor redistributed (gathered
    whole first when it lies on another layout's DeviceMesh), a whole
    tensor (the same on every rank) cut to this rank's slice."""
    if _is_dtensor(t):
        if _layout_of(t) == _layout(mesh, layout):
            return redistribute(t, mesh, spec)
        t = t.full_tensor()
    t = torch.as_tensor(t)
    local = t[local_slices(t.shape, spec, mesh, mesh.coords())].to(
        mesh.device).contiguous()
    return from_local(local, mesh, spec, layout)


def redistribute(t, mesh, spec):
    """A DTensor under `spec`, on its own DeviceMesh (the same tensor when
    it is already)."""
    want = placements(mesh, spec, _layout_of(t))
    if tuple(t.placements) == want:
        return t
    return t.redistribute(t.device_mesh, want)


def place_tree(tree, spec_tree, mesh, layout=None):
    """`place` over a tree of tensors and a tree of specs of its
    structure (dicts and lists)."""
    if isinstance(spec_tree, P):
        return place(tree, mesh, spec_tree, layout)
    if isinstance(spec_tree, dict):
        return {k: place_tree(tree[k], spec_tree[k], mesh, layout)
                for k in tree}
    return [place_tree(t, s, mesh, layout) for t, s in zip(tree, spec_tree)]


def place_model(model: torch.nn.Module, specs: Dict[str, P], mesh,
                local_state: Optional[Dict[str, torch.Tensor]] = None,
                layout=None):
    """Make every parameter of `model` a DTensor under its spec, in place,
    and return the model: this rank's slices from `local_state`
    (`shard_state`) when given, else whole weights (the same on every
    rank) cut to them, DTensors redistributed."""
    want_layout = _layout(mesh, layout)
    for name, p in list(model.named_parameters()):
        if local_state is not None:
            new = from_local(local_state[name], mesh, specs[name], layout)
        elif (_is_dtensor(p) and _layout_of(p) == want_layout
              and tuple(p.placements) == placements(mesh, specs[name],
                                                    layout)):
            continue
        else:
            new = place(p.detach(), mesh, specs[name], layout)
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            new, requires_grad=p.requires_grad)
    return model


def place_opt(opt, ospecs, mesh, layout=None):
    """An AdamW state placed by `opt_specs`."""
    return type(opt)(*(place_tree(t, s, mesh, layout)
                       for t, s in zip(opt, ospecs)))


def full(t):
    """The whole value of a DTensor (a collective); a plain tensor as it
    is."""
    return t.full_tensor() if _is_dtensor(t) else t


@contextlib.contextmanager
def installed(cfg: ModelConfig, mesh, mode: str, *, gather: bool):
    """The model's hooks for one sharded step, as the reference's dry run
    installs them: the "act" constraint P(dp, seq, None), the "logits"
    constraint P(dp, None, "model"), and the FSDP just-in-time gather when
    `gather` (train and prefill; decode keeps the weights 2-D sharded).
    Inside, DTensor treats a plain tensor as replicated
    (`implicit_replication`). Removed on the way out."""
    from torch.distributed.tensor.experimental import implicit_replication
    from ..models import model as M
    ax, layout = axes_for(mesh, mode), layout_for(mesh, mode)
    M.set_shardings(act=placements(mesh, P(ax.dp, ax.seq, None), layout),
                    logits=placements(mesh, P(ax.dp, None, "model"), layout))
    M.set_param_gather(use_specs_fn(cfg, mesh, mode) if gather else None)
    try:
        with implicit_replication():
            yield
    finally:
        M.set_shardings(act=None, logits=None)
        M.set_param_gather(None)
