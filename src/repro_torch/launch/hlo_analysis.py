"""Per-device analysis of one step (`repro.launch.hlo_analysis`
counterpart): the roofline terms of what one rank runs.

The reference parses the post-SPMD HLO text of a compiled step. Eager
PyTorch has no such module, so the port counts the step as it runs, on
the rank's local tensors:

  * FLOPs: 2 · prod(result dims) · prod(contracting dims) for each
    matrix product (mm, addmm, bmm, baddbmm, mv, dot; einsum and matmul
    reach the dispatcher as these), `dot_flops`; elementwise arithmetic
    at one a result element and reductions at one an input element,
    `ew_flops`, as the reference prices them.
  * HBM bytes: every eager op's operand plus result bytes (an output
    that aliases an input, as an in-place op's, counted once); view and
    metadata ops are free; a gather or a scatter of a strip of a big
    operand (an index, an embedding lookup, an index_put) moves the
    strip twice, as the reference prices a dynamic-slice. Nothing fuses
    in eager mode, so this is an unfused upper bound of the traffic,
    where the reference's model prices XLA's fusions.
  * Collectives: the tally of `comm.collectives` (every routed DTensor
    collective and every direct call), priced by the reference's ring
    model, wire bytes a device:
        all-reduce 2·b·(g-1)/g | all-gather b_out·(g-1)/g |
        reduce-scatter b_result·(g-1) | all-to-all b·(g-1)/g |
        collective-permute b.

The counter (`StepCounter`) is a TorchDispatchMode that steps aside for
DTensors: DTensor's dispatch then runs the local op, which the mode
counts. So a product of DTensors is counted on the rank's shards, per
device, not at its global shape; DTensor's sharding propagation, which
runs the op on FakeTensors at the global shape, is not counted. On a
fake world (`launch.mesh.make_fake_mesh`) every tensor is on "meta" and
nothing is computed: the counts are the same.

A hand-written kernel launches nothing on "meta": its wrapper declares
its cost from `obs.cost`'s formulas (`obs.cost.declare`), which the
running counter adds in the kernel's place.

No analogue: `HloModule` (no HLO text; the model's Python loop over its
layers runs every layer, in place of the while loops' trip counts) and
`stats_of_compiled` (there is no compiled executable: `obs.prof.
analyze_jit` counts a first call instead).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..comm import collectives as col
from ..obs import cost

_aten = torch.ops.aten

_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default, _aten.mv.default, _aten.addmv.default,
         _aten.dot.default}

# elementwise arithmetic priced at one FLOP a result element (the
# reference's _EW_OPS), and reductions at one an input element
_EW = {"add", "sub", "mul", "div", "neg", "abs", "maximum", "minimum",
       "pow", "sqrt", "rsqrt", "exp", "log", "tanh", "sigmoid", "sin",
       "cos", "silu", "gelu", "rsub", "reciprocal", "softplus", "exp2",
       "log1p", "expm1", "square", "clamp_min", "clamp_max", "clamp"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
           "_softmax", "_log_softmax", "cumsum", "prod", "norm",
           "linalg_vector_norm", "var", "std", "argmax", "argmin"}
# a strip read out of (gathers) or written into (scatters) a big first
# operand: priced by the strip, as the reference prices a dynamic-slice
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put", "_index_put_impl", "scatter", "scatter_add",
             "index_add", "index_copy"}
# ops that move no memory of their own
_FREE = {"detach", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "_local_scalar_dense",
         "is_same_size", "_to_copy_meta", "set_", "resize_", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "item",
         "_has_compatible_shallow_copy_type", "alias"}


def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args) -> float:
    if func in (_aten.mm.default, _aten.bmm.default, _aten.mv.default,
                _aten.dot.default):
        a, b = args[0], args[1]
    else:                                   # addmm, baddbmm, addmv
        a, b = args[1], args[2]
    k = a.shape[-1]
    res = a.shape[:-1] + (b.shape[-1:] if b.dim() >= 2 else ())
    return 2.0 * math.prod(res) * k


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class StepCounter(TorchDispatchMode):
    """Counts `dot_flops`, `ew_flops` and `hbm_bytes` of the ops run
    inside it, on plain (local) tensors; see the module's docstring."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.ew_flops = 0.0
        self.hbm_bytes = 0.0

    def __enter__(self):
        cost.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def add(self, stats: dict) -> None:
        """A kernel's declared cost (`obs.cost.declare`)."""
        self.dot_flops += stats["dot_flops"]
        self.ew_flops += stats["flops"] - stats["dot_flops"]
        self.hbm_bytes += stats["hbm_bytes"]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               for t in types):
            if any(_is_dtensor_type(t) for t in types):
                return NotImplemented   # its dispatch runs the local op,
                                        # counted then
            return func(*args, **kwargs)   # a FakeTensor: DTensor's
                                           # propagation at the global shape
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns != "aten":                    # c10d collectives: the tally
            return out
        name = func._schema.name.split("::")[-1].rstrip("_")
        if name in _FREE or _is_view(func):
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func in _DOTS:
            self.dot_flops += _dot_flops(func, args)
        elif name in _EW:
            self.ew_flops += sum(t.numel() for t in outs)
        elif name in _REDUCE and ins:
            self.ew_flops += ins[0].numel()
        if name in _GATHERS:        # a strip out of a big operand: the
            self.hbm_bytes += 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:])    # strip read and written
            return out
        if name in _SCATTERS:       # a strip into a big operand, in place
            self.hbm_bytes += 2 * sum(_nbytes(t) for t in ins[1:])
            return out
        seen = {id(t) for t in ins}
        self.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs if id(t) not in seen)
        return out


def wire_bytes(kind: str, b: float, g: int) -> float:
    """Wire bytes a device of `kind` moving b bytes (the result's, as the
    reference counts them) in a group of g: the ring model."""
    if kind == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if kind == "reduce-scatter":
        return float(b) * (g - 1)
    if kind == "collective-permute":
        return float(b)
    return float(b) * (g - 1) / g           # all-gather, all-to-all


def collective_stats(records: dict) -> Dict[str, Dict[str, float]]:
    """{kind: {"count", "bytes", "wire_bytes"}} of a tally
    (`comm.collectives.tally_since`), the reference's form."""
    stats: Dict[str, Dict[str, float]] = {}
    for (kind, g, _routed), (count, b, _handed) in sorted(records.items()):
        s = stats.setdefault(kind, {"count": 0.0, "bytes": 0.0,
                                    "wire_bytes": 0.0})
        s["count"] += count
        s["bytes"] += b
        s["wire_bytes"] += wire_bytes(kind, b, g)
    return stats


def total_wire_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(s["wire_bytes"] for s in stats.values())


def full_stats(counter: StepCounter, records: dict) -> Dict[str, object]:
    """The reference's `full_stats` keys from a counter that ran the step
    and the step's tally."""
    coll = collective_stats(records)
    return {
        "dot_flops": counter.dot_flops,
        "ew_flops": counter.ew_flops,
        "flops": counter.dot_flops + counter.ew_flops,
        "hbm_bytes": counter.hbm_bytes,
        "collectives": coll,
        "collective_wire_bytes": total_wire_bytes(coll),
    }


def count_step(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its `full_stats`, the tally of its
    collectives): one call, counted."""
    snap = col.tally()
    counter = StepCounter()
    with counter:
        out = fn(*args, **kwargs)
    records = col.tally_since(snap)
    return out, full_stats(counter, records), records
