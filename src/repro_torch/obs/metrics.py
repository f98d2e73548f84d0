"""Metric primitives, fenced wall-clock timing, and the per-round record.

Port of `repro.obs.metrics`. Three layers:

  * `Counter` / `Gauge` / `Histogram` -- minimal in-process metric
    primitives (`Histogram` keeps raw samples, so percentiles are exact at
    round-count scale).
  * fenced timing -- `fenced_call` runs a function and waits for every
    card its outputs live on (`torch.cuda.synchronize`, a no-op on the
    CPU) before reading the host clock, so the number is the work's time,
    not its enqueue. `fenced_time` times steady-state calls with CUDA
    events on the card. `aot_compile` prices what a round needs before
    its first launch: building and loading its kernel libraries.
  * `RoundRecord` -- the frozen, schema-versioned record `core.cocoa.
    solve` emits once per certified round: the certificate triple, the
    wall-clock split (compile / execute / certificate), the wire plan
    (`hops` is `CommTracer.per_hop()` verbatim, `comm` its cumulative
    totals, `wire_floats` the measured-aware delta since the previous
    record), and the per-worker step budgets / EMA throughput when a
    `runtime.straggler.ThroughputTracker` is attached.

The schema, its key order and `validate_record` are the reference's
(schema version 1): a record written by either package passes both
validators (`python -m repro_torch.obs.validate run.jsonl`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

SCHEMA_VERSION = 1


# ----------------------------------------------------------------------------
# metric primitives
# ----------------------------------------------------------------------------

class Counter:
    """Monotone event count (records emitted, rounds run, floats moved)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0

    def inc(self, amount: int = 1) -> int:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        self.value += amount
        return self.value


class Gauge:
    """Last-observed value (current gap, current round latency)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> float:
        self.value = float(value)
        return self.value


class Histogram:
    """Sample distribution with exact percentiles.

    Keeps the raw samples (rounds-scale cardinality, so memory is not a
    concern) and computes percentiles with numpy's linear interpolation
    -- the same definition the aggregator's p50/p99 report uses.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._samples: list = []

    def observe(self, value: float) -> None:
        self._samples.append(float(value))

    def __len__(self) -> int:
        return len(self._samples)

    @property
    def count(self) -> int:
        return len(self._samples)

    @property
    def sum(self) -> float:
        return float(np.sum(self._samples)) if self._samples else 0.0

    def percentile(self, q: float) -> float:
        if not self._samples:
            return float("nan")
        return float(np.percentile(self._samples, q))

    def summary(self) -> dict:
        if not self._samples:
            return {"count": 0, "sum": 0.0, "mean": float("nan"),
                    "p50": float("nan"), "p99": float("nan")}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count,
                "p50": self.percentile(50), "p99": self.percentile(99)}


# ----------------------------------------------------------------------------
# fenced timing
# ----------------------------------------------------------------------------

def cuda_devices(tree) -> List[torch.device]:
    """The CUDA devices of the tensors in `tree` (nested tuples, lists,
    dicts and NamedTuples), in first-seen order."""
    found: List[torch.device] = []
    todo = [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda" and x.device not in found:
                found.append(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (tuple, list)):
            todo.extend(x)
    return found


def fenced_call(fn, *args, **kwargs):
    """Run `fn(*args)` and return `(out, seconds)` with the host clock read
    only after every card the outputs live on finished its queued work --
    the work's time, not its enqueue. The one timing path of `solve`'s
    per-round split and the profiles."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def fenced_time(fn, *args, iters: int = 3, warmup: int = 1, **kwargs):
    """Steady-state seconds per call: `warmup` fenced calls (the first one
    pays a kernel's build), then the mean of `iters` calls -- between two
    CUDA events on the card the inputs or outputs live on, on the host
    clock (each call fenced) otherwise."""
    out = None
    for _ in range(warmup):
        out, _ = fenced_call(fn, *args, **kwargs)
    devs = cuda_devices((args, kwargs, out))
    if not devs:
        total = sum(fenced_call(fn, *args, **kwargs)[1]
                    for _ in range(iters))
        return total / max(iters, 1)
    with torch.cuda.device(devs[0]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / max(iters, 1)


def aot_compile(kernels: Sequence[str], device) -> float:
    """Seconds a round needs before it can run the first time, split out
    of its execute time (the reference's trace + compile split).

    Eager PyTorch compiles nothing ahead of a call; what the first round
    needs is the kernel libraries its solver launches (`kernels`, names of
    `kernels.build.KERNELS`): `nvcc` on first use, then the library's
    load (`kernels.build.load`). This builds and loads each one not loaded
    yet and returns the host seconds that took; 0.0 when every one was
    loaded already, and on the CPU, where the plain versions need none."""
    if torch.device(device).type != "cuda":
        return 0.0
    from ..kernels import build
    todo = [k for k in kernels if not build.is_loaded(k)]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    for name in todo:
        build.load(name)
    return time.perf_counter() - t0


# ----------------------------------------------------------------------------
# the per-round record
# ----------------------------------------------------------------------------

# field -> (type check, required). Kept next to the dataclass so the
# validator and the record can never drift apart.
_NUMERIC = (int, float)
_SCHEMA: dict = {
    "schema": (int,),
    "round": (int,),                # round index within this solve call
    "round_global": (int,),         # cumulative state.rounds (checkpoint-safe)
    "rounds_in_record": (int,),     # rounds covered since the last record
    "gap": _NUMERIC,
    "primal": _NUMERIC,
    "dual": _NUMERIC,
    "compile_s": _NUMERIC,
    "execute_s": _NUMERIC,
    "certificate_s": _NUMERIC,
    "wire_floats": (int,),
    "wire_bytes": (int,),
    "hops": (list, tuple),
    "comm": (dict,),
    "budgets": (list, tuple, type(None)),
    "throughput": (list, tuple, type(None)),
}
_HOP_KEYS = ("hop", "axis", "messages", "floats_per_message", "floats",
             "bytes")
_COMM_KEYS = ("comm_vectors", "comm_floats", "comm_bytes", "comm_psums")


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One certified round, frozen. `hops` is the tracer's `per_hop()`
    output verbatim (per-round wire plan, with `measured_floats` /
    `measured_floats_round` on observed hops); `comm` its cumulative
    `totals()`; `wire_floats` the totals delta since the previous record,
    so per-round *measured* volume (hier compressed gather) is visible
    round by round, not only as a running sum. `execute_s` sums the
    fenced round times since the previous record; `compile_s` is nonzero
    only on the record that paid a kernel library's build and load."""
    round: int
    round_global: int
    rounds_in_record: int
    gap: float
    primal: float
    dual: float
    compile_s: float
    execute_s: float
    certificate_s: float
    wire_floats: int
    wire_bytes: int
    hops: Tuple[dict, ...]
    comm: dict
    budgets: Optional[Tuple[int, ...]] = None
    throughput: Optional[Tuple[float, ...]] = None
    schema: int = SCHEMA_VERSION

    def to_dict(self) -> dict:
        """JSON-ready dict; key order is the schema's, stable across
        runs and equal to the reference's."""
        out = {"schema": self.schema}
        for key in _SCHEMA:
            if key == "schema":
                continue
            val = getattr(self, key)
            if isinstance(val, tuple):
                val = list(val)
            out[key] = val
        return out

    @staticmethod
    def from_dict(d: dict) -> "RoundRecord":
        d = validate_record(d)
        kw = dict(d)
        kw["hops"] = tuple(dict(h) for h in d["hops"])
        for key in ("budgets", "throughput"):
            if d.get(key) is not None:
                kw[key] = tuple(d[key])
        return RoundRecord(**kw)


def validate_record(d: Any) -> dict:
    """Schema gate for one record dict; returns it or raises ValueError
    with the first violation. Checks the version, every field's presence
    and type, the per-hop row shape, and internal consistency
    (bytes = 4 * floats, comm totals keys)."""
    if not isinstance(d, dict):
        raise ValueError(f"record must be a dict, got {type(d).__name__}")
    unknown = set(d) - set(_SCHEMA)
    if unknown:
        raise ValueError(f"unknown record fields: {sorted(unknown)}")
    for key, types in _SCHEMA.items():
        if key not in d:
            raise ValueError(f"record missing field {key!r}")
        if not isinstance(d[key], types) or isinstance(d[key], bool):
            raise ValueError(
                f"field {key!r} wants {'/'.join(t.__name__ for t in types)}, "
                f"got {type(d[key]).__name__}")
    if d["schema"] != SCHEMA_VERSION:
        raise ValueError(f"schema version {d['schema']} != {SCHEMA_VERSION}")
    if d["round"] < 1 or d["rounds_in_record"] < 1:
        raise ValueError("round and rounds_in_record must be >= 1")
    if d["round_global"] < d["round"]:
        raise ValueError("round_global cannot trail the in-call round")
    for t_key in ("compile_s", "execute_s", "certificate_s"):
        if not np.isfinite(d[t_key]) or d[t_key] < 0:
            raise ValueError(f"{t_key} must be finite and >= 0")
    if d["wire_bytes"] != 4 * d["wire_floats"]:
        raise ValueError("wire_bytes must be 4 * wire_floats")
    for row in d["hops"]:
        if not isinstance(row, dict):
            raise ValueError("hops rows must be dicts")
        missing = [k for k in _HOP_KEYS if k not in row]
        if missing:
            raise ValueError(f"hop row missing {missing}: {row}")
    missing = [k for k in _COMM_KEYS if k not in d["comm"]]
    if missing:
        raise ValueError(f"comm totals missing {missing}")
    return d
