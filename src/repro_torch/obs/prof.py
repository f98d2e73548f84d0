"""Kernel performance observatory: analytic-vs-measured profiles.

Port of `repro.obs.prof`. The paper's cost model is rounds x
(communication + local computation); `RoundRecord` carries the
communication half, this module the computation half:

  * `HardwareSpec` -- the peak rates a roofline is stated against
    (FLOP/s, device-memory bytes/s, interconnect bytes/s). The port has
    the CPU host's defaults and the H100 SXM's data-sheet peaks; it has
    no TPU entry.
  * `KernelProfile` -- frozen, schema-versioned (version 1, the
    reference's fields): one profiled computation, its measured fenced
    wall-clock next to its analytic cost (flops, HBM bytes, collective
    wire bytes), the three roofline time terms on a `HardwareSpec`, and
    the achieved-vs-peak fractions. `model_vs_measured` = analytic bound
    / measured wall: ~1 means the model prices the computation honestly,
    << 1 means time the model does not see.
  * `profile_fn` -- the harness: fenced steady-state timing with CUDA
    events (`metrics.fenced_time`) of a function whose analytic cost the
    caller gives (`obs.cost` computes it for a CoCoA+ round from its
    shapes) or, without one, `analyze_jit` counts on a first call.
    `build_profile` is the pure assembly step.
  * `analyze_jit` -- the reference's reads the lowered HLO; eager
    PyTorch compiles nothing, so the port counts one call of the
    function on the tensors it runs on (`launch.hlo_analysis.
    count_step`) and times that call.
  * `RoundProfileSink` -- an `EventBus` sink pairing the two streams: for
    every `RoundRecord` it emits one `KernelProfile` (kind="round") whose
    wall-clock is the record's fenced per-round execute time and whose
    analytic cost is the round's (`obs.cost.round_stats`), sharing
    `round_global` so `repro_torch.obs.validate --prof` can check the
    pairing.

Validate a profile JSONL with `python -m repro_torch.obs.validate
run.prof.jsonl` (the CLI sniffs the schema by the `kind` field).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, synchronize
from .metrics import aot_compile, cuda_devices, fenced_time

PROF_SCHEMA_VERSION = 1


# ----------------------------------------------------------------------------
# hardware peaks
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak rates a roofline fraction is stated against. `ici_bw` prices
    the collective term (bytes/s per link between devices; loopback-ish
    for a host CPU mesh, where collectives are memcpys)."""
    name: str
    peak_flops: float           # FLOP/s per device
    hbm_bw: float               # bytes/s per device
    ici_bw: float               # bytes/s per link

    def roofline(self, flops: float, hbm_bytes: float,
                 collective_bytes: float) -> dict:
        """The three analytic time terms, their max (perfect-overlap
        bound), and the dominant term's name."""
        t_c = flops / self.peak_flops
        t_m = hbm_bytes / self.hbm_bw
        t_x = collective_bytes / self.ici_bw
        dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
                  key=lambda kv: kv[1])
        return {"t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
                "bound_s": dom[1], "dominant": dom[0]}


# one x86 host core with AVX FMA is O(100) GFLOP/s f32 and O(20) GB/s to
# DRAM -- honest single-process defaults, so CPU runs land at plausible
# (sub-1) achieved fractions
CPU_HOST = HardwareSpec("cpu_host", peak_flops=1e11, hbm_bw=2e10,
                        ici_bw=1e10)
# NVIDIA's data sheet for the H100 SXM (dense rates, at the full 700 W
# power limit), not measured here: float32 outside the tensor cores, HBM3,
# and NVLink 4's 900 GB/s a card counted as 450 GB/s a direction. The SDCA
# walks and every CoCoA+ round run float32 on the SIMT pipes; the bf16 spec
# prices the LM kernels on the tensor cores.
H100_SXM = HardwareSpec("h100_sxm", peak_flops=67e12, hbm_bw=3.35e12,
                        ici_bw=450e9)
H100_SXM_BF16 = HardwareSpec("h100_sxm_bf16", peak_flops=989e12,
                             hbm_bw=3.35e12, ici_bw=450e9)

HARDWARE = {h.name: h for h in (CPU_HOST, H100_SXM, H100_SXM_BF16)}


def get_hardware(name: str) -> HardwareSpec:
    if name not in HARDWARE:
        raise KeyError(f"unknown hardware spec {name!r}; "
                       f"have {sorted(HARDWARE)}")
    return HARDWARE[name]


def default_hardware(device=DEFAULT_DEVICE) -> HardwareSpec:
    """The spec of `device` (the card by default): `CPU_HOST` on the CPU,
    `H100_SXM` on a card whose name holds "H100". Any other card raises
    rather than being priced with another part's peaks; pass `hw=`
    explicitly to price it anyway."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CPU_HOST
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return H100_SXM
    raise ValueError(f"no HardwareSpec for the card {name!r}; have "
                     f"{sorted(HARDWARE)} (pass hw= explicitly)")


# ----------------------------------------------------------------------------
# the profile record
# ----------------------------------------------------------------------------

_NUMERIC = (int, float)
_PROF_SCHEMA: dict = {
    "schema": (int,),
    "kind": (str,),                 # "kernel" | "round"
    "name": (str,),                 # what was profiled (sparse_sdca, ...)
    "backend": (str,),              # torch device type at measure time
    "hw": (str,),                   # HardwareSpec the fractions use
    "shape": (dict,),               # free-form static params (nk, d, ...)
    "iters": (int,),                # fenced timing iterations
    "wall_s": _NUMERIC,             # measured fenced seconds per call
    "compile_s": _NUMERIC,          # one-time build + load seconds
    "flops": _NUMERIC,              # analytic
    "dot_flops": _NUMERIC,
    "hbm_bytes": _NUMERIC,
    "collective_bytes": _NUMERIC,   # per-device wire bytes
    "t_compute_s": _NUMERIC,        # three-term analytic roofline on hw
    "t_memory_s": _NUMERIC,
    "t_collective_s": _NUMERIC,
    "bound_s": _NUMERIC,            # max of the three (perfect overlap)
    "dominant": (str,),
    "achieved_flops": _NUMERIC,     # flops / wall_s
    "achieved_bw": _NUMERIC,        # hbm_bytes / wall_s
    "flops_frac": _NUMERIC,         # achieved_flops / hw peak
    "bw_frac": _NUMERIC,            # achieved_bw / hw peak
    "model_vs_measured": _NUMERIC,  # bound_s / wall_s  (1 = honest model)
    "round_global": (int, type(None)),  # round profiles: the paired
                                        # RoundRecord's round_global
}
_PROF_KINDS = ("kernel", "round")


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """One profiled computation, frozen: measured wall-clock next to the
    analytic cost and its roofline placement on a `HardwareSpec`."""
    kind: str
    name: str
    backend: str
    hw: str
    shape: dict
    iters: int
    wall_s: float
    compile_s: float
    flops: float
    dot_flops: float
    hbm_bytes: float
    collective_bytes: float
    t_compute_s: float
    t_memory_s: float
    t_collective_s: float
    bound_s: float
    dominant: str
    achieved_flops: float
    achieved_bw: float
    flops_frac: float
    bw_frac: float
    model_vs_measured: float
    round_global: Optional[int] = None
    schema: int = PROF_SCHEMA_VERSION

    def to_dict(self) -> dict:
        out = {"schema": self.schema}
        for key in _PROF_SCHEMA:
            if key == "schema":
                continue
            out[key] = getattr(self, key)
        return out

    @staticmethod
    def from_dict(d: dict) -> "KernelProfile":
        return KernelProfile(**validate_profile(d))


def validate_profile(d: Any) -> dict:
    """Schema gate for one profile dict; returns it or raises ValueError
    with the first violation (mirrors `metrics.validate_record`)."""
    if not isinstance(d, dict):
        raise ValueError(f"profile must be a dict, got {type(d).__name__}")
    unknown = set(d) - set(_PROF_SCHEMA)
    if unknown:
        raise ValueError(f"unknown profile fields: {sorted(unknown)}")
    for key, types in _PROF_SCHEMA.items():
        if key not in d:
            raise ValueError(f"profile missing field {key!r}")
        if not isinstance(d[key], types) or isinstance(d[key], bool):
            raise ValueError(
                f"field {key!r} wants {'/'.join(t.__name__ for t in types)}, "
                f"got {type(d[key]).__name__}")
    if d["schema"] != PROF_SCHEMA_VERSION:
        raise ValueError(
            f"profile schema {d['schema']} != {PROF_SCHEMA_VERSION}")
    if d["kind"] not in _PROF_KINDS:
        raise ValueError(f"kind must be one of {_PROF_KINDS}, "
                         f"got {d['kind']!r}")
    for key in ("wall_s", "compile_s", "flops", "dot_flops", "hbm_bytes",
                "collective_bytes", "bound_s"):
        if not np.isfinite(d[key]) or d[key] < 0:
            raise ValueError(f"{key} must be finite and >= 0")
    if d["iters"] < 1:
        raise ValueError("iters must be >= 1")
    if d["dot_flops"] > d["flops"]:
        raise ValueError("dot_flops cannot exceed total flops")
    if d["kind"] == "round" and d["round_global"] is None:
        raise ValueError("round profiles must carry round_global")
    return d


# ----------------------------------------------------------------------------
# assembly + the measuring harness
# ----------------------------------------------------------------------------

def build_profile(name: str, stats: dict, wall_s: float, *,
                  kind: str = "kernel", backend: Optional[str] = None,
                  hw: Optional[HardwareSpec] = None, shape: dict = None,
                  iters: int = 1, compile_s: float = 0.0,
                  round_global: Optional[int] = None) -> KernelProfile:
    """Assemble a `KernelProfile` from an analytic cost dict (`flops`,
    `dot_flops`, `hbm_bytes`, `collective_wire_bytes`: `obs.cost`'s keys)
    and a measured wall-clock. Pure (no timing). `backend` is the torch
    device type measured on, the port's default device's when None."""
    if backend is None:
        backend = resolve_device(DEFAULT_DEVICE).type
    hw = hw or default_hardware(backend)
    flops = float(stats.get("flops", stats.get("dot_flops", 0.0)))
    hbm = float(stats["hbm_bytes"])
    coll = float(stats.get("collective_wire_bytes", 0.0))
    roof = hw.roofline(flops, hbm, coll)
    wall = float(wall_s)
    achieved_f = flops / wall if wall > 0 else 0.0
    achieved_b = hbm / wall if wall > 0 else 0.0
    return KernelProfile(
        kind=kind, name=name, backend=backend, hw=hw.name,
        shape=dict(shape or {}), iters=int(iters), wall_s=wall,
        compile_s=float(compile_s), flops=flops,
        dot_flops=float(stats.get("dot_flops", 0.0)), hbm_bytes=hbm,
        collective_bytes=coll, round_global=round_global,
        achieved_flops=achieved_f, achieved_bw=achieved_b,
        flops_frac=achieved_f / hw.peak_flops,
        bw_frac=achieved_b / hw.hbm_bw,
        model_vs_measured=roof["bound_s"] / wall if wall > 0 else 0.0,
        **roof)


def analyze_jit(fn, *args, **kwargs) -> tuple:
    """(fn, stats, compile_s): `fn` itself (eager PyTorch has no compiled
    executable), the `launch.hlo_analysis.full_stats` of one call of
    `fn(*args, **kwargs)` counted on the tensors it runs on, and that
    call's seconds (the card synchronized), where the reference's is the
    lower + compile time. The counted call runs `fn` once, with its side
    effects."""
    from ..launch.hlo_analysis import count_step
    devs = cuda_devices((args, kwargs))
    device = devs[0] if devs else torch.device("cpu")
    synchronize(device)
    t0 = time.perf_counter()
    _, stats, _ = count_step(fn, *args, **kwargs)
    synchronize(device)
    return fn, stats, time.perf_counter() - t0


def profile_fn(fn, *args, stats: Optional[dict] = None, name: str,
               shape: dict = None, hw: Optional[HardwareSpec] = None,
               iters: int = 3, warmup: int = 1, kind: str = "kernel",
               kernels=(), **kwargs) -> KernelProfile:
    """The harness: `fn(*args, **kwargs)`'s steady-state time (CUDA events
    on the card its tensors live on, the host clock on the CPU) next to
    its analytic cost `stats`, in one record; without `stats`,
    `analyze_jit` counts them on a first call, whose seconds join
    `compile_s`. `kernels` names the kernel libraries `fn` launches;
    their build and load is `compile_s` (`metrics.aot_compile`)."""
    devs = cuda_devices((args, kwargs))
    device = devs[0] if devs else torch.device("cpu")
    compile_s = aot_compile(kernels, device)
    if stats is None:
        _, stats, first_s = analyze_jit(fn, *args, **kwargs)
        compile_s += first_s
    wall = fenced_time(fn, *args, iters=iters, warmup=warmup, **kwargs)
    return build_profile(name, stats, wall, kind=kind, backend=device.type,
                         hw=hw or default_hardware(device), shape=shape,
                         iters=iters, compile_s=compile_s)


# ----------------------------------------------------------------------------
# pairing with the RoundRecord stream
# ----------------------------------------------------------------------------

class RoundProfileSink:
    """EventBus sink that mirrors each `RoundRecord` with a `KernelProfile`
    (kind="round"): measured wall is the record's fenced per-round execute
    time; the analytic cost is the round's (`obs.cost.round_stats`,
    computed once by the caller -- `cocoa_train --profile`). The two
    streams share `round_global`, the key `repro_torch.obs.validate
    --prof` checks. `device` is where the rounds run (the card by
    default); `hw` defaults to its spec."""

    def __init__(self, path, stats: dict, *, name: str = "cocoa_round",
                 hw: Optional[HardwareSpec] = None, shape: dict = None,
                 compile_s: float = 0.0, device=DEFAULT_DEVICE):
        from .events import JsonlSink
        self._sink = JsonlSink(path)
        self.path = self._sink.path
        self.stats = stats
        self.name = name
        self.backend = resolve_device(device).type
        self.hw = hw or default_hardware(device)
        self.shape = dict(shape or {})
        self._compile_s = compile_s          # reported on the first profile
        self.profiles = []

    def emit(self, record) -> None:
        wall = record.execute_s / max(record.rounds_in_record, 1)
        prof = build_profile(
            self.name, self.stats, wall, kind="round", backend=self.backend,
            hw=self.hw, shape=self.shape, iters=record.rounds_in_record,
            compile_s=self._compile_s, round_global=record.round_global)
        self._compile_s = 0.0
        self.profiles.append(prof)
        self._sink.emit(prof)

    def close(self) -> None:
        self._sink.close()
