"""Event bus + sinks: the generalization of `solve()`'s `on_round` hook.

Port of `repro.obs.events`. `core.cocoa.solve` emits one
`metrics.RoundRecord` per certified round; an `EventBus` fans each record
out to composable sinks in subscription order. The bundled sinks:

  * `JsonlSink` -- one schema-versioned JSON object per line, flushed
    per record so a crashed run keeps every certified round (validated
    by `python -m repro_torch.obs.validate`).
  * `Aggregator` -- in-process rollup: p50/p99 round latency, wire
    floats/sec, rounds-to-gap, and the `history()` view that rebuilds
    `solve`'s history dict from the records (`solve` builds its return
    value from an internal `Aggregator`).
  * `ProfilerSink` -- a `torch.profiler` trace (CPU and CUDA activities)
    from its creation to `close()`, exported as a Chrome trace. With the
    `record_function` ranges in `core.cocoa` (`cocoa_round` per round,
    `cocoa/local_solve`, `cocoa/exchange`, `cocoa/certificate`) the
    timeline shows solver, exchange and certificate regions per round
    and the kernels launched inside them.

A sink is anything with `emit(record)` (plain callables work too --
`bus.subscribe(print)` is valid); `close()` is optional. Sinks must not
mutate records (`RoundRecord` is frozen). Exceptions propagate: a broken
sink fails the run loudly rather than silently dropping telemetry.
"""
from __future__ import annotations

import json
import pathlib
from typing import List, Optional, Union

from .metrics import Histogram, RoundRecord


class EventBus:
    """Ordered fan-out of round records to sinks."""

    def __init__(self):
        self._sinks: List = []
        self.emitted = 0

    def subscribe(self, sink):
        """Register a sink (object with `emit(record)`, or a callable);
        returns the sink so `agg = bus.subscribe(Aggregator())` reads
        naturally. Emission order is subscription order."""
        if not (hasattr(sink, "emit") or callable(sink)):
            raise TypeError(f"sink {sink!r} has no emit() and is not callable")
        self._sinks.append(sink)
        return sink

    def emit(self, record: RoundRecord) -> RoundRecord:
        self.emitted += 1
        for sink in self._sinks:
            if hasattr(sink, "emit"):
                sink.emit(record)
            else:
                sink(record)
        return record

    def close(self) -> None:
        for sink in self._sinks:
            if hasattr(sink, "close"):
                sink.close()


class JsonlSink:
    """One schema-versioned JSON record per line, flushed per record.

    Accepts any record with a `to_dict()` (RoundRecord, `prof.
    KernelProfile`) or a plain dict -- one sink class for every schema
    the obs package emits."""

    def __init__(self, path: Union[str, pathlib.Path]):
        self.path = pathlib.Path(path)
        self._fh = None

    def emit(self, record) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("w")
        d = record if isinstance(record, dict) else record.to_dict()
        self._fh.write(json.dumps(d) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class Aggregator:
    """In-process rollup of the round records seen so far.

    Round latency percentiles are over per-round execute seconds (each
    record's fenced `execute_s` divided by the rounds it covers, one
    sample per covered round, so `gap_every > 1` runs weight rounds
    equally). `history()` rebuilds the dict `solve` used to assemble
    inline -- same keys, same Python floats/ints.
    """

    def __init__(self):
        self.records: List[RoundRecord] = []
        self.round_latency_s = Histogram("round_latency_s")

    def emit(self, record: RoundRecord) -> None:
        self.records.append(record)
        per_round = record.execute_s / record.rounds_in_record
        for _ in range(record.rounds_in_record):
            self.round_latency_s.observe(per_round)

    # -- scalar rollups ------------------------------------------------------

    @property
    def last(self) -> Optional[RoundRecord]:
        return self.records[-1] if self.records else None

    @property
    def final_gap(self) -> float:
        return self.records[-1].gap if self.records else float("inf")

    @property
    def rounds(self) -> int:
        """Rounds covered by the records (within one solve call this is
        the last in-call round; across calls, the sum of coverage)."""
        return sum(r.rounds_in_record for r in self.records)

    @property
    def total_execute_s(self) -> float:
        return sum(r.execute_s for r in self.records)

    @property
    def total_compile_s(self) -> float:
        return sum(r.compile_s for r in self.records)

    @property
    def total_wire_floats(self) -> int:
        return sum(r.wire_floats for r in self.records)

    def floats_per_sec(self) -> float:
        ex = self.total_execute_s
        return self.total_wire_floats / ex if ex > 0 else float("nan")

    def rounds_to_gap(self, target: float) -> Optional[int]:
        """First certified in-call round at which gap <= target (the
        paper's rounds-to-eps metric), or None if never reached."""
        for r in self.records:
            if r.gap <= target:
                return r.round
        return None

    # -- views ---------------------------------------------------------------

    def history(self) -> dict:
        """The solve-compatible history dict, derived purely from the
        records: round/gap/primal/dual per certified round plus the
        cumulative comm totals snapshot each record carried."""
        hist = {"round": [], "gap": [], "primal": [], "dual": [],
                "comm_vectors": [], "comm_floats": [], "comm_bytes": [],
                "comm_psums": []}
        for r in self.records:
            hist["round"].append(r.round)
            hist["gap"].append(r.gap)
            hist["primal"].append(r.primal)
            hist["dual"].append(r.dual)
            for key in ("comm_vectors", "comm_floats", "comm_bytes",
                        "comm_psums"):
                hist[key].append(r.comm[key])
        return hist

    def summary(self) -> dict:
        lat = self.round_latency_s.summary()
        last = self.last
        return {
            "rounds": self.rounds,
            "final_round": last.round_global if last else 0,
            "final_gap": self.final_gap,
            "final_primal": last.primal if last else float("nan"),
            "final_dual": last.dual if last else float("nan"),
            "compile_s": self.total_compile_s,
            "execute_s": self.total_execute_s,
            "certificate_s": sum(r.certificate_s for r in self.records),
            "round_p50_s": lat["p50"],
            "round_p99_s": lat["p99"],
            "wire_floats": self.total_wire_floats,
            "wire_floats_per_sec": self.floats_per_sec(),
        }

    def format_summary(self) -> str:
        """The trainer's end-of-run block -- every number from the
        certified records, one source of truth."""
        s = self.summary()
        if not self.records:
            return "obs: no certified rounds recorded"
        lines = [
            (f"final: P={s['final_primal']:.6f} D={s['final_dual']:.6f} "
             f"gap={s['final_gap']:.3e} at round {s['final_round']} "
             f"(certificate: primal suboptimality <= gap)"),
            (f"time: compile {s['compile_s']:.2f}s + execute "
             f"{s['execute_s']:.2f}s + certify {s['certificate_s']:.2f}s; "
             f"round p50 {1e3 * s['round_p50_s']:.1f}ms "
             f"p99 {1e3 * s['round_p99_s']:.1f}ms"),
            (f"wire: {s['wire_floats']} floats total, "
             f"{s['wire_floats_per_sec']:.3g} floats/s sustained"),
        ]
        return "\n".join(lines)


class ProfilerSink:
    """`torch.profiler` trace over the run: starts on construction (so a
    kernel's first build and launch are captured), stops on `close()` and
    writes a Chrome trace to `trace_path` (`<logdir>/trace.json`; open it
    in Perfetto or chrome://tracing). Records CPU ranges and, where torch
    has CUDA, the card's kernels and copies. The `record_function` ranges
    `core.cocoa` opens (`cocoa_round`, `cocoa/local_solve`,
    `cocoa/exchange`, `cocoa/certificate`) mark each round's regions.

    On the card the session opens and closes with a burst of `BURST`
    tiny kernels in an `obs/profiler_burst` range: on an H100 host,
    late in a long process, a session has lost its first 19-65 device
    records -- the first round's kernels, without the burst
    (`chip_smoke.py` phase 18, PR 19's runs "diag18" and "diag18b").

    Never fails the run, as the reference's: a profiler error prints a
    note and disables the sink (`disabled` then holds the message)."""

    TRACE_NAME = "trace.json"
    BURST = 256

    def __init__(self, logdir: Union[str, pathlib.Path]):
        self.logdir = pathlib.Path(logdir)
        self.trace_path = self.logdir / self.TRACE_NAME
        self.disabled: Optional[str] = None
        self._prof = None
        try:
            from torch.profiler import (ProfilerActivity, profile,
                                        supported_activities)
            have = supported_activities()
            acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                    if a in have]
            self._prof = profile(activities=acts)
            self._prof.start()
            self._burst()
        except Exception as e:                        # pragma: no cover
            self._disable("profiler trace disabled", e)

    def _burst(self) -> None:
        """BURST one-element adds on the current card, then a synchronize
        (nothing on the CPU, where no device record can be lost)."""
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        with torch.profiler.record_function("obs/profiler_burst"):
            z = torch.zeros(1, device="cuda")
            for _ in range(self.BURST):
                z.add_(1)
            torch.cuda.synchronize()

    def _disable(self, what: str, e: Exception) -> None:
        self._prof = None
        self.disabled = f"{what}: {e}"
        print(f"[obs] {self.disabled}")

    def emit(self, record: RoundRecord) -> None:
        pass                         # the regions are ranges in core.cocoa

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        try:
            self._burst()
            prof.stop()
            self.logdir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(self.trace_path))
        except Exception as e:                        # pragma: no cover
            self._disable("profiler stop failed", e)
