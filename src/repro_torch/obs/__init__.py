"""Observability of the port (`repro.obs` counterpart): structured round
telemetry, timing traces, roofline profiles, dashboards.

    metrics   -- Counter/Gauge/Histogram, fenced timing (`fenced_call`
                 synchronizes the outputs' card before reading the host
                 clock, `fenced_time` times with CUDA events,
                 `aot_compile` prices the kernel libraries' build and
                 load), and the frozen schema-versioned `RoundRecord`
                 `core.cocoa.solve` emits per certified round
    events    -- the `EventBus` that generalizes `solve`'s `on_round`
                 callback into composable sinks: `JsonlSink` (one record
                 per line), `Aggregator` (p50/p99 latency, floats/sec,
                 rounds-to-gap, the history view), and `ProfilerSink`
                 (a torch.profiler Chrome trace with the `cocoa/*` ranges,
                 read back by `trace_events`; `lost_device_records`
                 counts the rounds' launches it lacks)
    dashboard -- zero-dependency live terminal dashboard
                 (`cocoa_train --dashboard`)
    validate  -- `python -m repro_torch.obs.validate run.jsonl` schema gate
                 for `cocoa_train --metrics-out`; also KernelProfile
                 streams and their `round_global` pairing (`--prof`)
    prof      -- `KernelProfile`: fenced measured wall-clock beside the
                 analytic cost and its roofline on a `HardwareSpec`
                 (`CPU_HOST`, `H100_SXM`, `H100_SXM_BF16`)
    cost      -- the analytic cost of a CoCoA+ round from its shapes (the
                 reference reads it off the lowered HLO)
    regress   -- `python -m repro_torch.obs.regress` perf-regression gate

The schemas are the reference's: a record or profile written by either
package passes both packages' validators.
"""
from .dashboard import Dashboard, sparkline
from .events import (Aggregator, EventBus, JsonlSink, ProfilerSink,
                     lost_device_records, trace_events)
from .metrics import (SCHEMA_VERSION, Counter, Gauge, Histogram, RoundRecord,
                      aot_compile, fenced_call, fenced_time, validate_record)
from .prof import (PROF_SCHEMA_VERSION, HardwareSpec, KernelProfile,
                   RoundProfileSink, build_profile, default_hardware,
                   get_hardware, profile_fn, validate_profile)
