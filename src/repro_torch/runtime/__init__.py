"""Runtime of the port (`repro.runtime` counterpart).

    straggler  -- per-worker step budgets from measured throughput
                  (`ThroughputTracker`, `budget_fn_from_rates`,
                  `budget_fn_from_tracker`)

`failures` and `elastic` are ROADMAP.md Queue 1 item 12.
"""
from . import straggler
