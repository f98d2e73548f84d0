"""Runtime of the port (`repro.runtime` counterpart).

    elastic    -- re-split the (K, nk, ...) layout onto K' workers, on the
                  tensors' device (`repartition`, `repartition_features`)
    failures   -- the dual-safe drop of a lost worker and the rebuild of v
                  from the surviving duals (`fail_and_recover`)
    straggler  -- per-worker step budgets from measured throughput
                  (`ThroughputTracker`, `budget_fn_from_rates`,
                  `budget_fn_from_tracker`)
"""
from . import elastic, failures, straggler
