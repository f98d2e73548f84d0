"""Communication layer of the port: the (gamma, sigma') aggregation
strategies, the dense exchange step, the flat reduce (simulated, or per
model shard on a one-card mesh), the w placement `WSpec` and the identity
compressor (`repro.comm` counterparts)."""
from .aggregate import (AggParams, Aggregator, Add, Average, GammaInterp,
                        apply_update, exchange, from_config)
from .aggregate import resolve as resolve_aggregator
from .compress import NoCompression, init_residual
from .placement import WSpec
from .topology import Topology
