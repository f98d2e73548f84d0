"""Communication layer of the port (`repro.comm` counterpart):

    placement  -- WSpec: where the shared w lives (replicated, or M
                  feature shards on a one-card (data, model) mesh)
    topology   -- worker descriptors and the reduce plan (flat, hier:<g>,
                  a2a), compressed gather of sparse sets
    aggregate  -- the (gamma, sigma') strategies and the exchange / apply
                  round step
    compress   -- top-k / rand-k / QSGD / int8 with error feedback, the
                  SparseMessage gather wire form
    tracer     -- per-hop floats, bytes and collectives per round
"""
from .aggregate import (AggParams, Aggregator, Add, Average, GammaInterp,
                        apply_update, exchange, flush_ef, from_config)
from .aggregate import resolve as resolve_aggregator
from .compress import (Compressor, Int8, NoCompression, RandK, SparseMessage,
                       StochasticQuant, TopK, decode_sum, init_residual,
                       merge_sets)
from .compress import resolve as resolve_compressor
from .placement import WSpec
from .topology import Hop, Topology, parse_reduce
from .tracer import CommTracer, accel_hops, model_hops
