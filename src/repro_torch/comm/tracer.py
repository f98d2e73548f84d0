"""Per-round communication accounting. Port of `repro.comm.tracer`.

The unit of accounting is the topology's reduce plan: a tuple of
`topology.Hop`s, each saying how many messages that hop carries per round
and how many equivalent f32 floats each holds (the compressor's wire model
applied to the d_local floats a worker owns). `core.cocoa.solve` builds
its `comm_floats` history from here, and the trainer prints `per_hop()`.

The uncompressed flat model is `floats(t) = t K d_local`; under top-k it
is `t K 2k`; hierarchical plans carry two hops whose floats sum to the
end-to-end volume (each wire message counted in exactly one hop).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .compress import Compressor, NoCompression
from .placement import WSpec
from .topology import Hop, Topology


def model_hops(wspec: WSpec, K: int, H: int,
               zx_plan: Optional[dict] = None) -> Tuple[Hop, ...]:
    """The feature-sharded solver's model-axis wire plan; empty while w is
    replicated.

    Eager path (`zx_plan` None): one partial dot per coordinate step, so
    every one of the K M (worker, shard) pairs sends H floats a round.
    z-exchange kernel path: `zx_plan` is `kernels.ops.sparse_zx_plan`'s
    dict, and each pair sends `exchanges` vectors of `block_rows` floats."""
    if not wspec.sharded:
        return ()
    if zx_plan is not None:
        return (Hop("model_zx", K * wspec.M,
                    int(zx_plan["exchanges"]) * int(zx_plan["block_rows"]),
                    axis="model"),)
    return (Hop("model_z", K * wspec.M, H, axis="model"),)


def accel_hops(accel: str = "none") -> Tuple[Hop, ...]:
    """Outer momentum's wire plan: empty for every scheme (the
    extrapolation is elementwise on each worker's own w shard)."""
    return ()


@dataclasses.dataclass
class CommTracer:
    """Counts rounds and converts them to wire volume through the hop plan.

    Bytes are 4 floats (values and int32 indices are both 4-byte words);
    `psums` counts collectives, one per hop. A hop whose analytic floats
    are only an upper bound (hier's inter_gather after dedup) can be fed
    measured per-round volumes through `observe`; totals then use the
    measurement for that hop. `extra_hops` carries the model-axis hops of
    a feature-sharded solver, and `per_axis` splits the bill by mesh
    direction."""
    K: int
    hops: Tuple[Hop, ...]
    rounds: int = 0
    measured: dict = dataclasses.field(default_factory=dict)
    # the most recent single-round observation per hop (the running sum
    # lives in `measured`)
    round_measured: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def for_run(K: int, d_local: int,
                compressor: Optional[Compressor] = None,
                topo: Optional[Topology] = None,
                gather: bool = False,
                extra_hops: Tuple[Hop, ...] = ()) -> "CommTracer":
        """Tracer for a run: without `topo` one flat reduce hop of K
        messages; with it, the topology's reduce plan, in its
        compressed-gather form when `gather`. `extra_hops` appends hops
        outside the reduce plan (the model axis's partial dots)."""
        comp = compressor if compressor is not None else NoCompression()
        f_msg = comp.floats_per_message(d_local)
        if topo is None:
            hops = (Hop("reduce", K, f_msg),)
        else:
            f_set = comp.gather_floats(d_local) if gather else None
            hops = topo.hops(f_msg, d_local, f_set)
        return CommTracer(K=K, hops=hops + tuple(extra_hops))

    def tick(self, rounds: int = 1) -> None:
        self.rounds += rounds

    def observe(self, hop: str, floats) -> None:
        """Record one round's measured floats for `hop`; they accumulate,
        and every total below uses them in place of the hop's plan."""
        self.measured[hop] = self.measured.get(hop, 0) + int(floats)
        self.round_measured[hop] = int(floats)

    def _hop_floats(self, h: Hop) -> int:
        if h.name in self.measured:
            return self.measured[h.name]
        return self.rounds * h.floats

    # -- per-round plan ------------------------------------------------------

    @property
    def floats_per_round(self) -> int:
        return sum(h.floats for h in self.hops)

    @property
    def vectors_per_round(self) -> int:
        """Wire messages per round, over all hops."""
        return sum(h.messages for h in self.hops)

    @property
    def psums_per_round(self) -> int:
        return len(self.hops)

    # -- cumulative totals (as of the last tick) -----------------------------

    @property
    def vectors(self) -> int:
        return self.rounds * self.vectors_per_round

    @property
    def floats(self) -> int:
        return sum(self._hop_floats(h) for h in self.hops)

    @property
    def bytes(self) -> int:
        return 4 * self.floats

    @property
    def psums(self) -> int:
        return self.rounds * self.psums_per_round

    def totals(self) -> dict:
        """Snapshot for the history."""
        return {"comm_vectors": self.vectors, "comm_floats": self.floats,
                "comm_bytes": self.bytes, "comm_psums": self.psums}

    def per_round(self) -> dict:
        return {"floats": self.floats_per_round,
                "bytes": 4 * self.floats_per_round,
                "psums": self.psums_per_round}

    def per_hop(self) -> list:
        """Per-hop per-round breakdown; the analytic floats sum to
        per_round()['floats']. Measured hops also report
        'measured_floats' (the running sum) and 'measured_floats_round'
        (the last round's observation)."""
        out = []
        for h in self.hops:
            row = {"hop": h.name, "axis": h.axis, "messages": h.messages,
                   "floats_per_message": h.floats_per_message,
                   "floats": h.floats, "bytes": 4 * h.floats}
            if h.name in self.measured:
                row["measured_floats"] = self.measured[h.name]
                row["measured_floats_round"] = self.round_measured[h.name]
            out.append(row)
        return out

    def per_axis(self) -> dict:
        """Per-round floats split by mesh direction."""
        out: dict = {}
        for h in self.hops:
            out[h.axis] = out.get(h.axis, 0) + h.floats
        return out
