"""Worker-topology descriptors and reduce plans. Port of
`repro.comm.topology`.

The K workers live on the leading axis of every tensor. Two flavors share
the dataclass:

  * `simulated(K)` -- the vmap backend's K simulated workers;
  * `from_mesh(mesh, data_axis, model_axis)` -- the shard_map backend laid
    onto one card: K = the data axis's size, M = the model axis's size,
    and w is the padded (M d_local,) vector whose M slices are the model
    shards. A reduce of (K, M d_local) deltas over K is then the per-model-
    shard reduce, K messages of d_local floats for each shard.

On top of the flavor sits the reduce kind, from a spec string:

    flat      one sum over every worker (the paper's eq.-14 reduce)
    hier:<g>  two-level: a sum over groups of g consecutive workers, then
              across the K/g group sums -- the multi-pod layout where only
              pod aggregates cross pods
    a2a       all-to-all: reduce-scatter then all-gather, the bandwidth-
              optimal 2(K-1)/K d schedule

All kinds compute the same sum; the hier kind in its own association
(groups first, the reference's (K/g, g) reshape-sum). The a2a sum on one
card is the flat sum: each worker's 1/K chunk summed and the chunks
concatenated is elementwise the flat sum, as the reference's simulated
flavor says. What changes between kinds is the wire plan, `hops()`, which
`comm.tracer.CommTracer` turns into per-round volume.

Everything here runs on one card. The collectives across processes -- the
reference's grouped `all_gather`s and `psum_scatter` inside shard_map --
are not ported: they belong to the multi-process backend (ROADMAP.md
Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .compress import merge_sets
from .placement import WSpec

REDUCE_KINDS = ("flat", "hier", "a2a")


@dataclasses.dataclass(frozen=True)
class Hop:
    """One stage of a reduce plan, as the wire model sees it: `messages`
    wire messages per round (summed over all senders) of
    `floats_per_message` equivalent f32 floats each. `axis` names the mesh
    direction the hop crosses ("data" for the Delta-v reduce, "model" for
    the feature-sharded solver's partial-dot exchange)."""
    name: str
    messages: int
    floats_per_message: int
    axis: str = "data"

    @property
    def floats(self) -> int:
        return self.messages * self.floats_per_message


def parse_reduce(spec: Optional[str]) -> Tuple[str, int]:
    """Reduce kind and group size from a topology spec string:
    "flat" | "hier:<g>" | "a2a" (None / "" -> flat)."""
    if spec in (None, "", "flat"):
        return "flat", 0
    if spec == "a2a":
        return "a2a", 0
    if isinstance(spec, str) and spec.startswith("hier:"):
        g = int(spec.split(":", 1)[1])
        if g < 2:
            raise ValueError(f"hier group must be >= 2, got {g}")
        return "hier", g
    raise ValueError(f"unknown topology {spec!r}; "
                     f"use 'flat', 'hier:<g>', or 'a2a'")


@dataclasses.dataclass(frozen=True)
class Topology:
    K: int                              # number of CoCoA workers
    M: int = 1                          # model shards of w
    model_axis: Optional[str] = None    # the mesh axis carrying them
    reduce: str = "flat"                # "flat" | "hier" | "a2a"
    group: int = 0                      # hier intra-group size (divides K)

    def __post_init__(self):
        if self.reduce not in REDUCE_KINDS:
            raise ValueError(f"unknown reduce kind {self.reduce!r}; "
                             f"use one of {REDUCE_KINDS}")
        if self.reduce == "hier":
            g = self.group
            if not 2 <= g <= self.K or self.K % g:
                raise ValueError(
                    f"hier group {g} must divide K={self.K} (2 <= g <= K)")

    @staticmethod
    def simulated(K: int, topology: Optional[str] = None) -> "Topology":
        """K workers on the leading tensor axis."""
        kind, g = parse_reduce(topology)
        return Topology(K=K, reduce=kind, group=g)

    @staticmethod
    def from_mesh(mesh, data_axis: str = "data",
                  model_axis: Optional[str] = None,
                  topology: Optional[str] = None) -> "Topology":
        """Workers = the data axis's size; model shards = the model axis's
        size (1 when `model_axis` is None)."""
        if data_axis not in mesh.shape:
            raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no data "
                             f"axis {data_axis!r}")
        M = 1
        if model_axis is not None:
            if model_axis not in mesh.shape:
                raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no "
                                 f"model axis {model_axis!r}")
            M = mesh.shape[model_axis]
        kind, g = parse_reduce(topology)
        return Topology(K=mesh.shape[data_axis], M=M, model_axis=model_axis,
                        reduce=kind, group=g)

    def wspec(self, d: int) -> WSpec:
        """The placement of a d-feature w under this topology."""
        return WSpec(d=d, M=self.M,
                     model_axis=self.model_axis if self.M > 1 else None)

    def d_local(self, d: int) -> int:
        """Floats of w each worker moves per reduce, per model shard."""
        return self.wspec(d).d_local

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-worker sum of a (K, ...) tensor routed per the reduce
        kind; on (K, M, d_local) messages, each model shard's reduce."""
        if self.reduce == "hier":
            xg = x.reshape((self.K // self.group, self.group) + x.shape[1:])
            return torch.sum(torch.sum(xg, dim=1), dim=0)
        return torch.sum(x, dim=0)

    def gather_sets(self, idx: torch.Tensor, val: torch.Tensor, d: int,
                    stats: Optional[dict] = None):
        """Gather the K workers' (idx, val) sets (K, k) for `decode_sum`.

        Under hier each pod of g consecutive workers merges its g sets
        (`compress.merge_sets`), so the inter hop forwards at most g k live
        pairs, fewer whenever the workers' index sets overlap;
        `stats["inter_gather"]` then receives the measured post-dedup inter
        volume in floats per round (2 words per live pair, summed over the
        pods), as a 0-d tensor. Flat and a2a return the sets as they are.
        Merged duplicate slots sit at the sentinel index d with value 0."""
        if self.reduce != "hier":
            return idx, val
        g = self.group
        gi = idx.reshape((self.K // g, g) + idx.shape[1:])
        gv = val.reshape((self.K // g, g) + val.shape[1:])
        mi, mv, uniq = merge_sets(gi, gv, d)
        if stats is not None:
            stats["inter_gather"] = 2 * torch.sum(uniq)
        return mi, mv

    def hops(self, f_msg: int, d_local: int,
             f_set: Optional[int] = None) -> Tuple[Hop, ...]:
        """The round's reduce plan for the tracer. `f_msg` is the
        compressor's dense wire model per worker message, `d_local` the
        dense floats each worker owns, `f_set` the floats in one sparse
        (idx, val) set when compressed gather is on (None: dense reduce).
        Up-link counting:

            flat        reduce          K f_msg
            hier:g      intra           K f_msg        (within pods)
                        inter           K/g f_msg      (pod aggregates)
            a2a         reduce_scatter  K (K-1) ceil(f_msg / K)
                        all_gather      K (K-1) ceil(d_local / K)
            gather      flat, a2a       K f_set
                        hier:g intra    K f_set, inter K/g (g f_set)
        """
        K, g = self.K, self.group
        if f_set is not None:
            if self.reduce == "hier":
                return (Hop("intra_gather", K, f_set),
                        Hop("inter_gather", K // g, g * f_set))
            return (Hop("gather", K, f_set),)
        if self.reduce == "hier":
            return (Hop("intra", K, f_msg), Hop("inter", K // g, f_msg))
        if self.reduce == "a2a":
            return (Hop("reduce_scatter", K, (K - 1) * (-(-f_msg // K))),
                    Hop("all_gather", K, (K - 1) * (-(-d_local // K))))
        return (Hop("reduce", K, f_msg),)
