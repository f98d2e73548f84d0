"""Worker-topology descriptors and reduce plans. Port of
`repro.comm.topology`.

Three flavors share the dataclass:

  * `simulated(K)` -- the vmap backend's K simulated workers, on the
    leading axis of every tensor;
  * `from_mesh(mesh, data_axis, model_axis)` on a one-card mesh -- the
    shard_map backend laid onto one card: K = the data axes' sizes
    multiplied (a tuple of axes is a mixed radix, the last fastest),
    M = the model axis's size, and w is the padded (M d_local,) vector
    whose M slices are the model shards. A reduce of (K, M d_local)
    deltas over K is then the per-model-shard reduce, K messages of
    d_local floats for each shard;
  * `from_mesh` on a process mesh (`launch.mesh.make_process_mesh`) --
    one rank per (worker, model shard). The rank's tensors hold its own
    worker (a leading axis of 1) and its own d_local slice, and every
    cross-worker step is a collective over the rank's data row
    (`comm.collectives`, gloo): flat is one all_reduce; hier:<g> an
    all_reduce within the rank's pod of g consecutive workers, then one
    across the pods; a2a a reduce_scatter and an all_gather; compressed
    gather all_gathers the (idx, val) sets, merged at the pod boundary
    under hier. `data_sum` / `model_sum` reduce over the data row / the
    model column, and are the identity on one card.

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

On a process mesh the reduce kinds reach the same sum in the
association of their collectives: gloo's all_reduce sums in an order of
its own, so the process mesh matches the one-card rounds to float32
rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from . import collectives
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
    data_axes: Tuple[str, ...] = ("data",)
    mesh: object = dataclasses.field(default=None, compare=False,
                                     repr=False)   # the mesh it reads

    def __post_init__(self):
        if self.reduce not in REDUCE_KINDS:
            raise ValueError(f"unknown reduce kind {self.reduce!r}; "
                             f"use one of {REDUCE_KINDS}")
        if self.reduce == "hier":
            g = self.group
            if not 2 <= g <= self.K or self.K % g:
                raise ValueError(
                    f"hier group {g} must divide K={self.K} (2 <= g <= K)")
            if self.mesh is not None and len(self.data_axes) > 1:
                self._check_trailing_group()

    @staticmethod
    def simulated(K: int, topology: Optional[str] = None) -> "Topology":
        """K workers on the leading tensor axis."""
        kind, g = parse_reduce(topology)
        return Topology(K=K, reduce=kind, group=g)

    @staticmethod
    def from_mesh(mesh, data_axis: Union[str, Tuple[str, ...]] = "data",
                  model_axis: Optional[str] = None,
                  topology: Optional[str] = None) -> "Topology":
        """Workers = the data axes' sizes multiplied; model shards = the
        model axis's size (1 when `model_axis` is None). On a process
        mesh every axis must be a data axis or the model axis."""
        daxes = ((data_axis,) if isinstance(data_axis, str)
                 else tuple(data_axis))
        K = 1
        for a in daxes:
            if a not in mesh.shape:
                raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no "
                                 f"data axis {a!r}")
            K *= mesh.shape[a]
        M = 1
        if model_axis is not None:
            if model_axis not in mesh.shape:
                raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no "
                                 f"model axis {model_axis!r}")
            M = mesh.shape[model_axis]
        if getattr(mesh, "is_process", False):
            used = daxes + ((model_axis,) if model_axis else ())
            if tuple(a for a in mesh.axis_names if a in used) != used or \
                    set(used) != set(mesh.axis_names):
                raise ValueError(
                    f"a process mesh's axes {mesh.axis_names} must be the "
                    f"data axes {daxes} then the model axis {model_axis!r}, "
                    f"in the mesh's order")
        kind, g = parse_reduce(topology)
        return Topology(K=K, M=M, model_axis=model_axis, reduce=kind,
                        group=g, data_axes=daxes, mesh=mesh)

    def _check_trailing_group(self):
        """On a mixed-radix mesh a pod must be a block of the trailing
        data axes (the reference's `_hier_axis_split`)."""
        sizes = [self.mesh.shape[a] for a in self.data_axes]
        prod = 1
        for s in reversed(sizes):
            prod *= s
            if prod == self.group:
                return
            if prod > self.group:
                break
        raise ValueError(
            f"hier group {self.group} must equal a trailing product of the "
            f"data-axis sizes {dict(zip(self.data_axes, sizes))}")

    def wspec(self, d: int) -> WSpec:
        """The placement of a d-feature w under this topology."""
        return WSpec(d=d, M=self.M,
                     model_axis=self.model_axis if self.M > 1 else None)

    def d_local(self, d: int) -> int:
        """Floats of w each worker moves per reduce, per model shard."""
        return self.wspec(d).d_local

    # -- the process form ------------------------------------------------

    @property
    def process(self) -> bool:
        """Whether the workers are ranks of a process mesh (this process
        holds one worker's model shard) rather than tensor rows."""
        return getattr(self.mesh, "is_process", False)

    @property
    def worker(self) -> int:
        """This rank's worker: the mixed-radix index over the data axes
        (0 off a process mesh)."""
        if not self.process:
            return 0
        at, w = self.mesh.coords(), 0
        for a in self.data_axes:
            w = w * self.mesh.shape[a] + at[a]
        return w

    @property
    def model_index(self) -> int:
        """This rank's model shard (0 off a process mesh or at M = 1)."""
        if not self.process or self.model_axis is None:
            return 0
        return self.mesh.coords()[self.model_axis]

    def _ranks(self, workers, m: int):
        """The ranks of `workers` on model shard m."""
        shape = self.mesh.shape
        out = []
        for w in workers:
            at = {} if self.model_axis is None else {self.model_axis: m}
            for a in reversed(self.data_axes):
                w, at[a] = divmod(w, shape[a])
            out.append(self.mesh.rank_at(at))
        return out

    def _hier_groups(self):
        """(this rank's pod: g consecutive workers on its model shard, the
        ranks holding its position in every pod)."""
        K, g = self.K, self.group
        parts_intra, parts_inter = [], []
        for m in range(self.M):
            parts_intra += [self._ranks(range(p * g, (p + 1) * g), m)
                            for p in range(K // g)]
            parts_inter += [self._ranks(range(j, K, g), m)
                            for j in range(g)]
        key = (self.data_axes, self.model_axis, g)
        return (self.mesh.partition_group(("hier-intra",) + key,
                                          parts_intra),
                self.mesh.partition_group(("hier-inter",) + key,
                                          parts_inter))

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the workers of this rank's data row (a rank's rows are
        replicated over the model axis); the identity on one card."""
        if not self.process:
            return t
        return collectives.all_reduce(t, self.mesh.subgroup(self.data_axes))

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the model shards of this rank's worker (a w slice is
        replicated over the data axes); the identity on one card. The
        feature-sharded solvers' per-step partial-dot completion."""
        if not self.process or self.M == 1:
            return t
        return collectives.all_reduce(t, self.mesh.subgroup(
            (self.model_axis,)))

    def worker_stack(self, t: torch.Tensor) -> torch.Tensor:
        """A (K, ...) tensor of every worker's row: the data row's ranks'
        (1, ...) `t` gathered on a process mesh, `t` itself on one card."""
        if not self.process:
            return t
        return collectives.all_gather(t[0],
                                      self.mesh.subgroup(self.data_axes))

    # -- reduces ---------------------------------------------------------

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-worker sum of a (K, ...) tensor routed per the reduce
        kind; on (K, M, d_local) messages, each model shard's reduce. On
        a process mesh `x` is the rank's (1, ...) message."""
        if self.process:
            return self._process_sum(x[0])
        if self.reduce == "hier":
            xg = x.reshape((self.K // self.group, self.group) + x.shape[1:])
            return torch.sum(torch.sum(xg, dim=1), dim=0)
        return torch.sum(x, dim=0)

    def _process_sum(self, v: torch.Tensor) -> torch.Tensor:
        row = self.mesh.subgroup(self.data_axes)
        if self.reduce == "hier":
            intra, inter = self._hier_groups()
            return collectives.all_reduce(
                collectives.all_reduce(v, intra), inter)
        if self.reduce == "a2a":
            flat = v.reshape(-1)
            n = flat.shape[0]
            flat = torch.nn.functional.pad(flat, (0, (-n) % self.K))
            chunk = collectives.reduce_scatter(flat, row)
            full = collectives.all_gather(chunk, row).reshape(-1)
            return full[:n].reshape(v.shape)
        return collectives.all_reduce(v, row)

    def gather_sets(self, idx: torch.Tensor, val: torch.Tensor, d: int,
                    stats: Optional[dict] = None):
        """Gather the K workers' (idx, val) sets (K, k) for `decode_sum`.

        Under hier each pod of g consecutive workers merges its g sets
        (`compress.merge_sets`), so the inter hop forwards at most g k live
        pairs, fewer whenever the workers' index sets overlap;
        `stats["inter_gather"]` then receives the measured post-dedup inter
        volume in floats per round (2 words per live pair, summed over the
        pods), as a 0-d tensor. Flat and a2a return the sets as they are.
        Merged duplicate slots sit at the sentinel index d with value 0.

        On a process mesh `idx`/`val` are the rank's (1, k) set and the
        sets come from the data row's ranks; there the measured volume is
        also averaged over the model shards, as `exchange` does on one
        card."""
        if self.process:
            return self._process_gather(idx[0], val[0], d, stats)
        if self.reduce != "hier":
            return idx, val
        g = self.group
        gi = idx.reshape((self.K // g, g) + idx.shape[1:])
        gv = val.reshape((self.K // g, g) + val.shape[1:])
        mi, mv, uniq = merge_sets(gi, gv, d)
        if stats is not None:
            stats["inter_gather"] = 2 * torch.sum(uniq)
        return mi, mv

    def _process_gather(self, idx, val, d, stats):
        if self.reduce != "hier":
            row = self.mesh.subgroup(self.data_axes)
            return (collectives.all_gather(idx, row),
                    collectives.all_gather(val, row))
        intra, inter = self._hier_groups()
        mi, mv, uniq = merge_sets(collectives.all_gather(idx, intra),
                                  collectives.all_gather(val, intra), d)
        if stats is not None:
            # every rank of a pod holds the pod's count: the row's sum
            # counts each pod g times
            wire = self.data_sum(2 * uniq) // self.group
            stats["inter_gather"] = self.model_sum(wire) // self.M
        return (collectives.all_gather(mi, inter),
                collectives.all_gather(mv, inter))

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
