"""CoCoA+ framework driver (paper Algorithm 1), generalized over g(w).

Port of `repro.core.cocoa`. One outer round:
    1. every worker k solves the sigma'-damped local subproblem (eq. 9)
       Theta-approximately -- all K at once, in one kernel launch on the
       kernel solvers,
    2. communicates Delta v_k = du_k / sigma', compressed with error
       feedback and reduced or gathered per the topology (comm.exchange),
    3. the driver applies v <- v + gamma sum_k Delta v_k,
       alpha <- alpha + gamma Delta alpha (comm.apply_update).

The shared state is the scaled dual-side vector v = A alpha / (tau n),
kept under its historical name `w`; the primal iterate is
reg.conj_grad(v) (`primal_w`), the identity under L2.

Two backends, as in the reference:

    "vmap"       K simulated workers on the leading tensor axis
    "shard_map"  a (data=K, model=M) mesh (`launch.mesh.make_test_mesh`)
                 laid onto one card: K workers, and w feature-sharded into
                 M slices of d_local = ceil(d / M) (`comm.WSpec`) when the
                 data is a `FeatureShards`. Each step's partial dots are
                 summed over the M shards (the eager `sdca_sparse`), or the
                 sparse kernel runs its z-exchange schedule; the per-round
                 reduce is then one d_local-float message per worker per
                 shard. At M = 1 it is the vmap round on the same tensors.

Visit orders. The reference derives every worker's coordinate order from
a threefry key carried in its state. torch cannot reproduce threefry, so
the port's state carries no key: round r draws its orders from a CPU
`torch.Generator` seeded with (seed, r), and `solve(visit_orders=...)`
lets a caller supply them instead -- the parity tests feed the reference's
own permutations and index streams through it. The wire compressors'
draws (rand-k's index sets, QSGD's uniforms) work the same way: a second
generator seeded with (seed, r), or `solve(comm_draws=...)`.

Communication accounting comes from `comm.CommTracer`: the topology's
reduce plan priced by the compressor's wire model, plus the solver's
model-axis hops on a feature-sharded mesh, with hier gather's measured
post-dedup inter volume (`CoCoAState.wire`) in place of its bound. Under
compression the carried v drifts from v(alpha), so every certificate is
`duality.gap_at_v` at the carried v, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import comm
from ..data import sparse as sparse_data
from ..data.sparse import FeatureShards, SparseShards
from ..device import DEFAULT_DEVICE, resolve_device, synchronize
from . import duality
from .losses import get_loss
from .regularizers import Regularizer, get_regularizer
from .solvers import (LocalSolver, SOLVERS, get_solver, importance_probs,
                      sparse_counterpart)


@dataclasses.dataclass(frozen=True)
class CoCoAConfig:
    loss: str = "hinge"
    lam: float = 1e-4
    gamma: float = 1.0                 # aggregation parameter in (0, 1]
    sigma_p: Optional[float] = None    # None -> safe bound gamma * K (Lemma 4)
    H: int = 1000                      # local solver iterations per round
    solver: str = "sdca"               # core.solvers.SOLVERS key
    backend: str = "vmap"              # "vmap" | "shard_map"
    data_axis: str = "data"            # mesh axis carrying the workers
    model_axis: Optional[str] = None   # mesh axis feature-sharding w
    average_iterates: bool = False     # Theorem-8 averaged iterate output
    aggregator: Optional[str] = None   # "add"|"average"|"gamma:<g>" strategy;
                                       # overrides (gamma, sigma_p) when set
    reg: str = "l2"                    # "l2" | "elastic:<eta>" | "l1s:<eps>"
    compress: str = "none"             # comm.compress scheme for Delta v_k
    compress_k: int = 0                # sparsifier budget for topk/randk
    topology: str = "flat"             # reduce plan: "flat"|"hier:<g>"|"a2a"
    gather: bool = False               # compressed sparse gather: the reduce
                                       # moves (idx, val) sets, ~2kK floats

    def agg_params(self, K: int) -> comm.AggParams:
        """The (gamma, sigma') pair this config runs with at K workers."""
        return comm.from_config(self.gamma, self.sigma_p, K,
                                aggregator=self.aggregator)

    def regularizer(self) -> Regularizer:
        return get_regularizer(self.reg)

    def compressor(self, M: int = 1) -> comm.Compressor:
        """The wire compressor. Under compressed gather on a feature-
        sharded mesh (M > 1) the sparsifier's budget k is split over the M
        model shards (ceil(k/M) slots, the remainder to low shards), so
        the gathered volume stays ~2kK floats a round at any M. The dense
        reduce form is not split: each shard's d/M message already
        shrinks with M."""
        comp = comm.resolve_compressor(self.compress, self.compress_k)
        if self.gather and not comp.supports_gather:
            raise ValueError(
                f"gather=True needs a sparse-set compressor (topk/randk); "
                f"compress={self.compress!r} only has a dense wire form")
        if M > 1 and self.gather:
            comp = comp.with_shards(M)
        return comp

    @staticmethod
    def averaging(K: int, **kw) -> "CoCoAConfig":
        """Original CoCoA (Remark 12)."""
        return CoCoAConfig(gamma=1.0 / K, sigma_p=1.0, **kw)

    @staticmethod
    def adding(K: int, **kw) -> "CoCoAConfig":
        """CoCoA+ with the safe bound sigma' = K."""
        return CoCoAConfig(gamma=1.0, sigma_p=float(K), **kw)


class CoCoAState(NamedTuple):
    w: torch.Tensor          # (d,) the scaled dual-side vector v
    alpha: torch.Tensor      # (K, nk) partitioned duals
    rounds: int              # rounds run so far
    alpha_bar: torch.Tensor  # (K, nk) running sum for the averaged iterate
    ef: torch.Tensor         # (K, d) error-feedback residuals
    wire: Optional[torch.Tensor] = None
                             # measured post-dedup inter_gather floats of
                             # the last round (hier compressed gather only)


def init_state(d: int, K: int, nk: int, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> CoCoAState:
    dev = resolve_device(device)
    return CoCoAState(
        w=torch.zeros((d,), dtype=dtype, device=dev),
        alpha=torch.zeros((K, nk), dtype=dtype, device=dev),
        rounds=0,
        alpha_bar=torch.zeros((K, nk), dtype=dtype, device=dev),
        ef=comm.init_residual(K, d, dtype, dev),
    )


def state_from_reference(arrays: Dict[str, np.ndarray],
                         device=DEFAULT_DEVICE) -> CoCoAState:
    """The port's state from a reference `repro.core.cocoa.CoCoAState`'s
    leaves converted to numpy (`w`, `alpha`, `rounds`, `alpha_bar`, `ef`,
    and `wire` when the reference run carried one).

    The reference's threefry key (`rng`) is dropped: the port carries no
    key, and a resumed run draws its visit orders from its own generator
    (or from `solve`'s `visit_orders` hook)."""
    dev = resolve_device(device)

    def t(name):
        # np.array copies: the leaves may be read-only views of device arrays
        return torch.from_numpy(np.array(arrays[name], np.float32)).to(dev)

    wire = arrays.get("wire")
    return CoCoAState(w=t("w"), alpha=t("alpha"),
                      rounds=int(np.asarray(arrays["rounds"])),
                      alpha_bar=t("alpha_bar"), ef=t("ef"),
                      wire=None if wire is None else torch.as_tensor(
                          int(np.asarray(wire)), device=dev))


def primal_w(state: CoCoAState, cfg: CoCoAConfig) -> torch.Tensor:
    """The primal iterate the run serves: w = grad g*(tau v)."""
    return cfg.regularizer().conj_grad(state.w, cfg.lam)


def resolve_solver(name, sparse: bool,
                   feature_sharded: bool = False) -> LocalSolver:
    """Resolve a registry key against the round's input format through the
    LocalSolver capability flags: dense inputs need `dense`, SparseShards
    map through `sparse_counterpart`, and a feature-sharded mesh (M > 1)
    needs `model_axis`."""
    ls = get_solver(name)
    if not sparse:
        if not ls.dense:
            raise ValueError(
                f"solver {ls.name!r} needs SparseShards inputs; dense "
                f"tensors take 'sdca' / 'sdca_kernel' (mapped automatically "
                f"when the data is sparse)")
        resolved = ls
    else:
        twin = sparse_counterpart(ls)
        if twin is None:
            raise ValueError(
                f"solver {ls.name!r} has no sparse path; pick one of "
                f"{sorted(n for n in SOLVERS if sparse_counterpart(n))} "
                f"for SparseShards inputs")
        resolved = get_solver(twin)
    if feature_sharded and not resolved.model_axis:
        raise ValueError(
            f"solver {resolved.name!r} cannot run feature-sharded (M>1): "
            f"use 'sdca_sparse' (eager) or 'sdca_sparse_kernel' (the "
            f"z-exchange schedule) on FeatureShards")
    return resolved


def visit_shape(solver: LocalSolver, K: int, nk: int, H: int):
    """Shape of the visit input `solver` takes for one round (None: it
    takes none)."""
    if solver.visit == "none":
        return None
    return (K, nk) if solver.visit == "permutation" else (K, H)


def _round_generator(seed: int, round_index: int,
                     salt: int = 0) -> torch.Generator:
    """The CPU generator of round `round_index`'s draws; `salt` keeps the
    wire compressor's stream apart from the visit orders'."""
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + int(round_index) + salt) % (2 ** 63))


_COMM_SALT = 0x5EED * 1_000_003 ** 2


def draw_visit_orders(solver: LocalSolver, K: int, nk: int, H: int,
                      seed: int, round_index: int,
                      probs: Optional[torch.Tensor] = None):
    """One round's visit input from a CPU generator seeded with
    (seed, round_index): (K, nk) permutations, (K, H) uniform row ids, or
    (K, H) row ids drawn from `probs` (K, nk) for the importance kind;
    None for a solver that takes none."""
    if solver.visit == "none":
        return None
    gen = _round_generator(seed, round_index)
    if solver.visit == "permutation":
        return torch.stack([torch.randperm(nk, generator=gen)
                            for _ in range(K)])
    if solver.visit == "importance":
        if probs is None:
            raise ValueError(f"solver {solver.name!r} draws its rows from "
                             f"the importance distribution; pass probs")
        return torch.multinomial(probs.cpu(), H, replacement=True,
                                 generator=gen)
    return torch.randint(0, nk, (K, H), generator=gen)


def draw_comm(comp: comm.Compressor, K: int, d_msg: int, seed: int,
              round_index: int):
    """One round's wire-compressor draws for K workers' d_msg-float
    messages (None for the deterministic schemes)."""
    return comp.draw(K, d_msg, _round_generator(seed, round_index,
                                                _COMM_SALT))


def _dims(X):
    """(K, nk, width of the state's w, dtype, device)."""
    if isinstance(X, FeatureShards):
        K, _, nk = X.cols.shape[:3]
        return K, nk, X.d_padded, X.vals.dtype, X.device
    if isinstance(X, SparseShards):
        K, nk = X.cols.shape[:2]
        return K, nk, X.d, X.vals.dtype, X.device
    K, nk, d = X.shape
    return K, nk, d, X.dtype, X.device


def _round(cfg: CoCoAConfig, topo: comm.Topology, solver: LocalSolver,
           n: float) -> Callable[..., CoCoAState]:
    """`round_fn(state, X, y, mask, order, sqnorms=None, budget=None,
    draws=None)`: every worker solves in one solver call -- one kernel
    launch on the kernel solvers -- then the exchange (compress, reduce or
    gather) and the update. On a feature-sharded topology the solver also
    gets the model axis and the global row norms: `sqnorms` when the
    caller computed them once for the run (`solve` does), else computed
    here; a solver flagged `sqnorms` takes them when given. `budget` goes
    to a deadline solver (None: H); `draws` are the compressor's."""
    loss = get_loss(cfg.loss)
    reg = cfg.regularizer()
    p = cfg.agg_params(topo.K)
    compressor = cfg.compressor(topo.M)
    feature_sharded = topo.M > 1

    def round_fn(state: CoCoAState, X, y, mask, order,
                 sqnorms: Optional[torch.Tensor] = None, budget=None,
                 draws=None) -> CoCoAState:
        kw = {}
        if feature_sharded:
            if sqnorms is None:
                sqnorms = sparse_data.row_sqnorms(X) * mask
            kw = dict(sqnorms=sqnorms, model_axis=cfg.model_axis)
        elif solver.sqnorms and sqnorms is not None:
            kw = dict(sqnorms=sqnorms)
        if solver.deadline:
            kw["budget"] = budget
        # `order` goes in as given (on the host when drawn here): the
        # kernel solvers range-check it there before copying it over
        res = solver.fn(X, y, state.alpha, mask, state.w, order, loss,
                        cfg.lam, n, p.sigma_prime, cfg.H, reg=reg, **kw)
        stats = {}
        dw_sum, ef = comm.exchange(topo, res.du, state.ef, p, compressor,
                                   gather=cfg.gather, stats=stats,
                                   draws=draws)
        w, alpha = comm.apply_update(state.w, state.alpha, dw_sum,
                                     res.dalpha, p)
        return CoCoAState(w, alpha, state.rounds + 1,
                          state.alpha_bar + alpha, ef,
                          stats.get("inter_gather"))

    return round_fn


def make_round(cfg: CoCoAConfig, K: int, sparse: bool,
               n: float) -> Callable[..., CoCoAState]:
    """The simulated K-worker round (`make_round_vmap`'s counterpart). `n`
    is the global effective row count; `round_fn(state, X, y, mask,
    order)` takes the round's visit input `order` (see `visit_shape`)."""
    return _round(cfg, comm.Topology.simulated(K, cfg.topology),
                  resolve_solver(cfg.solver, sparse), n)


def _mesh_topology(cfg: CoCoAConfig, mesh) -> comm.Topology:
    return comm.Topology.from_mesh(mesh, cfg.data_axis, cfg.model_axis,
                                   topology=cfg.topology)


def make_round_sharded(cfg: CoCoAConfig, mesh, sparse: bool,
                       n: float) -> Callable[..., CoCoAState]:
    """The mesh round on one card (`make_round_sharded`'s counterpart): K
    workers from the mesh's data axis, M model shards from its model axis.
    At M > 1 the round takes `FeatureShards` and the padded w, and the
    exchange runs per model shard; at M = 1 it is the simulated round
    (`place_on_mesh` turns M = 1 FeatureShards into SparseShards)."""
    topo = _mesh_topology(cfg, mesh)
    return _round(cfg, topo, resolve_solver(cfg.solver, sparse,
                                            feature_sharded=topo.M > 1), n)


def place_on_mesh(cfg: CoCoAConfig, mesh, X):
    """Check X against the mesh and return what the rounds take: the
    reference's guards (M mismatch, SparseShards at M > 1), the data on the
    mesh's device, and M = 1 FeatureShards as SparseShards. Dense data at
    M > 1 is not ported."""
    topo = _mesh_topology(cfg, mesh)
    K, _, _, _, dev = _dims(X)
    if K != topo.K:
        raise ValueError(f"the data has K={K} workers but the mesh's data "
                         f"axis {cfg.data_axis!r} has {topo.K}")
    if dev.type != mesh.device.type:
        raise ValueError(f"the data lives on {dev}, the mesh on "
                         f"{mesh.device}")
    if isinstance(X, FeatureShards):
        if X.M != topo.M:
            raise ValueError(f"FeatureShards sliced for M={X.M} but the "
                             f"mesh's model axis carries M={topo.M}")
        return X.model_shard_view() if topo.M == 1 else X
    if topo.M > 1:
        if isinstance(X, SparseShards):
            raise ValueError(
                "feature sharding (M>1) needs FeatureShards with "
                "shard-local column ids; slice the shards with "
                "data.sparse.shard_features (or partition_sparse with M=...)")
        raise ValueError("dense feature sharding (M>1) is not ported yet: "
                         "ROADMAP.md Queue 1 item 10")
    return X


class SolveResult(NamedTuple):
    state: CoCoAState
    history: dict   # lists per certified round: round, gap, primal, dual,
                    # comm_vectors, comm_floats, comm_bytes, comm_psums
                    # (cumulative, `CommTracer.totals`), execute_s,
                    # certificate_s
    tracer: Optional[comm.CommTracer] = None   # the run's wire plan and
                                               # its measured hops


def solve(cfg: CoCoAConfig, X, y, mask, *, rounds: int, eps_gap: float = 0.0,
          seed: int = 0, gap_every: int = 1,
          state: Optional[CoCoAState] = None,
          visit_orders: Optional[Callable[[int], torch.Tensor]] = None,
          comm_draws: Optional[Callable[[int], torch.Tensor]] = None,
          budget_fn: Optional[Callable[[int], object]] = None,
          mesh=None) -> SolveResult:
    """Run CoCoA+/CoCoA until `rounds` or duality gap <= eps_gap.

    `X` is a dense (K, nk, d) tensor or a `SparseShards`, on the device the
    run uses; on the shard_map backend (with `mesh`) also a
    `FeatureShards`, whose state w is the padded (M d_local,) vector.
    `visit_orders(t) -> order` supplies round t's visit input (0-based
    within this call): (K, nk) permutations for the kernel solvers, (K, H)
    row ids for the eager ones; every model shard of worker k walks row k
    of it. By default each round draws its own (`draw_visit_orders`).
    `comm_draws(t)` supplies round t's compressor draws the same way
    (`draw_comm`). `budget_fn(t) -> (K,)` gives a deadline solver its
    per-worker step budgets (without it, H).

    History, one entry per certified round (every `gap_every` rounds and
    the last): `round`, `gap`, `primal`, `dual`, the tracer's cumulative
    `comm_vectors`, `comm_floats`, `comm_bytes` and `comm_psums`,
    `execute_s` (host seconds of the rounds since the previous entry, each
    fenced by a device synchronize) and `certificate_s` (the same for the
    gap computation). `comm_floats` prices the topology's reduce plan with
    the compressor's wire model per model shard, plus the solver's
    model-axis hops on a feature-sharded mesh.
    """
    if cfg.backend == "shard_map":
        if mesh is None:
            raise ValueError("the shard_map backend needs a mesh "
                             "(launch.mesh.make_test_mesh)")
        X = place_on_mesh(cfg, mesh, X)
        topo = _mesh_topology(cfg, mesh)
    elif cfg.backend == "vmap":
        if isinstance(X, FeatureShards):
            raise ValueError("FeatureShards need the shard_map backend on "
                             "a 2-D mesh; the vmap reference runs on "
                             "SparseShards with the global column ids")
        topo = comm.Topology.simulated(_dims(X)[0], cfg.topology)
    else:
        raise ValueError(f"unknown backend {cfg.backend!r}; use 'vmap' or "
                         f"'shard_map'")
    K, nk, d, dtype, dev = _dims(X)
    sparse = isinstance(X, (SparseShards, FeatureShards))
    loss = get_loss(cfg.loss)
    reg = cfg.regularizer()
    n = float(duality.effective_n(mask))
    if cfg.backend == "shard_map":
        round_fn = make_round_sharded(cfg, mesh, sparse, n)
    else:
        round_fn = make_round(cfg, K, sparse, n)
    solver = resolve_solver(cfg.solver, sparse,
                            feature_sharded=topo.M > 1)
    want = visit_shape(solver, K, nk, cfg.H)
    if state is None:
        state = init_state(d, K, nk, dtype, dev)
    d_true = X.d if sparse else d
    d_local = topo.d_local(d_true)
    compressor = cfg.compressor(topo.M)
    tracer = comm.CommTracer.for_run(
        K=K, d_local=d_local, compressor=compressor, topo=topo,
        gather=cfg.gather,
        extra_hops=(solver.model_hop(X, cfg.H, reg) if topo.M > 1 else ()))
    sqnorms = probs = None
    if topo.M > 1:
        # the global row norms, fixed for the run
        sqnorms = sparse_data.row_sqnorms(X) * mask
    elif solver.sqnorms and not sparse:
        sqnorms = torch.sum(X * X, dim=-1) * mask
    if solver.visit == "importance":
        probs = importance_probs(X, mask)
    compressed = cfg.compress not in (None, "", "none")

    hist = {"round": [], "gap": [], "primal": [], "dual": [],
            "comm_vectors": [], "comm_floats": [], "comm_bytes": [],
            "comm_psums": [], "execute_s": [], "certificate_s": []}
    exec_acc = 0.0
    base_round = state.rounds
    for t in range(rounds):
        t0 = time.perf_counter()
        if visit_orders is not None and want is not None:
            order = visit_orders(t)
            if tuple(order.shape) != want:
                raise ValueError(f"visit_orders({t}) gave shape "
                                 f"{tuple(order.shape)}; solver "
                                 f"{solver.name!r} takes {want}")
        else:
            order = draw_visit_orders(solver, K, nk, cfg.H, seed,
                                      base_round + t, probs)
        draws = (comm_draws(t) if comm_draws is not None else
                 draw_comm(compressor, K, d_local, seed, base_round + t))
        budget = budget_fn(t) if budget_fn is not None else None
        state = round_fn(state, X, y, mask, order, sqnorms, budget, draws)
        synchronize(dev)
        exec_acc += time.perf_counter() - t0
        tracer.tick()
        if state.wire is not None:
            # hier compressed gather: the measured post-dedup inter volume
            # replaces the hop's analytic bound
            tracer.observe("inter_gather", state.wire)
        if (t + 1) % gap_every and t != rounds - 1:
            continue
        alpha_eval = state.alpha
        if cfg.average_iterates:
            alpha_eval = state.alpha_bar / max(state.rounds, 1)
        t0 = time.perf_counter()
        if compressed:
            # lossy messages let the carried v drift from v(alpha): certify
            # the primal point the run holds
            pval, dval, g = duality.gap_at_v(state.w, alpha_eval, X, y,
                                             mask, loss, cfg.lam, reg)
        else:
            pval, dval, g = duality.gap_decomposed(alpha_eval, X, y, mask,
                                                   loss, cfg.lam, reg)
        gap = float(g)
        cert_s = time.perf_counter() - t0
        hist["round"].append(t + 1)
        hist["gap"].append(gap)
        hist["primal"].append(float(pval))
        hist["dual"].append(float(dval))
        for key, value in tracer.totals().items():
            hist[key].append(value)
        hist["execute_s"].append(exec_acc)
        hist["certificate_s"].append(cert_s)
        exec_acc = 0.0
        if gap <= eps_gap:
            break
    return SolveResult(state, hist, tracer)
