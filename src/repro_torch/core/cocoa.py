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
    "shard_map"  a (data=K, model=M) mesh: K workers, and w feature-sharded
                 into M slices of d_local = ceil(d / M) (`comm.WSpec`) when
                 M > 1 -- dense rows padded to M d_local columns, or a
                 `FeatureShards`. Each step's partial dots are summed over
                 the M shards (the eager `sdca` / `sdca_sparse`), or the
                 sparse kernel runs its z-exchange schedule; the per-round
                 reduce is then one d_local-float message per worker per
                 shard. At M = 1 it is the vmap round on the same tensors.

The mesh is laid onto one card (`launch.mesh.make_test_mesh`: the workers
and shards on the tensors' axes, K blocks of one launch), or across
processes (`make_process_mesh`: one rank per (worker, shard)). On a
process mesh every rank keeps only its own block -- (1, nk, d_local)
dense rows, or its worker's ELL rows (its model shard's at M > 1) --
and its slices of the state; the round is the same `_round` on those,
the kernel solvers at K = 1, and every cross-worker sum is a collective
over the rank's data row (`comm.Topology`). Every rank draws the round's
global visit orders and wire draws from (seed, round) and takes its
worker's row, so the run is the one-process run on the same orders, and
every rank returns the same history.

Outer momentum (`CoCoAConfig.accel`, `core.accel`) wraps either
backend's round; the momentum leaves of `CoCoAState` are None without it.

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
import numbers
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import comm
from ..comm import collectives
from ..data import sparse as sparse_data
from ..data.sparse import FeatureShards, SparseShards
from ..device import DEFAULT_DEVICE, resolve_device
from ..obs.events import Aggregator, EventBus
from ..obs.metrics import RoundRecord, aot_compile, fenced_call
from . import duality
from .accel import AccelSpec, init_accel_state, parse_accel, wrap_round
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
    accel: str = "none"                # outer momentum (core.accel): "none"
                                       # | "nesterov[:R]" | "catalyst:<k>"

    def agg_params(self, K: int) -> comm.AggParams:
        """The (gamma, sigma') pair this config runs with at K workers."""
        return comm.from_config(self.gamma, self.sigma_p, K,
                                aggregator=self.aggregator)

    def regularizer(self) -> Regularizer:
        return get_regularizer(self.reg)

    def accel_spec(self) -> AccelSpec:
        """The parsed outer-momentum schedule this config runs with."""
        return parse_accel(self.accel)

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
    v_prev: Optional[torch.Tensor] = None      # core.accel: the last
    alpha_prev: Optional[torch.Tensor] = None  # round's (v, alpha) and the
    accel_a: Optional[torch.Tensor] = None     # catalyst scalar; None
                                               # while accel="none"


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
    and `wire` and the momentum leaves `v_prev`, `alpha_prev`, `accel_a`
    when the reference run carried them).

    The reference's threefry key (`rng`) is dropped: the port carries no
    key, and a resumed run draws its visit orders from its own generator
    (or from `solve`'s `visit_orders` hook)."""
    dev = resolve_device(device)

    def t(name):
        # np.array copies: the leaves may be read-only views of device arrays
        return torch.from_numpy(np.array(arrays[name], np.float32)).to(dev)

    def opt(name):
        return t(name) if arrays.get(name) is not None else None

    wire = arrays.get("wire")
    a = arrays.get("accel_a")
    return CoCoAState(w=t("w"), alpha=t("alpha"),
                      rounds=int(np.asarray(arrays["rounds"])),
                      alpha_bar=t("alpha_bar"), ef=t("ef"),
                      wire=None if wire is None else torch.as_tensor(
                          int(np.asarray(wire)), device=dev),
                      v_prev=opt("v_prev"), alpha_prev=opt("alpha_prev"),
                      accel_a=None if a is None else torch.as_tensor(
                          float(np.asarray(a)), dtype=torch.float32))


def state_to_tree(state: CoCoAState, seed: int = 0) -> dict:
    """The state as the reference's checkpoint leaves (`checkpoint.
    save_tree` writes them): `w`, `alpha`, `alpha_bar`, `ef`, `rounds` as
    a 0-d int32, the optional `wire`, `v_prev`, `alpha_prev` and `accel_a`
    where set, and `rng`, the reference's raw threefry key for `seed`
    (uint32 [seed >> 32, seed & 0xffffffff], `jax.random.PRNGKey(seed)`),
    so the reference trainer's restore template loads a port checkpoint.
    The port itself carries no key: its visit orders come from
    (seed, rounds), so a resumed run draws what an uninterrupted one
    would have."""
    key = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                   np.uint32)
    tree = {"w": state.w, "alpha": state.alpha, "rng": key,
            "rounds": np.array(state.rounds, np.int32),
            "alpha_bar": state.alpha_bar, "ef": state.ef}
    for name in ("wire", "v_prev", "alpha_prev", "accel_a"):
        if getattr(state, name) is not None:
            tree[name] = getattr(state, name)
    return tree


def state_from_tree(tree: dict, device=DEFAULT_DEVICE) -> CoCoAState:
    """The state from checkpoint leaves (`state_to_tree`'s, or a
    reference `CoCoAState._asdict()`'s as `restore_tree` reads them) on
    `device`; `rng` is dropped."""
    return state_from_reference(
        {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in tree.items()}, device)


def primal_w(state: CoCoAState, cfg: CoCoAConfig) -> torch.Tensor:
    """The primal iterate the run serves: w = grad g*(tau v)."""
    return cfg.regularizer().conj_grad(state.w, cfg.lam)


def reshard_w_state(state: CoCoAState, old: comm.WSpec, new: comm.WSpec,
                    params: comm.AggParams) -> CoCoAState:
    """Carry (w, ef) across a change of w's placement -- a replicated-w
    state moved onto a feature-sharded mesh, or a change of M. The EF
    residuals are un-transmitted message mass in the old placement's
    frame, so they are flushed into w first (`comm.flush_ef`); w is then
    lifted to the global frame and padded for the new placement, and the
    residuals start at zero at the new width."""
    if old.d != new.d:
        raise ValueError(f"placements disagree on the feature count: "
                         f"{old.d} vs {new.d}")
    w = comm.flush_ef(state.w, state.ef, params)
    w = new.pad_w(old.unpad_w(w))
    K = state.ef.shape[0]
    return state._replace(w=w, ef=comm.init_residual(
        K, new.d_padded, state.ef.dtype, state.ef.device))


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
            f"use 'sdca' (dense, eager), 'sdca_sparse' (ELL, eager), or "
            f"'sdca_sparse_kernel' (ELL kernel, z-exchange schedule)")
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


def global_row_sqnorms(X, mask, topo: Optional[comm.Topology] = None
                       ) -> torch.Tensor:
    """The rows' global ||x_i||^2 (K, nk), masked: on a feature-sharded
    mesh the slices' masses summed over the model shards (over the rank's
    model column on a process mesh)."""
    if isinstance(X, (SparseShards, FeatureShards)):
        sq = sparse_data.row_sqnorms(X)
    else:
        sq = torch.sum(X * X, dim=-1)
    return (sq if topo is None else topo.model_sum(sq)) * mask


def _round(cfg: CoCoAConfig, topo: comm.Topology, solver: LocalSolver,
           n: float) -> Callable[..., CoCoAState]:
    """`round_fn(state, X, y, mask, order, sqnorms=None, budget=None,
    draws=None)`: every worker solves in one solver call -- one kernel
    launch on the kernel solvers -- then the exchange (compress, reduce or
    gather) and the update. On a feature-sharded topology the solver also
    gets the model axis and the global row norms: `sqnorms` when the
    caller computed them once for the run (`solve` does), else computed
    here; a solver flagged `sqnorms` takes them when given. `budget` goes
    to a deadline solver (None: H); `draws` are the compressor's. On a
    process mesh every input is the rank's own (one worker, one shard)."""
    loss = get_loss(cfg.loss)
    reg = cfg.regularizer()
    p = cfg.agg_params(topo.K)
    compressor = cfg.compressor(topo.M)
    feature_sharded = topo.M > 1
    # the model axis as the solvers take it: the axis of the tensors on
    # one card, the model column's sum on a process mesh
    model_axis = topo.model_sum if topo.process else cfg.model_axis

    def round_fn(state: CoCoAState, X, y, mask, order,
                 sqnorms: Optional[torch.Tensor] = None, budget=None,
                 draws=None) -> CoCoAState:
        kw = {}
        if feature_sharded:
            if sqnorms is None:
                sqnorms = global_row_sqnorms(X, mask, topo)
            kw = dict(sqnorms=sqnorms, model_axis=model_axis)
            if solver.model_shards:
                kw["model_shards"] = topo.M
            if isinstance(X, torch.Tensor) and not topo.process:
                # dense rows on one card: the M slices on their own axis
                X = X.view(X.shape[0], X.shape[1], topo.M, -1)
        elif solver.sqnorms and sqnorms is not None:
            kw = dict(sqnorms=sqnorms)
        if solver.deadline:
            kw["budget"] = budget
        # `order` goes in as given (on the host when drawn here): the
        # kernel solvers range-check it there before copying it over
        with record_function("cocoa/local_solve"):
            res = solver.fn(X, y, state.alpha, mask, state.w, order, loss,
                            cfg.lam, n, p.sigma_prime, cfg.H, reg=reg, **kw)
        stats = {}
        with record_function("cocoa/exchange"):
            dw_sum, ef = comm.exchange(topo, res.du, state.ef, p,
                                       compressor, gather=cfg.gather,
                                       stats=stats, draws=draws)
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
    """The mesh round (`make_round_sharded`'s counterpart): K workers from
    the mesh's data axes, M model shards from its model axis. At M > 1
    the round takes padded dense rows or `FeatureShards` and the padded
    w, and the exchange runs per model shard; at M = 1 it is the
    simulated round (`place_on_mesh` turns M = 1 FeatureShards into
    SparseShards). On a process mesh it takes the rank's block
    (`place_on_mesh`) and runs its one worker."""
    topo = _mesh_topology(cfg, mesh)
    return _round(cfg, topo, resolve_solver(cfg.solver, sparse,
                                            feature_sharded=topo.M > 1), n)


def place_on_mesh(cfg: CoCoAConfig, mesh, X, y, mask):
    """Check the data against the mesh and return (X, y, mask) as the
    rounds take them: the reference's guards (M mismatch, SparseShards at
    M > 1), M = 1 FeatureShards as SparseShards, dense rows padded to
    M d_local columns at M > 1.

    On a process mesh the data may be all K workers (on any device) or
    this rank's worker alone (a leading axis of 1); only the rank's
    block goes to the mesh's device: (1, nk, d_local) dense rows, its
    worker's `SparseShards`, or at M > 1 its model shard's ELL slice as
    a `SparseShards` with shard-local ids."""
    topo = _mesh_topology(cfg, mesh)
    K, _, _, _, dev = _dims(X)
    if K != topo.K and not (topo.process and K == 1):
        raise ValueError(f"the data has K={K} workers but the mesh's data "
                         f"axis {cfg.data_axis!r} has {topo.K}")
    if not topo.process and dev.type != mesh.device.type:
        raise ValueError(f"the data lives on {dev}, the mesh on "
                         f"{mesh.device}")
    if isinstance(X, FeatureShards):
        if X.M != topo.M:
            raise ValueError(f"FeatureShards sliced for M={X.M} but the "
                             f"mesh's model axis carries M={topo.M}")
    elif topo.M > 1 and isinstance(X, SparseShards):
        raise ValueError(
            "feature sharding (M>1) needs FeatureShards with "
            "shard-local column ids; slice the shards with "
            "data.sparse.shard_features (or partition_sparse with M=...)")
    if not topo.process:
        if isinstance(X, FeatureShards):
            return (X.model_shard_view() if topo.M == 1 else X), y, mask
        if topo.M > 1 and isinstance(X, torch.Tensor):
            X = topo.wspec(X.shape[-1]).pad_cols(X)
        return X, y, mask
    rows = slice(topo.worker, topo.worker + 1) if K > 1 else slice(0, 1)
    m, to = topo.model_index, mesh.device

    def block(t):
        return t[rows].to(to).contiguous()

    if isinstance(X, FeatureShards):
        X = SparseShards(block(X.cols[:, m]), block(X.vals[:, m]),
                         block(X.nnz[:, m]), d=X.d_local)
    elif isinstance(X, SparseShards):
        X = SparseShards(block(X.cols), block(X.vals), block(X.nnz), d=X.d)
    else:
        X = topo.wspec(X.shape[-1]).slice_cols(X[rows], m).to(
            to).contiguous()
    return X, block(y), block(mask)


def gather_state(cfg: CoCoAConfig, mesh, state: CoCoAState) -> CoCoAState:
    """The global state from the ranks' blocks on a process mesh -- the
    one-card layout: alpha and alpha_bar (K, nk), w the padded
    (M d_local,) vector, ef (K, M d_local) -- gathered over the ranks'
    data rows and model columns (a collective: every rank calls it). Off
    a process mesh (or without a mesh), the state itself."""
    if mesh is None or not mesh.is_process:
        return state
    topo = _mesh_topology(cfg, mesh)

    def rows(t):                       # (1, ...) -> (K, ...)
        return None if t is None else topo.worker_stack(t)

    def cols(t):                       # (..., d_local) -> (..., M d_local)
        if t is None or topo.M == 1:
            return t
        g = collectives.all_gather(t, mesh.subgroup((topo.model_axis,)))
        return torch.movedim(g, 0, -2).reshape(t.shape[:-1] + (-1,))

    return state._replace(w=cols(state.w), alpha=rows(state.alpha),
                          alpha_bar=rows(state.alpha_bar),
                          ef=rows(cols(state.ef)), v_prev=cols(state.v_prev),
                          alpha_prev=rows(state.alpha_prev))


def state_block(cfg: CoCoAConfig, mesh, state: CoCoAState) -> CoCoAState:
    """`gather_state`'s inverse: this rank's block of a global state on a
    process mesh, on the mesh's device (its worker's rows and its model
    shard's slice, as `place_on_mesh` cuts the data). Off a process
    mesh (or without a mesh), the state itself."""
    if mesh is None or not mesh.is_process:
        return state
    topo = _mesh_topology(cfg, mesh)
    k, to = topo.worker, mesh.device
    d_local = state.w.shape[-1] // topo.M
    lo = topo.model_index * d_local

    def rows(t):
        return None if t is None else t[k:k + 1].to(to).contiguous()

    def cols(t):
        return None if t is None else t[..., lo:lo + d_local].to(
            to).contiguous()

    return state._replace(w=cols(state.w), alpha=rows(state.alpha),
                          alpha_bar=rows(state.alpha_bar),
                          ef=rows(cols(state.ef)), v_prev=cols(state.v_prev),
                          alpha_prev=rows(state.alpha_prev))


def _d_msg(X, topo: comm.Topology) -> int:
    """The floats a worker moves per shard: a rank's block is its slice."""
    d = _dims(X)[2]
    sparse = isinstance(X, (SparseShards, FeatureShards))
    return d if topo.process else topo.d_local(X.d if sparse else d)


def run_tracer(cfg: CoCoAConfig, X, topo: comm.Topology,
               solver: LocalSolver) -> comm.CommTracer:
    """The run's `comm.CommTracer`: the topology's reduce plan priced by
    the compressor's wire model, plus the solver's model-axis hops on a
    feature-sharded mesh. `X` is the data as the rounds take it
    (`place_on_mesh`)."""
    return comm.CommTracer.for_run(
        K=topo.K, d_local=_d_msg(X, topo), compressor=cfg.compressor(topo.M),
        topo=topo, gather=cfg.gather,
        extra_hops=(solver.model_hop(X, cfg.H, cfg.regularizer(), K=topo.K,
                                     M=topo.M)
                    if topo.M > 1 else ()) + comm.accel_hops(cfg.accel))


class SolveResult(NamedTuple):
    state: CoCoAState
    history: dict   # lists per certified round: round, gap, primal, dual,
                    # comm_vectors, comm_floats, comm_bytes, comm_psums
                    # (cumulative, `CommTracer.totals`), execute_s,
                    # certificate_s -- a view over the emitted RoundRecords
    tracer: Optional[comm.CommTracer] = None   # the run's wire plan and
                                               # its measured hops


def solve(cfg: CoCoAConfig, X, y, mask, *, rounds: int, eps_gap: float = 0.0,
          seed: int = 0, gap_every: int = 1,
          state: Optional[CoCoAState] = None,
          visit_orders: Optional[Callable[[int], torch.Tensor]] = None,
          comm_draws: Optional[Callable[[int], torch.Tensor]] = None,
          budget_fn: Optional[Callable[[int], object]] = None,
          mesh=None,
          on_round: Optional[Callable[[int, CoCoAState, float], None]] = None,
          obs: Optional[EventBus] = None,
          throughput=None) -> SolveResult:
    """Run CoCoA+/CoCoA until `rounds` or duality gap <= eps_gap.

    `X` is a dense (K, nk, d) tensor or a `SparseShards`, on the device the
    run uses; on the shard_map backend (with `mesh`) also a
    `FeatureShards`, and at M > 1 the state's w is the padded
    (M d_local,) vector. On a process mesh X, y and mask may live
    anywhere and hold all K workers or the rank's own (`place_on_mesh`);
    the state is the rank's slices.
    `visit_orders(t) -> order` supplies round t's visit input (0-based
    within this call): (K, nk) permutations for the kernel solvers, (K, H)
    row ids for the eager ones; every model shard of worker k walks row k
    of it. By default each round draws its own (`draw_visit_orders`).
    `comm_draws(t)` supplies round t's compressor draws the same way
    (`draw_comm`). `budget_fn(t) -> (K,)` gives a deadline solver its
    per-worker step budgets (without it, H). Every one of these is global
    (all K workers) on a process mesh too.

    Every certified round (every `gap_every` rounds and the last) emits
    one frozen, schema-versioned `obs.RoundRecord`: gap, primal, dual,
    the compile / execute / certificate split, the tracer's per-hop wire
    plan and cumulative totals, and the budgets and EMA rates when a
    `throughput` tracker (`runtime.straggler.ThroughputTracker`) is
    attached -- it is fed each round's steps and fenced seconds. `obs`
    (an `obs.EventBus`) receives every record; `on_round(t, state, gap)`
    is called after each. On a process mesh every rank emits its own
    records: the same certificates, its own clocks.

    The returned history is derived from the records
    (`obs.Aggregator.history()`): `round`, `gap`, `primal`, `dual`, the
    tracer's cumulative `comm_vectors`, `comm_floats`, `comm_bytes` and
    `comm_psums`, plus `execute_s` (host seconds of the rounds since the
    previous entry, each ended by a synchronize of the state's card) and
    `certificate_s` (the same for the gap computation). The first build
    and load of the solver's kernel library is the first record's
    `compile_s`, not part of its execute_s. `comm_floats` prices the
    topology's reduce plan with the compressor's wire model per model
    shard, plus the solver's model-axis hops on a feature-sharded mesh.
    Under compression or momentum the certificate is `gap_at_v` at the
    carried v (with the duals projected under momentum).

    The rounds open `torch.profiler` ranges: `cocoa_round` around each,
    `cocoa/local_solve` around the solver, `cocoa/exchange` around the
    exchange and update, `cocoa/certificate` around the gap
    (`obs.ProfilerSink` records them).
    """
    if cfg.backend == "shard_map":
        if mesh is None:
            raise ValueError("the shard_map backend needs a mesh "
                             "(launch.mesh.make_test_mesh)")
        X, y, mask = place_on_mesh(cfg, mesh, X, y, mask)
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
    K_here, nk, d, dtype, dev = _dims(X)
    K = topo.K
    sparse = isinstance(X, (SparseShards, FeatureShards))
    loss = get_loss(cfg.loss)
    reg = cfg.regularizer()
    n = float(duality.effective_n(mask, topo))
    if cfg.backend == "shard_map":
        base_round = make_round_sharded(cfg, mesh, sparse, n)
    else:
        base_round = make_round(cfg, K, sparse, n)
    aspec = cfg.accel_spec()
    round_fn = wrap_round(base_round, aspec)
    solver = resolve_solver(cfg.solver, sparse,
                            feature_sharded=topo.M > 1)
    want = visit_shape(solver, K, nk, cfg.H)
    if state is None:
        state = init_state(d, K_here, nk, dtype, dev)
    state = init_accel_state(state, aspec)
    d_local = _d_msg(X, topo)
    compressor = cfg.compressor(topo.M)
    tracer = run_tracer(cfg, X, topo, solver)
    sqnorms = probs = None
    if topo.M > 1:
        # the global row norms, fixed for the run
        sqnorms = global_row_sqnorms(X, mask, topo)
    elif solver.sqnorms and not sparse:
        sqnorms = torch.sum(X * X, dim=-1) * mask
    if solver.visit == "importance":
        probs = topo.worker_stack(importance_probs(X, mask))
    compressed = cfg.compress not in (None, "", "none")
    drifted = compressed or aspec.enabled
    # a rank takes its worker's row of every global draw
    mine = slice(topo.worker, topo.worker + 1) if topo.process else None

    agg = Aggregator()
    # the kernel library's first build and load, apart from the rounds
    from ..kernels.ops import round_libraries
    pending_compile = aot_compile(
        round_libraries(solver.name, topo.M, topo.process), dev)
    base = state.rounds
    exec_acc, covered, prev_floats = 0.0, 0, 0

    def one_round(t, state, budget):
        if visit_orders is not None and want is not None:
            order = visit_orders(t)
            if tuple(order.shape) != want:
                raise ValueError(f"visit_orders({t}) gave shape "
                                 f"{tuple(order.shape)}; solver "
                                 f"{solver.name!r} takes {want}")
        else:
            order = draw_visit_orders(solver, K, nk, cfg.H, seed,
                                      base + t, probs)
        draws = (comm_draws(t) if comm_draws is not None else
                 draw_comm(compressor, K, d_local, seed, base + t))
        if mine is not None:
            order = None if order is None else order[mine]
            draws = None if draws is None else draws[mine]
            if budget is not None and not isinstance(budget,
                                                     numbers.Integral):
                budget = torch.as_tensor(budget)[mine]
        return round_fn(state, X, y, mask, order, sqnorms, budget, draws)

    for t in range(rounds):
        budget = budget_fn(t) if budget_fn is not None else None
        with record_function("cocoa_round"):
            state, dt = fenced_call(one_round, t, state, budget)
        exec_acc += dt
        covered += 1
        tracer.tick()
        if state.wire is not None:
            # hier compressed gather: the measured post-dedup inter volume
            # replaces the hop's analytic bound
            tracer.observe("inter_gather", state.wire)
        budgets = None
        if budget is not None:
            budgets = np.broadcast_to(
                np.asarray(budget.cpu() if torch.is_tensor(budget)
                           else budget), (K,))
        if throughput is not None:
            # bulk-synchronous round: every worker shares the fenced round
            # wall-clock; the steps run are the budgets (or H)
            throughput.observe_round(
                budgets if budgets is not None else float(cfg.H), dt)
        if (t + 1) % gap_every and t != rounds - 1:
            continue
        alpha_eval = state.alpha
        if cfg.average_iterates:
            alpha_eval = state.alpha_bar / max(state.rounds, 1)
        if aspec.enabled and loss.project is not None:
            # extrapolated duals may sit a whisker outside the conjugate's
            # domain: certify a feasible dual point (still a true bound)
            alpha_eval = loss.project(alpha_eval, y)
        with record_function("cocoa/certificate"):
            if drifted:
                # lossy messages and extrapolated exchange points let the
                # carried v drift from v(alpha): certify the point the run
                # holds
                (pval, dval, g), cert_s = fenced_call(
                    duality.gap_at_v, state.w, alpha_eval, X, y, mask, loss,
                    cfg.lam, reg, topo)
            else:
                (pval, dval, g), cert_s = fenced_call(
                    duality.gap_decomposed, alpha_eval, X, y, mask, loss,
                    cfg.lam, reg, topo)
        gap = float(g)
        totals = tracer.totals()
        rec = RoundRecord(
            round=t + 1, round_global=base + t + 1,
            rounds_in_record=covered, gap=gap, primal=float(pval),
            dual=float(dval), compile_s=pending_compile,
            execute_s=exec_acc, certificate_s=cert_s,
            wire_floats=totals["comm_floats"] - prev_floats,
            wire_bytes=4 * (totals["comm_floats"] - prev_floats),
            hops=tuple(tracer.per_hop()), comm=totals,
            budgets=(tuple(int(b) for b in budgets)
                     if budgets is not None else None),
            throughput=(tuple(float(r) for r in throughput.rate)
                        if throughput is not None else None))
        prev_floats = totals["comm_floats"]
        pending_compile, exec_acc, covered = 0.0, 0.0, 0
        agg.emit(rec)
        if obs is not None:
            obs.emit(rec)
        if on_round is not None:
            on_round(t + 1, state, gap)
        if gap <= eps_gap:
            break
    hist = agg.history()
    hist["execute_s"] = [r.execute_s for r in agg.records]
    hist["certificate_s"] = [r.certificate_s for r in agg.records]
    return SolveResult(state, hist, tracer)
