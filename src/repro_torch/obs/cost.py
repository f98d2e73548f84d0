"""Analytic cost of one CoCoA+ round, from its shapes.

The port's stand-in for the reference's `launch.hlo_analysis.
stats_of_compiled` on the lowered round: eager PyTorch has no compiled
module to read, so the cost is counted from the data's shapes, H and the
number of passes. The dicts carry the keys `prof.build_profile` reads:

    flops                  the walk's arithmetic on these inputs
    dot_flops              0: no step is a matrix product on tensor cores
    hbm_bytes              what the round must move through device memory,
                           each input read once and each output written
                           once; the zx round also every step's z vectors
    collective_wire_bytes  4 x the tracer's per-round floats a device

The LM kernels' costs (`flash_attention`, `ssm_scan`) are declared the
same way, and every kernel wrapper declares its cost on "meta" tensors,
where nothing launches (`declare`): the dry run (`launch.dryrun`) counts
that in the kernel's place.

The walks' counts are `chip_smoke.py`'s kernel bounds: at rcv1's shape
(K = 8) the 1-D sparse walk prices 0.1275 ms on `prof.H100_SXM`, the zx
round at rcv1's 4 x 2 0.1321 ms, the dense walk at epsilon's (K = 8)
0.958 ms -- all three memory-bound.
"""
from __future__ import annotations

from typing import Optional

from .. import comm
from ..core import cocoa
from ..data.sparse import FeatureShards, SparseShards
from ..kernels import ops

F32 = 4          # bytes of a float32 value or an int32 index


def _stats(flops: float, hbm_bytes: float, wire_bytes: float) -> dict:
    return {"flops": float(flops), "dot_flops": 0.0,
            "hbm_bytes": float(hbm_bytes),
            "collective_wire_bytes": float(wire_bytes)}


# the step counters running, innermost last (`launch.hlo_analysis.
# StepCounter` enters and leaves it)
COUNTERS: list = []


def declare(stats: dict) -> None:
    """Add a kernel's declared cost (a dict of this module's keys) to the
    innermost running step counter; nothing when none runs."""
    if COUNTERS:
        COUNTERS[-1].add(stats)


def flash_attention(B: int, S: int, H: int, KV: int, hd: int,
                    itemsize: int) -> dict:
    """Causal GQA attention over B x H heads of S positions: q·k and p·v
    over the S (S + 1) / 2 causal pairs a head, 4 hd flops a pair (the
    products, `dot_flops`) and 5 a pair for the online softmax; q and
    the output (B, S, H, hd), k and v (B, S, KV, hd) read or written
    once."""
    pairs = B * H * S * (S + 1) // 2
    dots = 4 * hd * pairs
    return {"flops": float(dots + 5 * pairs), "dot_flops": float(dots),
            "hbm_bytes": float(itemsize * 2 * B * S * hd * (H + KV)),
            "collective_wire_bytes": 0.0}


def ssm_scan(B: int, S: int, di: int, N: int) -> dict:
    """The mamba-1 selective scan, float32: 7 flops a state a step (the
    exp, the decay, the input, the output dot) and 2 a channel a step
    (D x); x, dt and y (B, S, di), B and C (B, S, N), A (di, N) and D
    read or written once."""
    return _stats(B * S * di * (7 * N + 2),
                  F32 * (3 * B * S * di + 2 * B * S * N + di * N + di),
                  0.0)


def _vectors(K: int, nk: int, d: int) -> int:
    """Bytes of a walk's vectors: the rows' y, alpha, mask, dalpha and
    visit order (K, nk), w (d) and du (K, d)."""
    return F32 * (5 * K * nk + d + K * d)


def dense_walk(K: int, nk: int, d: int, *, rows: Optional[int] = None,
               steps: Optional[int] = None, wire_bytes: float = 0.0) -> dict:
    """The dense LocalSDCA walk of K workers over (K, nk, d) rows: every
    live row read once (`rows`, K nk by default) and the vectors; 6 flops
    an element a step (the row's dot and axpy and the window's share),
    `steps` steps a worker (nk: one pass)."""
    rows = K * nk if rows is None else rows
    steps = nk if steps is None else steps
    return _stats(6 * K * steps * d, F32 * rows * d + _vectors(K, nk, d),
                  wire_bytes)


def sparse_walk(nnz: int, K: int, nk: int, d: int, *,
                steps: Optional[int] = None,
                wire_bytes: float = 0.0) -> dict:
    """The 1-D sparse walk over padded-ELL rows with `nnz` nonzeros in
    all: 8 bytes a nonzero (column id and value) and the vectors; 6 flops
    a nonzero a pass (the gather-dot and the scatter-axpy), `steps` steps
    a worker over nk rows (nk: one pass; a drawn walk of H steps visits
    H / nk of an average row's nonzeros)."""
    steps = nk if steps is None else steps
    return _stats(6 * nnz * (steps / nk), 2 * F32 * nnz + _vectors(K, nk, d),
                  wire_bytes)


def zx_round(nnz: int, K: int, M: int, nk: int, d_local: int,
             block_rows: int, passes: int = 1,
             wire_bytes: float = 0.0) -> dict:
    """The z-exchange round of K workers over M feature shards in blocks
    of `block_rows` rows: each pass reads every nonzero once (8 bytes);
    each of the passes x ceil(nk / B) steps exchanges B floats a worker,
    its M partial-dot vectors written once and read once and their sum
    written once, B (2M + 1) floats (counted though the cluster kernel
    keeps them in shared memory, and once though each of the per-block
    kernel's M blocks reads all M: the bound is the work's, not an
    implementation's); once a round the rows' y, alpha, mask, row norms,
    order and dalpha, w (M d_local) and du. Flops: the scatter's and the
    next partial dot's multiply-adds, 4 a nonzero a pass."""
    steps = passes * -(-nk // block_rows)
    nbytes = (passes * 2 * F32 * nnz
              + steps * K * block_rows * (2 * M + 1) * F32
              + F32 * (6 * K * nk + M * d_local + K * M * d_local))
    return _stats(passes * 4 * nnz, nbytes, wire_bytes)


def round_stats(cfg, X, mask, topo: Optional[comm.Topology] = None) -> dict:
    """The analytic cost of one round of `solve(cfg, X, y, mask)` on `X` as
    the rounds take it (`core.cocoa.place_on_mesh`'s output on a mesh),
    under `topo` (the simulated topology of X's K workers when None).

    The kernel solvers walk n_passes = round(H / nk) whole passes; the
    drawn eager walks H steps; `gd` H sweeps over all nk rows. The
    feature-sharded sparse kernel runs the zx round of
    `kernels.ops.sparse_zx_plan`; on a process mesh X is the rank's block
    (one worker, one shard: K = M = 1 of that round, its z vectors the
    exchanged sum in and its partial dots out)."""
    sparse = isinstance(X, (SparseShards, FeatureShards))
    if isinstance(X, FeatureShards):
        K, _, nk = X.cols.shape[:3]
    elif sparse:
        K, nk = X.cols.shape[:2]
    else:
        K, nk, d = X.shape
    if topo is None:
        topo = comm.Topology.simulated(K, cfg.topology)
    solver = cocoa.resolve_solver(cfg.solver, sparse,
                                  feature_sharded=topo.M > 1)
    tracer = cocoa.run_tracer(cfg, X, topo, solver)
    wire = F32 * tracer.floats_per_round / (topo.K * topo.M)
    steps = {"permutation": ops.n_passes_of(cfg.H, nk) * nk,
             "none": cfg.H * nk}.get(solver.visit, cfg.H)
    if isinstance(X, FeatureShards):
        nnz = int(X.nnz.sum())
        if solver.name == "sdca_sparse_kernel":
            plan = ops.sparse_zx_plan(
                nk, X.d_local, cfg.H, r_max=X.r_loc,
                reg_family=cfg.regularizer().family, model_shards=X.M,
                backend=X.device.type)
            return zx_round(nnz, K, X.M, nk, X.d_local, plan["block_rows"],
                            plan["n_passes"], wire)
        return sparse_walk(nnz, K, nk, X.d_padded, steps=steps,
                           wire_bytes=wire)
    if sparse and topo.M > 1 and solver.name == "sdca_sparse_kernel":
        plan = ops.sparse_zx_plan(
            nk, X.d, cfg.H, r_max=X.r_max,
            reg_family=cfg.regularizer().family, model_shards=topo.M,
            backend=X.device.type)
        return zx_round(int(X.nnz.sum()), K, 1, nk, X.d, plan["block_rows"],
                        plan["n_passes"], wire)
    if sparse:
        return sparse_walk(int(X.nnz.sum()), K, nk, X.d, steps=steps,
                           wire_bytes=wire)
    return dense_walk(K, nk, d, rows=int(mask.sum()), steps=steps,
                      wire_bytes=wire)
