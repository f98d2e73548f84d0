"""CoCoA+ trainer CLI of the port -- the paper's workload end to end.

    PYTHONPATH=src python -m repro_torch.launch.cocoa_train \
        --dataset covtype_like --workers 8 --rounds 60 --eps 1e-3

    # the paper's sparse regime through the sparse CUDA kernel
    PYTHONPATH=src python -m repro_torch.launch.cocoa_train \
        --dataset rcv1_sparse --solver sdca_kernel --rounds 40

    # 2-D (data x model) mesh on one card: 4 workers x 2 feature shards of
    # w, the sparse kernel's z-exchange schedule
    PYTHONPATH=src python -m repro_torch.launch.cocoa_train \
        --dataset rcv1_sparse --mesh 4x2 --solver sdca_kernel --rounds 40

    # compressed communication: top-64 with error feedback, a two-level
    # reduce over pods of 4 workers, the sets gathered instead of dense
    # vectors -- the summary prints the tracer's per-hop table
    PYTHONPATH=src python -m repro_torch.launch.cocoa_train \
        --dataset rcv1_sparse --solver sdca_kernel --rounds 40 \
        --compress topk --compress-k 64 --topology hier:4 --gather

    # outer momentum on the ill-conditioned spec
    PYTHONPATH=src python -m repro_torch.launch.cocoa_train \
        --dataset illcond --loss squared --lam 5e-4 --H 128 \
        --accel nesterov:16

    # telemetry: one RoundRecord a certified round (every second round)
    # to a JSONL file, a torch.profiler trace with the rounds' ranges, one
    # KernelProfile a record beside it, and the terminal dashboard
    PYTHONPATH=src python -m repro_torch.launch.cocoa_train \
        --dataset rcv1_sparse --solver sdca_kernel --rounds 6 \
        --metrics-out /tmp/m.jsonl --profile /tmp/prof --dashboard
    PYTHONPATH=src python -m repro_torch.obs.validate /tmp/m.jsonl \
        --prof /tmp/m.prof.jsonl

    # the multi-process backend: one rank per worker (K M ranks for
    # --mesh KxM), gloo between them; every rank on the CPU here, on
    # cuda:0 with --device cuda (the ranks share the card); rank 0 prints
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.cocoa_train --device cpu --dataset tiny \
        --workers 2 --backend shard_map --rounds 10

Same flags as `repro.launch.cocoa_train`, plus `--device` (default cuda;
`--device cpu` runs the plain PyTorch versions). The default `--solver
sdca` runs the eager twin, as the reference's default runs its jnp solver;
`--solver sdca_kernel` (mapped to `sdca_sparse_kernel` on sparse data)
runs the kernels. Under `torch.distributed.run` the mesh spans the ranks
and the world size must equal its size. Flag values this port does not
carry yet exit with the ROADMAP.md item that will bring them.
"""
from __future__ import annotations

import argparse
import pathlib
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed

from .. import comm
from ..core import CoCoAConfig, primal_w, solve
from ..core.accel import parse_accel
from ..core.cocoa import place_on_mesh, resolve_solver
from ..core.regularizers import get_regularizer
from ..data import DATASETS, FeatureShards, SparseShards, load, partition, \
    partition_sparse
from ..device import resolve_device
from ..obs import (Aggregator, Dashboard, EventBus, JsonlSink, ProfilerSink,
                   RoundProfileSink, cost)
from ..runtime import straggler
from .mesh import initialize_distributed, make_process_mesh, make_test_mesh

# flag -> (value that is ported, ROADMAP.md item that ports the rest)
_UNPORTED = {
    "ckpt": ("", "Queue 1 item 12 (runtime, checkpoint)"),
    "simulate_failure": (0, "Queue 1 item 12 (runtime, checkpoint)"),
    "elastic_to": ("", "Queue 1 item 12 (runtime, checkpoint)"),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.cocoa_train")
    ap.add_argument("--dataset", default="covtype_like",
                    choices=sorted(DATASETS))
    ap.add_argument("--loss", default="hinge")
    ap.add_argument("--reg", default="l2",
                    help="regularizer g(w): l2 | elastic:<eta> | l1s:<eps>")
    ap.add_argument("--lam", type=float, default=1e-4)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--H", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--gamma", choices=["add", "avg"], default="add")
    ap.add_argument("--aggregator", default="",
                    help="add | avg | gamma:<g> (overrides --gamma)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "randk", "qsgd", "int8"],
                    help="wire compression for Delta v_k (error feedback)")
    ap.add_argument("--compress-k", type=int, default=64,
                    help="kept coordinates for --compress topk/randk")
    ap.add_argument("--topology", default="flat",
                    help="reduce plan: flat | hier:<g> (two-level, groups "
                         "of g workers) | a2a (reduce-scatter + all-gather)")
    ap.add_argument("--gather", action="store_true",
                    help="compressed sparse gather: the reduce moves each "
                         "worker's (idx, val) set instead of dense vectors; "
                         "needs --compress topk or randk")
    ap.add_argument("--solver", default="sdca",
                    choices=["sdca", "sdca_kernel", "sdca_sparse",
                             "sdca_sparse_kernel", "gd", "sdca_deadline"])
    ap.add_argument("--accel", default="none",
                    help="outer momentum: none | nesterov[:<restart>] | "
                         "catalyst:<kappa>")
    ap.add_argument("--backend", default="vmap", choices=["vmap", "shard_map"])
    ap.add_argument("--mesh", default="",
                    help="'KxM' (data x model) mesh: K workers, w in M "
                         "feature shards (sets --workers K and --backend "
                         "shard_map); on one card, or K M ranks under "
                         "torch.distributed.run")
    ap.add_argument("--format", default="auto",
                    choices=["auto", "dense", "sparse"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--simulate-straggler", type=int, default=-1,
                    help="worker index running at 10%% speed: its measured "
                         "round clock is scaled 10x and the deadline "
                         "budgets follow (sdca_deadline takes them)")
    ap.add_argument("--elastic-to", default="")
    ap.add_argument("--metrics-out", default="",
                    help="write one schema-versioned JSONL RoundRecord per "
                         "certified round (validate with python -m "
                         "repro_torch.obs.validate)")
    ap.add_argument("--dashboard", action="store_true",
                    help="live terminal dashboard: gap trajectory, per-hop "
                         "wire rates, per-worker throughput (plain "
                         "per-round lines when stdout is not a tty)")
    ap.add_argument("--profile", default="",
                    help="torch.profiler trace directory (<dir>/trace.json, "
                         "with cocoa_round, cocoa/local_solve, "
                         "cocoa/exchange and cocoa/certificate ranges). "
                         "With --metrics-out also one KernelProfile per "
                         "certified round (<metrics-out>.prof.jsonl): the "
                         "measured round beside its analytic cost "
                         "(obs.cost) on the device's HardwareSpec")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def _reject_unported(args) -> None:
    for flag, (ported, item) in _UNPORTED.items():
        if getattr(args, flag) != ported:
            raise SystemExit(
                f"--{flag.replace('_', '-')}={getattr(args, flag)!r} is not "
                f"ported to repro_torch yet: ROADMAP.md {item}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    _reject_unported(args)
    try:
        get_regularizer(args.reg)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"--reg: {e}")
    try:
        parse_accel(args.accel)
    except ValueError as e:
        raise SystemExit(f"--accel: {e}")
    M = 1
    if args.mesh:
        try:
            K_mesh, M = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh wants 'KxM', got {args.mesh!r}")
        if K_mesh < 1 or M < 1:
            raise SystemExit(f"--mesh axes must be >= 1, got {args.mesh}")
        args.workers = K_mesh
        args.backend = "shard_map"
    # the comm flags fail here, in milliseconds, before the data is made
    if args.gather and args.compress not in ("topk", "randk"):
        raise SystemExit("--gather needs --compress topk or randk "
                         "(the sparse (idx, val) wire form)")
    try:
        comm.Topology.simulated(args.workers, topology=args.topology)
    except ValueError as e:
        raise SystemExit(f"--topology: {e}")
    device = resolve_device(args.device)
    spec = DATASETS[args.dataset]
    fmt = spec.format if args.format == "auto" else args.format
    try:
        resolve_solver(args.solver, fmt == "sparse", feature_sharded=M > 1)
    except ValueError as e:
        raise SystemExit(f"--solver: {e}")
    K = args.workers
    joined = torch.distributed.is_initialized()
    rank, world = initialize_distributed(device=device)
    try:
        return _run(args, device, fmt, spec, K, M, rank, world)
    finally:
        if world > 1 and not joined:
            torch.distributed.destroy_process_group()


def _run(args, device, fmt, spec, K, M, rank, world) -> dict:
    if world > 1:
        if args.backend != "shard_map":
            raise SystemExit(f"{world} ranks need --backend shard_map or "
                             f"--mesh KxM: the vmap backend runs in one "
                             f"process")
        if K * M != world:
            raise SystemExit(f"the mesh {K}x{M} has {K * M} positions but "
                             f"{world} ranks were started: start K*M ranks "
                             f"(--nproc-per-node) or change --workers / "
                             f"--mesh")
    say = print if rank == 0 else _quiet
    # a rank keeps only its block on the card: make the data on the host
    data_dev = "cpu" if world > 1 else device
    if fmt == "sparse":
        if spec.format != "sparse":
            raise SystemExit(f"--format sparse needs a sparse dataset spec; "
                             f"{args.dataset!r} is {spec.format}")
        csr, y = load(args.dataset)
        Xp, yp, mk = partition_sparse(csr, y, K, seed=0, M=M,
                                      device=data_dev)
        if isinstance(Xp, FeatureShards):
            say(f"sparse feature shards: M={M} d_local={Xp.d_local} "
                f"r_loc={Xp.r_loc} density={csr.density:.4g} d={Xp.d}")
        else:
            say(f"sparse shards: nnz/row r_max={Xp.r_max} "
                f"density={csr.density:.4g} d={Xp.d}")
    else:
        X, y = load(args.dataset)
        if spec.format == "sparse":
            X = X.toarray()     # --format dense on a sparse spec
        Xp, yp, mk = partition(X, y, K, seed=0, device=data_dev)
        if M > 1:
            say(f"dense feature shards: M={M} d_local={-(-X.shape[1] // M)} "
                f"d={X.shape[1]}")

    common = dict(loss=args.loss, lam=args.lam, H=args.H, solver=args.solver,
                  reg=args.reg, backend=args.backend,
                  model_axis="model" if M > 1 else None,
                  compress=args.compress, compress_k=args.compress_k,
                  topology=args.topology, gather=args.gather,
                  accel=args.accel)
    if args.aggregator:
        cfg = CoCoAConfig(aggregator=args.aggregator, **common)
    elif args.gamma == "add":
        cfg = CoCoAConfig.adding(K, **common)
    else:
        cfg = CoCoAConfig.averaging(K, **common)

    mesh = None
    if args.backend == "shard_map":
        shape, axes = ((K, M), ("data", "model")) if M > 1 else \
            ((K,), ("data",))
        mesh = (make_process_mesh(shape, axes, device) if world > 1
                else make_test_mesh(shape, axes, device))
    bus, agg, sinks = _observe(args, cfg, Xp, yp, mk, mesh, device, K,
                               lead=rank == 0)
    tracker = _tracker(args, K)
    budget_fn = None
    if 0 <= args.simulate_straggler < K:
        budget_fn = straggler.budget_fn_from_tracker(
            tracker, deadline_s=args.H / 1e4, H_max=args.H)
        say(f"straggler budgets: {budget_fn(0).numpy()} (re-derived per "
            f"round from measured throughput)")
    try:
        r = solve(cfg, Xp, yp, mk, rounds=args.rounds, eps_gap=args.eps,
                  gap_every=2, mesh=mesh, budget_fn=budget_fn, obs=bus,
                  throughput=tracker)
    except ValueError as e:       # a configuration the mesh cannot run
        raise SystemExit(str(e))
    finally:
        bus.close()               # flush the JSONL files, export the trace
    hist = r.history
    for t, gap, ex in zip(hist["round"], hist["gap"], hist["execute_s"]):
        say(f"round {t}: gap={gap:.3e} execute_s={ex:.4f}")
    say(agg.format_summary())
    reg = cfg.regularizer()
    if args.reg != "l2":
        w_fin = primal_w(r.state, cfg)
        nz = torch.tensor([int((w_fin.abs() > 0).sum()), w_fin.shape[0]])
        if world > 1:             # a rank holds its model shard's slice
            nz = comm.Topology.from_mesh(mesh, "data",
                                         cfg.model_axis).model_sum(nz)
        say(f"reg[{reg.name}]: tau={reg.tau(args.lam):.3g} "
            f"primal w nonzeros: {int(nz[0])}/{int(nz[1])}")
    say(f"final: rounds={hist['round'][-1]} gap={hist['gap'][-1]:.3e} "
        f"primal={hist['primal'][-1]:.6g} dual={hist['dual'][-1]:.6g} "
        f"comm={hist['comm_floats'][-1] // hist['round'][-1]} floats/round "
        f"device={device}{f' mesh={K}x{M}' if M > 1 else ''}"
        f"{f' ranks={world}' if world > 1 else ''}")
    _print_wire(cfg, r.tracer, Xp, K, M, say)
    if "metrics" in sinks:
        say(f"metrics: {agg.rounds} rounds -> {args.metrics_out} "
            f"(validate: python -m repro_torch.obs.validate "
            f"{args.metrics_out})")
    if "trace" in sinks:
        say(f"profile: trace written to {sinks['trace'].trace_path}")
    if "prof" in sinks:
        prof_path = sinks["prof"].path
        say(f"profile: per-round KernelProfiles -> {prof_path} (validate "
            f"both streams: python -m repro_torch.obs.validate "
            f"{args.metrics_out} --prof {prof_path})")
    return hist


def _observe(args, cfg, X, y, mask, mesh, device, K, lead):
    """One bus for the run: `solve` emits a RoundRecord per certified
    round and every sink sees the same frozen record. The profiler sink
    comes first, so its trace brackets the first round's build, then the
    aggregator, the JSONL file, the per-round profiles and the dashboard
    last (it reads the profile of the record it draws). On a process
    mesh only rank 0 (`lead`) subscribes the file and terminal sinks.
    Returns (bus, aggregator, {kind: sink})."""
    bus, sinks = EventBus(), {}
    if args.profile and lead:
        sinks["trace"] = bus.subscribe(ProfilerSink(args.profile))
    agg = bus.subscribe(Aggregator())
    if args.metrics_out and lead:
        sinks["metrics"] = bus.subscribe(JsonlSink(args.metrics_out))
    if args.profile and args.metrics_out and lead:
        # the compute-side twin of the record stream: the round's analytic
        # cost from its shapes, priced on the device's HardwareSpec
        t0 = time.perf_counter()
        topo = None
        if mesh is not None:
            X, y, mask = place_on_mesh(cfg, mesh, X, y, mask)
            topo = comm.Topology.from_mesh(mesh, cfg.data_axis,
                                           cfg.model_axis,
                                           topology=cfg.topology)
        stats = cost.round_stats(cfg, X, mask, topo)
        d = X.d if isinstance(X, (SparseShards, FeatureShards)) else \
            X.shape[-1]
        sinks["prof"] = bus.subscribe(RoundProfileSink(
            pathlib.Path(args.metrics_out).with_suffix(".prof.jsonl"),
            stats, name="cocoa_round",
            shape=dict(K=K, d=int(d), nk=int(y.shape[1]), H=args.H,
                       solver=args.solver),
            compile_s=time.perf_counter() - t0, device=device))
    if args.dashboard and lead:
        bus.subscribe(Dashboard(total_rounds=args.rounds,
                                prof_source=sinks.get("prof")))
    return bus, agg, sinks


def _tracker(args, K: int) -> straggler.ThroughputTracker:
    """The run's throughput tracker, fed each round's measured seconds; a
    simulated straggler scales one worker's clock instead of inventing
    rates."""
    slow = np.ones(K)
    if 0 <= args.simulate_straggler < K:
        slow[args.simulate_straggler] = 10.0
    tr = straggler.ThroughputTracker(K, slowdown=slow)
    if 0 <= args.simulate_straggler < K:
        tr.rate[args.simulate_straggler] = 1e3   # pre-measurement seed
    return tr


def _quiet(*args, **kwargs) -> None:
    """`print` on every rank but 0."""


def _print_wire(cfg: CoCoAConfig, tracer, X, K: int, M: int,
                say=print) -> None:
    """The run's per-round wire plan and per-hop table, as the reference's
    trainer prints them."""
    d = X.d if isinstance(X, (SparseShards, FeatureShards)) else X.shape[-1]
    pr = tracer.per_round()
    dense_floats = K * d
    say(f"comm[{cfg.topology}{'+gather' if cfg.gather else ''}"
        f"{f' mesh={K}x{M}' if M > 1 else ''}]: "
        f"{pr['floats']} floats/round "
        f"({pr['bytes']} bytes, {pr['psums']} hop) -- "
        f"{dense_floats / max(pr['floats'], 1):.1f}x cut vs flat "
        f"uncompressed {dense_floats}")
    for h in tracer.per_hop():
        say(f"  hop {h['hop']}[{h['axis']}]: {h['messages']} msgs x "
            f"{h['floats_per_message']} floats = {h['floats']}/round"
            + (f" (measured after dedup, last round: "
               f"{h['measured_floats_round']})"
               if "measured_floats_round" in h else ""))
    if M > 1:
        ax = tracer.per_axis()
        say(f"  per-axis floats/round: data={ax.get('data', 0)} "
            f"model={ax.get('model', 0)}; w memory/device: "
            f"{-(-d // M)} floats (replicated would be {d})")


if __name__ == "__main__":
    main()
