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

    # operations: checkpoint every 2nd round (run twice: the second run
    # prints `resumed from round N`), lose worker 0 at round 20 (the
    # dual-safe drop), re-split onto 16 workers at round 30
    PYTHONPATH=src python -m repro_torch.launch.cocoa_train \
        --dataset rcv1_sparse --solver sdca_kernel --rounds 40 \
        --ckpt /tmp/cocoa_ckpt --ckpt-every 2 --simulate-failure 20 \
        --elastic-to 16@30

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
runs the kernels: on sparse data the 1-D walk at any width (u in shared
memory where it fits, else in device memory) and, under `--mesh KxM`,
the z-exchange schedule at any M, on one card or across processes.
Under `torch.distributed.run` the mesh spans the ranks
and the world size must equal its size; there `--ckpt` gathers the
ranks' blocks to rank 0, which writes the one-process checkpoint, and
every rank restores its own block from it. `--elastic-to` exits on a
process mesh: its world size is fixed for the run (ROADMAP.md Queue 1
item 14).
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
from ..checkpoint import CheckpointManager
from ..core import CoCoAConfig, primal_w, solve
from ..core.accel import parse_accel
from ..core.cocoa import (gather_state, init_state, place_on_mesh,
                          reshard_w_state, resolve_solver, state_block,
                          state_from_tree, state_to_tree)
from ..core.regularizers import get_regularizer
from ..data import DATASETS, FeatureShards, SparseShards, load, partition, \
    partition_sparse
from ..device import resolve_device
from ..obs import (Aggregator, Dashboard, EventBus, JsonlSink, ProfilerSink,
                   RoundProfileSink, cost)
from ..runtime import elastic, failures, straggler
from .mesh import initialize_distributed, make_process_mesh, make_test_mesh

# the leaves a restore reads (the reference's template also asks for
# `rng`, which the port carries no use for)
_CKPT_LEAVES = ("w", "alpha", "rounds", "alpha_bar", "ef")
# the history's cumulative wire totals, carried across the run's solve calls
_TOTALS = ("comm_vectors", "comm_floats", "comm_bytes", "comm_psums")


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
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory: resume from its newest step, "
                         "save every --ckpt-every certified round")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="drop worker 0 at this round (dual-safe recovery)")
    ap.add_argument("--simulate-straggler", type=int, default=-1,
                    help="worker index running at 10%% speed: its measured "
                         "round clock is scaled 10x and the deadline "
                         "budgets follow (sdca_deadline takes them)")
    ap.add_argument("--elastic-to", default="",
                    help="'K@round': re-partition to K workers at round")
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


def _elastic(args) -> tuple:
    """(K', round) of --elastic-to; (0, -1) without it."""
    if not args.elastic_to:
        return 0, -1
    try:
        el_K, el_round = (int(v) for v in args.elastic_to.split("@"))
    except ValueError:
        raise SystemExit(f"--elastic-to wants 'K@round', got "
                         f"{args.elastic_to!r}")
    if el_K < 1:
        raise SystemExit(f"--elastic-to needs K >= 1, got {el_K}")
    return el_K, el_round


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
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
    el_K, _ = _elastic(args)
    try:
        comm.Topology.simulated(args.workers, topology=args.topology)
        if el_K:
            # the re-partition target must fit the topology too, or the
            # crash just moves to the elastic round
            comm.Topology.simulated(el_K, topology=args.topology)
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
        if args.elastic_to:
            raise SystemExit(
                "--elastic-to does not run across processes: the world "
                "size is fixed for a run (restart under "
                "torch.distributed.run at the new size from a --ckpt "
                "checkpoint); ROADMAP.md Queue 1 item 14 (Elastic runs "
                "across processes)")
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

    def make_cfg(K):
        if args.aggregator:
            return CoCoAConfig(aggregator=args.aggregator, **common)
        return (CoCoAConfig.adding(K, **common) if args.gamma == "add"
                else CoCoAConfig.averaging(K, **common))

    def make_mesh(K):
        if args.backend != "shard_map":
            return None
        shape, axes = ((K, M), ("data", "model")) if M > 1 else \
            ((K,), ("data",))
        return (make_process_mesh(shape, axes, device) if world > 1
                else make_test_mesh(shape, axes, device))

    cfg = make_cfg(K)
    mesh = make_mesh(K)
    bus, agg, sinks = _observe(args, cfg, Xp, yp, mk, mesh, device, K,
                               lead=rank == 0)
    wspec = comm.WSpec(d=Xp.d if isinstance(Xp, (SparseShards,
                                                 FeatureShards))
                       else Xp.shape[-1], M=M,
                       model_axis="model" if M > 1 else None)
    # every rank restores; rank 0 alone writes
    mgr = (CheckpointManager(args.ckpt, keep=2, async_write=rank == 0)
           if args.ckpt else None)
    state, start = None, 0
    if mgr and mgr.latest_step():
        state, start = _restore(mgr, cfg, wspec, K, yp.shape[1], device, say)
        state = state_block(cfg, mesh, state)
    tracker = _tracker(args, K)
    budget_fn = _budget_fn(args, tracker, K)
    if budget_fn is not None:
        say(f"straggler budgets: {budget_fn(0).numpy()} (re-derived per "
            f"round from measured throughput)")

    el_K, el_round = _elastic(args)
    reg = cfg.regularizer()
    hist = {}
    r, done = None, start
    try:
        while done < args.rounds:
            stop = min(rd for rd in
                       [args.rounds,
                        args.simulate_failure if args.simulate_failure > done
                        else args.rounds,
                        el_round if el_round > done else args.rounds]
                       if rd > done)
            rounds_before = state.rounds if state is not None else 0

            def on_round(t, st, gap, base=done):
                # every rank gathers (a collective); rank 0 writes
                if mgr and (base + t) % args.ckpt_every == 0:
                    tree = state_to_tree(gather_state(cfg, mesh, st))
                    if rank == 0:
                        mgr.save(base + t, tree, {"gap": gap})

            try:
                r = solve(cfg, Xp, yp, mk, rounds=stop - done,
                          eps_gap=args.eps, gap_every=2, state=state,
                          mesh=mesh, budget_fn=budget_fn, obs=bus,
                          throughput=tracker, on_round=on_round)
            except ValueError as e:   # a configuration the mesh cannot run
                raise SystemExit(str(e))
            state = r.state
            _extend(hist, r.history, done)
            for t, gap, ex in zip(r.history["round"], r.history["gap"],
                                  r.history["execute_s"]):
                say(f"round {done + t}: gap={gap:.3e} execute_s={ex:.4f}")
            # advance by the rounds the solver actually ran (eps may stop
            # it early)
            done += state.rounds - rounds_before
            if agg.final_gap <= args.eps:
                break
            if done == args.simulate_failure and args.simulate_failure:
                say("simulating loss of worker 0 (dual-safe drop + "
                    "recovery)")
                state = _drop_worker0(cfg, mesh, state, Xp, yp, mk, wspec,
                                      args.lam, reg)
                args.simulate_failure = 0
            if done == el_round and el_K:
                say(f"elastic re-partition {K} -> {el_K} workers")
                if args.compress != "none":
                    # every worker is alive here (unlike drop_worker): flush
                    # the outstanding EF debt into w before the per-worker
                    # residuals are rebuilt at the new K, so no update mass
                    # is lost
                    state = state._replace(w=comm.flush_ef(
                        state.w, state.ef, cfg.agg_params(K)))
                Xp, yp, mk, alpha = _resplit(Xp, yp, mk, state.alpha, el_K)
                K = el_K
                cfg = make_cfg(K)
                tracker = _tracker(args, K)    # per-worker EMA is K-shaped
                budget_fn = _budget_fn(args, tracker, K)
                mesh = make_mesh(K)
                state = init_state(wspec.d_padded, K, yp.shape[1],
                                   device=device)._replace(
                    alpha=alpha, w=state.w, rounds=state.rounds)
                el_round = -1
    finally:
        bus.close()               # flush the JSONL files, export the trace
    if mgr:
        mgr.wait()
        if world > 1:
            # rank 0 wrote: no rank leaves before the checkpoint is on disk
            torch.distributed.barrier()
    say(agg.format_summary())
    if r is None:
        return hist
    if args.reg != "l2":
        w_fin = primal_w(state, cfg)
        nz = torch.tensor([int((w_fin.abs() > 0).sum()), w_fin.shape[0]])
        if world > 1:             # a rank holds its model shard's slice
            nz = comm.Topology.from_mesh(mesh, "data",
                                         cfg.model_axis).model_sum(nz)
        say(f"reg[{reg.name}]: tau={reg.tau(args.lam):.3g} "
            f"primal w nonzeros: {int(nz[0])}/{int(nz[1])}")
    say(f"final: rounds={hist['round'][-1]} gap={hist['gap'][-1]:.3e} "
        f"primal={hist['primal'][-1]:.6g} dual={hist['dual'][-1]:.6g} "
        f"comm={hist['comm_floats'][-1] // (done - start)} floats/round "
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


def _extend(hist: dict, seg: dict, done: int) -> None:
    """Append one solve call's history to the run's: its rounds made
    global, its cumulative wire totals carried on from the calls before."""
    for key, vals in seg.items():
        run = hist.setdefault(key, [])
        if key == "round":
            vals = [done + t for t in vals]
        elif key in _TOTALS:
            vals = [(run[-1] if run else 0) + v for v in vals]
        run.extend(vals)


def _restore(mgr, cfg, wspec, K, nk, device, say):
    """The newest checkpoint as the run's global state on `device`, and
    its step. A checkpoint without an `ef` leaf (from before the wire
    stack) starts with zero residuals; a replicated-w (M = 1) one
    restored onto a KxM mesh is resharded; any other width exits."""
    tmpl = dict.fromkeys(_CKPT_LEAVES, 0)
    try:
        loaded, man = mgr.restore(tmpl, device="cpu")
    except KeyError:
        # checkpoint predates the comm subsystem (no 'ef' leaf):
        # restore the old layout, start with zero EF residuals
        tmpl.pop("ef")
        loaded, man = mgr.restore(tmpl, device="cpu")
        loaded["ef"] = comm.init_residual(K, loaded["w"].shape[0],
                                          device="cpu")
    state = state_from_tree(loaded, device)
    if tuple(state.alpha.shape) != (K, nk):
        raise SystemExit(f"checkpoint alpha is {tuple(state.alpha.shape)}; "
                         f"this run places ({K}, {nk}) (--workers / "
                         f"--elastic-to changed the partition)")
    if state.w.shape[0] != wspec.d_padded:
        # legacy replicated-w checkpoint restored onto a 2-D mesh: flush
        # the old EF debt into w (nothing dropped), then re-pad w and lay
        # out fresh residuals for this run's placement
        if state.w.shape[0] != wspec.d:
            raise SystemExit(
                f"checkpoint w has {state.w.shape[0]} floats; this run "
                f"places {wspec.d_padded} (d={wspec.d}, M={wspec.M}) -- "
                f"only replicated (M=1) checkpoints reshard automatically")
        state = reshard_w_state(state, comm.WSpec(d=wspec.d), wspec,
                                cfg.agg_params(K))
        say(f"resharded legacy checkpoint w: 1 -> {wspec.M} feature shards")
    start = man["step"]
    say(f"resumed from round {start}")
    return state, start


def _drop_worker0(cfg, mesh, state, X, y, mask, wspec, lam, reg):
    """Worker 0's dual-safe drop and the rebuild of v from the surviving
    duals. On a process mesh on every rank's block (only worker 0's
    ranks zero their rows; v sums over the data row); on one card on
    the global data, v (d,) then placed for the mesh (the identity when
    already padded: FeatureShards' rmatvec emits the padded width)."""
    topo = None
    if mesh is not None and mesh.is_process:
        topo = comm.Topology.from_mesh(mesh, cfg.data_axis, cfg.model_axis,
                                       topology=cfg.topology)
        X, _, mask = place_on_mesh(cfg, mesh, X, y, mask)
    state = failures.fail_and_recover(state, X, mask, lam, k=0, reg=reg,
                                      topo=topo)
    return state if topo is not None else state._replace(
        w=wspec.pad_w(state.w))


def _resplit(X, y, mask, alpha, K_new):
    """The data and duals re-split onto K_new workers (runtime.elastic),
    in X's own layout."""
    if isinstance(X, FeatureShards):
        # rows re-split across workers with their M feature slices
        # attached; the w placement (M, d_local) is untouched
        X, y, alpha, mask = elastic.repartition_features(X, y, alpha, mask,
                                                         K_new)
        return X, y, mask, alpha
    if isinstance(X, SparseShards):
        # every leaf shares the (K, nk) leading layout, so the ELL shards
        # re-split exactly like dense rows (alpha travels too)
        new, mask = elastic.repartition(
            {"cols": X.cols, "vals": X.vals, "nnz": X.nnz, "y": y,
             "alpha": alpha}, mask, K_new)
        X = SparseShards(new["cols"], new["vals"], new["nnz"], d=X.d)
    else:
        new, mask = elastic.repartition({"X": X, "y": y, "alpha": alpha},
                                        mask, K_new)
        X = new["X"]
    return X, new["y"], mask, new["alpha"]


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


def _budget_fn(args, tracker, K: int):
    """The deadline solver's per-round budgets from the tracker under
    --simulate-straggler (None without it)."""
    if not 0 <= args.simulate_straggler < K:
        return None
    return straggler.budget_fn_from_tracker(
        tracker, deadline_s=args.H / 1e4, H_max=args.H)


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
