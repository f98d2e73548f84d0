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

Same flags as `repro.launch.cocoa_train`, plus `--device` (default cuda;
`--device cpu` runs the plain PyTorch versions). The default `--solver
sdca` runs the eager twin, as the reference's default runs its jnp solver;
`--solver sdca_kernel` (mapped to `sdca_sparse_kernel` on sparse data)
runs the kernels. Flag values this port does not carry yet exit with the
ROADMAP.md item that will bring them.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .. import comm
from ..core import CoCoAConfig, primal_w, solve
from ..core.regularizers import get_regularizer
from ..data import DATASETS, FeatureShards, SparseShards, load, partition, \
    partition_sparse
from ..device import resolve_device
from .mesh import make_test_mesh

# flag -> (value that is ported, ROADMAP.md item that ports the rest)
_UNPORTED = {
    "accel": ("none", "Queue 1 item 9 (core/accel.py)"),
    "ckpt": ("", "Queue 1 item 12 (runtime, checkpoint)"),
    "simulate_failure": (0, "Queue 1 item 12 (runtime, checkpoint)"),
    "simulate_straggler": (-1, "Queue 1 item 12 (runtime, checkpoint)"),
    "elastic_to": ("", "Queue 1 item 12 (runtime, checkpoint)"),
    "metrics_out": ("", "Queue 1 item 11 (obs)"),
    "dashboard": (False, "Queue 1 item 11 (obs)"),
    "profile": ("", "Queue 1 item 11 (obs)"),
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
    ap.add_argument("--accel", default="none")
    ap.add_argument("--backend", default="vmap", choices=["vmap", "shard_map"])
    ap.add_argument("--mesh", default="",
                    help="'KxM' (data x model) mesh on one card: K workers, "
                         "w in M feature shards (sets --workers K and "
                         "--backend shard_map)")
    ap.add_argument("--format", default="auto",
                    choices=["auto", "dense", "sparse"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--simulate-straggler", type=int, default=-1)
    ap.add_argument("--elastic-to", default="")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--dashboard", action="store_true")
    ap.add_argument("--profile", default="")
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
    if M > 1 and fmt != "sparse":
        raise SystemExit(f"--mesh {args.mesh} feature-shards w, which "
                         f"dense data cannot do in repro_torch yet: "
                         f"ROADMAP.md Queue 1 item 10 (dense M > 1)")
    K = args.workers
    if fmt == "sparse":
        if spec.format != "sparse":
            raise SystemExit(f"--format sparse needs a sparse dataset spec; "
                             f"{args.dataset!r} is {spec.format}")
        csr, y = load(args.dataset)
        Xp, yp, mk = partition_sparse(csr, y, K, seed=0, M=M, device=device)
        if isinstance(Xp, FeatureShards):
            print(f"sparse feature shards: M={M} d_local={Xp.d_local} "
                  f"r_loc={Xp.r_loc} density={csr.density:.4g} d={Xp.d}")
        else:
            print(f"sparse shards: nnz/row r_max={Xp.r_max} "
                  f"density={csr.density:.4g} d={Xp.d}")
    else:
        X, y = load(args.dataset)
        if spec.format == "sparse":
            X = X.toarray()     # --format dense on a sparse spec
        Xp, yp, mk = partition(X, y, K, seed=0, device=device)

    common = dict(loss=args.loss, lam=args.lam, H=args.H, solver=args.solver,
                  reg=args.reg, backend=args.backend,
                  model_axis="model" if M > 1 else None,
                  compress=args.compress, compress_k=args.compress_k,
                  topology=args.topology, gather=args.gather)
    if args.aggregator:
        cfg = CoCoAConfig(aggregator=args.aggregator, **common)
    elif args.gamma == "add":
        cfg = CoCoAConfig.adding(K, **common)
    else:
        cfg = CoCoAConfig.averaging(K, **common)

    mesh = None
    if args.backend == "shard_map":
        mesh = (make_test_mesh((K, M), ("data", "model"), device) if M > 1
                else make_test_mesh((K,), ("data",), device))
    r = solve(cfg, Xp, yp, mk, rounds=args.rounds, eps_gap=args.eps,
              gap_every=1, mesh=mesh)
    hist = r.history
    for t, gap, ex in zip(hist["round"], hist["gap"], hist["execute_s"]):
        print(f"round {t}: gap={gap:.3e} execute_s={ex:.4f}")
    reg = cfg.regularizer()
    if args.reg != "l2":
        w_fin = primal_w(r.state, cfg)
        nz = int((w_fin.abs() > 0).sum())
        print(f"reg[{reg.name}]: tau={reg.tau(args.lam):.3g} "
              f"primal w nonzeros: {nz}/{w_fin.shape[0]}")
    print(f"final: rounds={hist['round'][-1]} gap={hist['gap'][-1]:.3e} "
          f"primal={hist['primal'][-1]:.6g} dual={hist['dual'][-1]:.6g} "
          f"comm={hist['comm_floats'][-1] // hist['round'][-1]} floats/round "
          f"device={device}{f' mesh={K}x{M}' if M > 1 else ''}")
    _print_wire(cfg, r.tracer, Xp, K, M)
    return hist


def _print_wire(cfg: CoCoAConfig, tracer, X, K: int, M: int) -> None:
    """The run's per-round wire plan and per-hop table, as the reference's
    trainer prints them."""
    d = X.d if isinstance(X, (SparseShards, FeatureShards)) else X.shape[-1]
    pr = tracer.per_round()
    dense_floats = K * d
    print(f"comm[{cfg.topology}{'+gather' if cfg.gather else ''}"
          f"{f' mesh={K}x{M}' if M > 1 else ''}]: "
          f"{pr['floats']} floats/round "
          f"({pr['bytes']} bytes, {pr['psums']} hop) -- "
          f"{dense_floats / max(pr['floats'], 1):.1f}x cut vs flat "
          f"uncompressed {dense_floats}")
    for h in tracer.per_hop():
        print(f"  hop {h['hop']}[{h['axis']}]: {h['messages']} msgs x "
              f"{h['floats_per_message']} floats = {h['floats']}/round"
              + (f" (measured after dedup, last round: "
                 f"{h['measured_floats_round']})"
                 if "measured_floats_round" in h else ""))
    if M > 1:
        ax = tracer.per_axis()
        print(f"  per-axis floats/round: data={ax.get('data', 0)} "
              f"model={ax.get('model', 0)}; w memory/device: "
              f"{-(-d // M)} floats (replicated would be {d})")


if __name__ == "__main__":
    main()
