#!/usr/bin/env python3
"""What gloo takes on the card, and a process mesh's rounds on `cuda:0`.

    python3 tools/dist_probe.py [--ranks 4]

Needs one NVIDIA card and nvcc; run from the root of a checkout. Spawns
`--ranks` ranks on `cuda:0`, joined over gloo, and

  1. hands each collective the port's exchange uses -- all_reduce,
     all_gather_into_tensor, reduce_scatter_tensor -- a CUDA tensor
     directly, as `repro_torch.comm.collectives` does, in each dtype the
     port sends (float32 and float64 sums, int32 and int64 gathers), and
     prints whether gloo took it and gave the right answer;
  2. times one float32 all_reduce of 1 float (the feature-sharded walk's
     per-step sum) and of 47,236 (rcv1's exchange), ms a call over 200
     calls, in turns over 5 runs: handed to gloo on the card as the port
     does, and staged by hand through a pinned host buffer;
  3. solves tiny and tiny_sparse on a (ranks,) mesh with the kernel
     solvers (one launch a round per rank) and tiny on a (2, ranks/2)
     dense mesh with the eager `sdca`, and holds each rank's per-round
     gaps to the one-process run on the card.

Prints one JSON line per rank and `dist_probe: ok` at the end; exits
non-zero when a check fails or a rank fails or overruns.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOBS = (("tiny", "sdca_kernel", 1), ("tiny_sparse", "sdca_kernel", 1),
        ("tiny", "sdca", 2))


def _job(name, solver, M, world):
    K = world // M
    shape, axes = ((K, M), ("data", "model")) if M > 1 else ((K,), ("data",))
    cfg = dict(loss="hinge", lam=1e-3, H=128, solver=solver,
               backend="shard_map", model_axis="model" if M > 1 else None)
    return shape, axes, cfg, K


def _data(name, K, dev):
    from repro_torch.data import DATASETS, load, partition, partition_sparse
    if DATASETS[name].format == "sparse":
        csr, y = load(name)
        return partition_sparse(csr, y, K, seed=0, device=dev)
    X, y = load(name)
    return partition(X, y, K, seed=0, device=dev)


def _probe(dev, world):
    """gloo's answer to each collective on a CUDA tensor of each dtype the
    port sends, and whether the answer is right."""
    import torch
    import torch.distributed as dist
    total = world * (world + 1) / 2

    def all_reduce(dtype):
        y = torch.full((8,), dist.get_rank() + 1, dtype=dtype, device=dev)
        dist.all_reduce(y)
        return bool((y == total).all())

    def all_gather_into_tensor(dtype):
        x = torch.full((8,), dist.get_rank() + 1, dtype=dtype, device=dev)
        y = torch.empty(8 * world, dtype=dtype, device=dev)
        dist.all_gather_into_tensor(y, x)
        return [int(v) for v in y[::8].cpu()] == list(range(1, world + 1))

    def reduce_scatter_tensor(dtype):
        x = torch.full((8,), dist.get_rank() + 1, dtype=dtype, device=dev)
        y = torch.empty(8 // world, dtype=dtype, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return bool((y == total).all())

    out = {}
    for call, dtypes in ((all_reduce, ("float32", "float64")),
                         (all_gather_into_tensor,
                          ("float32", "int32", "int64")),
                         (reduce_scatter_tensor, ("float32",))):
        for dtype in dtypes:
            key = f"{call.__name__}/{dtype}"
            try:
                ok = call(getattr(torch, dtype))
                out[key] = "took it, " + ("right" if ok else "WRONG")
            except (RuntimeError, ValueError) as e:
                out[key] = f"refused: {str(e).splitlines()[0][:120]}"
    return out


def _rank(rank, world):
    import torch
    from repro_torch.comm import collectives
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.launch.mesh import make_process_mesh
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    res = {"rank": rank, "gloo_on_cuda": _probe(dev, world)}
    world_group = torch.distributed.group.WORLD

    def staged(t, group):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        torch.distributed.all_reduce(buf, group=group)
        return buf.to(t.device)

    forms = (("direct", collectives.all_reduce), ("staged", staged))
    for n in (1, 47_236):
        t = torch.ones(n, device=dev)
        for _, call in forms:
            for _ in range(10):
                call(t, world_group)
        for run in range(5):
            for how, call in forms if run % 2 == 0 else forms[::-1]:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(200):
                    out = call(t, world_group)
                torch.cuda.synchronize(dev)
                res.setdefault(f"all_reduce_{n}_{how}_ms", []).append(
                    (time.perf_counter() - t0) / 200 * 1e3)
                assert float(out[0]) == world
    res["gaps"] = {}
    for name, solver, M in JOBS:
        shape, axes, cfg, K = _job(name, solver, M, world)
        mesh = make_process_mesh(shape, axes, device=dev)
        X, y, mask = _data(name, K, "cpu")
        r = solve(CoCoAConfig.adding(K, **cfg), X, y, mask, rounds=3, seed=0,
                  mesh=mesh)
        res["gaps"][f"{name}/{solver}/M{M}"] = r.history["gap"]
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("dist_probe: no card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_test_mesh, spawn_ranks
    t0 = time.perf_counter()
    build.build_all(("local_sdca", "sparse_sdca_pipelined"))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_rank, args.ranks, timeout=300)
    print(f"ranks {time.perf_counter() - t0:.1f} s", flush=True)
    for r in ranks:
        print(json.dumps(r), flush=True)
    dev = torch.device("cuda:0")
    bad = []
    for name, solver, M in JOBS:
        shape, axes, cfg, K = _job(name, solver, M, args.ranks)
        key = f"{name}/{solver}/M{M}"
        mesh = make_test_mesh(shape, axes, device=dev)
        want = solve(CoCoAConfig.adding(K, **cfg), *_data(name, K, dev),
                     rounds=3, seed=0, mesh=mesh).history["gap"]
        for r in ranks:
            rel = max(abs(a / b - 1) for a, b in zip(r["gaps"][key], want))
            print(f"{key} rank {r['rank']}: max rel diff {rel:.3e} "
                  f"against the one-process run", flush=True)
            if rel > 1e-5:
                bad.append((key, r["rank"], rel))
    if bad:
        sys.exit(f"dist_probe: FAIL {bad}")
    print("dist_probe: ok", flush=True)


if __name__ == "__main__":
    main()
