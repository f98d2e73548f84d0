#!/usr/bin/env python3
"""Both LocalSDCA walks timed for any checkout, on the card.

    python3 tools/walk_times.py [--src PATH] [--label NAME]
                                [--parts sparse,dense,zx,zx32,wide]
                                [--workers 1,2,4] [--digests]

Needs one NVIDIA card and nvcc. Imports `repro_torch` from --src (default
this checkout's src/; another checkout's src/ times that checkout's
kernels, built into that checkout's build/), so a parent and a change run
in turns, one process each, compare in one call. Times with chip_smoke.py's
own loop (`_in_turns`: CUDA events, keys in order then reversed, after a
warm-up), on round-1 inputs (alpha = 0, w = 0, one pass, hinge):

  * the 1-D sparse walk at rcv1's shape (677,399 x 47,236 at density
    0.0016, K = 8, lambda = 1e-6, as chip_smoke.py phase 4) at
    buffer_depth 1, 2, 4 and 8 as asked (where the checkout has
    `ring_plan`, the ring that ran is at least its D_CARD), and, in such a
    checkout, at every ring 1-8 forced ("ring1", ...: D_CARD read as 1). With --digests, also the sha256 of every (dalpha, du) the walk
    gives on those inputs for each loss, prox off and on (kappa 1e-3) and
    1 or 2 passes at asked depths 1 and 4 (rcv1's rows repeat no column
    id, so two checkouts whose digests agree give the same bits);
  * the dense walk at d = 20,000, K = 8, nk = 5,000 (3.2 GB of X, as
    epsilon's), at epsilon's shape (K = 8, nk = 50,000, d = 2,000) and at
    the paper cell's rank block (K = 1, nk = d = 16,384, chip_smoke.py
    phase 25c), on random rows, at the wrapper's default window and launch
    (where the checkout has `LAST_DENSE_CONFIG`, the cluster that ran is
    printed). Held to the plain version on worker 0's first 2,048 rows with
    chip_smoke.py's tolerance, its absolute part scaled by the walk's
    length;
  * with `clusters`, the dense walk at forced clusters in turns (K = 7 at
    d = 2,000, K = 4 at d = 1,000 and 4,000, C = 4, 8, 16; the paper
    block at B = 4, 8, 16, 32 and C = 4, 8, 16): what dense_launch_plan's
    columns-a-block rule and the default window rest on;
  * with `zx`, the z-exchange round at rcv1's shape as FeatureShards of
    4 x 2 and 4 x 32 (chip_smoke.py phases 12 and 28, B = 16) in each form
    the checkout has ("cluster" at M <= 16, "grid" where the checkout
    has it, "block"), forced by reading the card's fits as 0; at 4 x 32
    also the grid form at each W > 1 of `--workers` where the checkout
    has the lockstep instances ("grid@W2", ...: the grid's residency read
    as ceil(4 / W) 32 blocks). With --digests, also the sha256 of the
    cluster form's (dalpha, du) for each loss, prox off and on (kappa
    1e-3), at M = 2 and 4: at B = 1 on rcv1's rows (one pass), and at
    B = 16, two passes, on rows made so that no block of the visit order
    repeats a column id among its rows (chip_smoke.py's
    `_block_distinct_rows`: K = 4, nk = 4,096, rcv1's r_loc 70 and
    d_local 23,618); there no two atomics of a step land on one
    entry of u, so two checkouts whose digests agree give the same bits;
  * with `zx32`, rcv1 as 32 x 32 FeatureShards (1,024 blocks: past what
    the card holds at W = 1) in the grid form the card's own residency
    picks and through the per-block kernel, in turns;
  * with `wide`, the 1-D walk with u in device memory at news_sparse's
    and news20.binary's shapes (phase 28, K = 4, lambda = 1e-4) at depths
    4 and 1;
  * with `slots`, that walk at news20's width and rows (19,996 x
    1,355,191, K = 4) at densities whose r_max is 170, 250, 374, 496 and
    549 (news20's) at seed 0, at depth 4 in each (walk warps, SLOTS)
    instance the checkout builds (`DEVICE_U_WALKS`; one walk warp only up
    to 256 slots), forced in turns; each instance's results against the
    first's, the wrapper's pick;
  * with `gaps12`, chip_smoke.py phase 12's solve (rcv1 as K = 4 x M = 2
    FeatureShards through `solve` on a one-card mesh, sdca_sparse_kernel,
    5 rounds), its certified gaps printed in full, so two checkouts'
    gaps compare past the digits chip_smoke.py prints;
  * with `mesh`, chip_smoke.py phase 28's 2 x 2 process mesh (the
    rcv1_sparse stand-in, 4 gloo ranks, the per-block kernel) against
    its one-process run (the cluster kernel), `--mesh-reps` times: the
    ranks' gaps' max rel diff to the one-process run's, run by run.

Prints ms a call and us a step, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEPTHS = (1, 2, 4, 8)
RINGS = tuple(range(1, 9))     # every ring the 1-D kernel is built for
# the dense walk's shapes (K, nk, d): d = 20,000 (3.2 GB of X, as
# epsilon's), epsilon's own and the paper cell's rank block
DENSE_SHAPES = {"d20000": (8, 5_000, 20_000), "epsilon": (8, 50_000, 2_000),
                "paper": (1, 16_384, 16_384)}
PLAIN_ROWS = 2_048
SEED = 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--parts", default="sparse,dense",
                    help="comma-separated: sparse, dense, clusters, zx, "
                         "zx32, wide, slots, gaps12, mesh")
    ap.add_argument("--mesh-reps", type=int, default=2)
    ap.add_argument("--workers", default="1,2,4",
                    help="workers a block of the zx grid forms at 4 x 32")
    ap.add_argument("--digests", action="store_true",
                    help="with `sparse`: sha256 of the walk's outputs for "
                         "each loss, prox, passes and depth; with `zx`: "
                         "of the cluster form's at B = 1 and on "
                         "block-distinct rows")
    args = ap.parse_args()
    workers = [int(w) for w in args.workers.split(",")]
    parts = args.parts.split(",")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("walk_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core.losses import get_loss
    from repro_torch.data import make_sparse_classification
    from repro_torch.kernels import local_sdca as dk, sparse_sdca as sk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda:0")
    hinge = get_loss("hinge")
    rng = np.random.default_rng(SEED)

    out = {"label": args.label, "device": smi}
    csr = y = None
    if {"zx", "zx32", "sparse", "gaps12"} & set(parts):
        csr, y = make_sparse_classification(677_399, 47_236, density=0.0016,
                                            seed=SEED)
    if "zx" in parts:
        out["zx_ms"] = zx_forms(cs, sk, csr, y, dev, hinge, rng, workers)
        log(f"[walk times] {args.label}: zx ms a round by form "
            f"{out['zx_ms']}")
        if args.digests:
            out["zx_digests"] = zx_digests(cs, sk, csr, y, dev)
            log(f"[walk times] {args.label}: {len(out['zx_digests'])} "
                f"digests of the cluster form's (dalpha, du): "
                f"{json.dumps(out['zx_digests'])}")
    if "zx32" in parts:
        out["zx32_ms"] = zx_forms(cs, sk, csr, y, dev, hinge, rng, (1,),
                                  meshes=((32, 32),))
        log(f"[walk times] {args.label}: zx at 32 x 32, ms a round by form "
            f"{out['zx32_ms']}")
    if "gaps12" in parts:
        out["gaps12"] = mesh2d_gaps(cs, csr, y, dev)
        log(f"[walk times] {args.label}: phase 12's gaps "
            f"{[repr(g) for g in out['gaps12']]}")
    if "wide" in parts:
        out["wide_ms"] = wide_walks(cs, sk, dev, hinge, rng)
        log(f"[walk times] {args.label}: the device-u walk ms a call "
            f"{out['wide_ms']}")
    if "slots" in parts:
        out["slots_ms"] = slot_instances(cs, sk, dev, hinge, rng)
    if "mesh" in parts:
        out["mesh_rel"] = [cs._reach_ranks(dev)["rel"]
                           for _ in range(args.mesh_reps)]
        log(f"[walk times] {args.label}: the 2 x 2 process mesh's gaps, "
            f"max rel diff to one process, run by run {out['mesh_rel']}")
    if "sparse" in parts:
        sparse(args, cs, sk, csr, y, dev, hinge, rng, smi, out)
    del csr, y
    if "dense" in parts:
        dense(args, cs, dk, dev, hinge, rng, smi, out)
    if "clusters" in parts:
        out["clusters_ms"] = clusters(cs, dk, dev, hinge, rng)
    print(json.dumps(out))


def log(msg):
    print(msg, flush=True)


def zx_forms(cs, sk, csr, y, dev, hinge, rng, workers,
             meshes=((4, 2), (4, 32))):
    """ms a round of each zx form at each (K, M) of `meshes`, in turns;
    "grid@W<W>" the grid form with its residency read as ceil(K / W) M
    blocks, for each W > 1 of `workers` that takes fewer blocks than
    W = 1. With the lockstep instances, also each form's workers a block
    and its results' max abs difference to the per-block kernel's."""
    import torch
    from repro_torch.data.sparse import row_sqnorms, shard_features_streaming
    got = {}
    lockstep = hasattr(sk, "ZX_GRID_WORKERS")
    for K, M in meshes:
        fs, yz, mz = shard_features_streaming([(csr, y)], K, M,
                                              n_features=csr.shape[1],
                                              device=dev)
        nk = fs.cols.shape[2]
        args = (fs.cols, fs.vals, yz, torch.zeros((K, nk), device=dev), mz,
                torch.zeros(M * fs.d_local, device=dev),
                K / (1e-6 * 677_399), (row_sqnorms(fs) * mz).contiguous(),
                torch.from_numpy(cs._perm(rng, K, nk)).to(dev))
        forms = (["cluster"] if M <= sk.ZX_MAX_CLUSTER else []) + (
            ["grid"] if hasattr(sk, "_zx_grid_resident") else []) + [
            f"grid@W{w}" for w in workers
            if lockstep and w > 1 and M > sk.ZX_MAX_CLUSTER
            and -(-K // w) < K] + ["block"]
        seen = {}

        def call(form):
            base, _, w = form.partition("@W")
            real = (sk._zx_clusters_fit, getattr(sk, "_zx_grid_resident",
                                                 None))
            if base != "cluster":
                sk._zx_clusters_fit = lambda *a: 0
            if base == "block" and real[1] is not None:
                sk._zx_grid_resident = lambda *a: 0
            if w:
                sk._zx_grid_resident = lambda *a: -(-K // int(w)) * M
            try:
                res = sk.sparse_local_sdca_zx(*args, loss=hinge,
                                              block_rows=16)
            finally:
                sk._zx_clusters_fit = real[0]
                if real[1] is not None:
                    sk._zx_grid_resident = real[1]
            if getattr(sk, "LAST_ZX_FORM", base) != base or (
                    w and sk.LAST_ZX_WORKERS != int(w)):
                raise SystemExit(f"walk_times: asked for the {form} form, "
                                 f"ran {sk.LAST_ZX_FORM}")
            seen[form] = getattr(sk, "LAST_ZX_WORKERS", 1)
            return res

        ms, outs = cs._in_turns(forms, call)
        if lockstep:
            ms = {"ms": ms, "workers_per_block": seen,
                  "max_abs_to_block": {
                      f: max(float((a - b).abs().max())
                             for a, b in zip(outs[f], outs["block"]))
                      for f in forms}}
        got[f"{K}x{M}"] = ms
        del fs, args
    return got


LOSSES = ("hinge", "smooth_hinge", "squared", "absolute")


def mesh2d_gaps(cs, csr, y, dev):
    """chip_smoke.py phase 12's rcv1 solve on a (4, 2) one-card mesh
    through the z-exchange kernel, 5 rounds: its certified gaps."""
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.data import partition_sparse
    from repro_torch.launch.mesh import make_test_mesh
    K, M = 4, 2
    fs, yp, mk = partition_sparse(csr, y, K, M=M, device=dev)
    cfg = CoCoAConfig.adding(K, lam=cs.SPARSE_LAM, H=yp.shape[1],
                             backend="shard_map", model_axis="model",
                             solver="sdca_sparse_kernel", loss="hinge")
    r = solve(cfg, fs, yp, mk, rounds=5, gap_every=1, seed=cs.SEED,
              mesh=make_test_mesh((K, M), device=dev))
    return [float(g) for g in r.history["gap"]]


def _digest(tensors):
    import hashlib
    import torch
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def zx_digests(cs, sk, csr, y, dev):
    """The sha256 (16 hex digits) of the cluster form's (dalpha, du) for
    each loss and prox (off, kappa 1e-3) at M = 2 and 4: B = 1 on rcv1's
    rows as 4 x M FeatureShards (one pass, round-1 inputs), and B = 16 on
    chip_smoke.py's `_block_distinct_rows` (two passes). Each run must be
    the cluster form's."""
    import numpy as np
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.data.sparse import row_sqnorms, shard_features_streaming
    cases = {}
    for M in (2, 4):
        fs, yz, mz = shard_features_streaming([(csr, y)], 4, M,
                                              n_features=csr.shape[1],
                                              device=dev)
        K, _, nk, _ = fs.cols.shape
        perm = np.stack([np.random.default_rng(k).permutation(nk)
                         for k in range(K)]).astype(np.int32)
        cases[f"rcv1_4x{M}/B=1"] = (
            (fs.cols, fs.vals, yz, torch.zeros((K, nk), device=dev), mz,
             torch.zeros(M * fs.d_local, device=dev), K / (1e-6 * 677_399),
             (row_sqnorms(fs) * mz).contiguous(),
             torch.from_numpy(perm).to(dev)), 1, 1)
        cols, vals, yd, sq, perm = cs._block_distinct_rows(
            4, M, 4_096, 23_618, 70, 16)
        t = [torch.from_numpy(a).to(dev) for a in (cols, vals, yd, sq, perm)]
        cases[f"distinct_4x{M}/B=16"] = (
            (t[0], t[1], t[2], torch.zeros((4, 4_096), device=dev),
             torch.ones((4, 4_096), device=dev),
             torch.zeros(M * 23_618, device=dev), 4 / (1e-4 * 16_384), t[3],
             t[4]), 16, 2)
    got = {}
    for case, (zargs, B, n_passes) in cases.items():
        for name in LOSSES:
            for kappa in (None, 1e-3):
                res = sk.sparse_local_sdca_zx(
                    *zargs, loss=get_loss(name), block_rows=B,
                    n_passes=n_passes, prox_kappa=kappa)
                if getattr(sk, "LAST_ZX_FORM", "cluster") != "cluster":
                    raise SystemExit(f"walk_times: the zx digests ran "
                                     f"{sk.LAST_ZX_FORM}, not the cluster "
                                     f"form")
                got[f"{case}/{name}/kappa={kappa}"] = _digest(res)
    return got


def wide_walks(cs, sk, dev, hinge, rng):
    """ms a call of the 1-D walk with u in device memory at news_sparse's
    and news20's shapes, depths 4 and 1 in turns."""
    import torch
    from repro_torch.data import make_sparse_classification, partition_sparse
    got = {}
    for name, (n, d, density) in (("news_sparse", (8_192, 65_536, 5e-4)),
                                  ("news20", cs.NEWS20)):
        csr, y = make_sparse_classification(n, d, density=density, seed=SEED)
        sh, yp, mk = partition_sparse(csr, y, cs.REACH_K, device=dev)
        K, nk, _ = sh.cols.shape
        args = (sh.cols, sh.vals, yp, torch.zeros((K, nk), device=dev), mk,
                torch.zeros(d, device=dev), K / (cs.REACH_LAM * n),
                torch.from_numpy(cs._perm(rng, K, nk)).to(dev))
        ms, _ = cs._in_turns((4, 1), lambda depth: sk.sparse_local_sdca(
            *args, loss=hinge, buffer_depth=depth), reps=2)
        got[name] = ms
    return got


# r_max 170, 250, 374, 496 and news20's 549 at seed 0
SLOT_DENSITIES = (0.9e-4, 1.4e-4, 2.2e-4, 3.0e-4, 3.36e-4)


def slot_instances(cs, sk, dev, hinge, rng):
    """ms a call of the device-u walk at depth 4 in each (walk warps,
    SLOTS) instance at r_max 170 to 549, forced through `device_u_walk`,
    in turns; each instance's (dalpha, du) max abs difference to the
    first's, the wrapper's pick."""
    import torch
    from repro_torch.data import make_sparse_classification, partition_sparse
    n, d, _ = cs.NEWS20
    real = sk.device_u_walk
    got = {}
    for density in SLOT_DENSITIES:
        csr, y = make_sparse_classification(n, d, density=density,
                                            seed=SEED)
        sh, yp, mk = partition_sparse(csr, y, cs.REACH_K, device=dev)
        K, nk, r_max = sh.cols.shape
        args = (sh.cols, sh.vals, yp, torch.zeros((K, nk), device=dev), mk,
                torch.zeros(d, device=dev), K / (cs.REACH_LAM * n),
                torch.from_numpy(cs._perm(rng, K, nk)).to(dev))
        walks = [real(r_max)] + [
            w for w in sk.DEVICE_U_WALKS
            if w != real(r_max) and (w[0] == 2 or r_max <= 256)]

        def call(walk):
            sk.device_u_walk = lambda r: walk
            try:
                return sk.sparse_local_sdca(*args, loss=hinge, buffer_depth=4)
            finally:
                sk.device_u_walk = real

        ms, outs = cs._in_turns(walks, call, reps=2, rounds=3)
        first = outs[walks[0]]
        diff = {str(w): max(float((a - b).abs().max())
                            for a, b in zip(outs[w], first)) for w in walks}
        got[str(r_max)] = {str(w): ms[w] for w in walks}
        log(f"[walk times] device-u walk at r_max {r_max} (K={K} nk={nk} "
            f"d={d}, depth 4), ms a call in turns by (walk warps, SLOTS), "
            f"the wrapper's pick first: " + ", ".join(
                f"{w}: {ms[w]:.3f} ({1e3 * ms[w] / nk:.4f} us a step)"
                for w in walks) + f"; max abs to the first {diff}")
        del sh, args, outs, first
    return got


def sparse(args, cs, sk, csr, y, dev, hinge, rng, smi, out):
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.data import partition_sparse
    sh, yp, mk = partition_sparse(csr, y, 8, device=dev)
    K, nk, r_max = sh.cols.shape
    perm = torch.from_numpy(cs._perm(rng, K, nk)).to(dev)
    sargs = (sh.cols, sh.vals, yp, torch.zeros((K, nk), device=dev), mk,
             torch.zeros(sh.d, device=dev), 8.0 / (1e-6 * 677_399), perm)
    planned = hasattr(sk, "ring_plan")
    keys = list(DEPTHS) + ([f"ring{k}" for k in RINGS] if planned else [])
    rings = {}

    def call(key, **kw):
        depth = int(str(key).replace("ring", ""))
        real = getattr(sk, "D_CARD", None)
        if str(key).startswith("ring"):
            sk.D_CARD = 1
        try:
            res = sk.sparse_local_sdca(*sargs, buffer_depth=depth,
                                       **{"loss": hinge, **kw})
        finally:
            if planned:
                sk.D_CARD = real
        rings[key] = getattr(sk, "LAST_RING_DEPTH", depth)
        return res

    sparse_ms, _ = cs._in_turns(keys, call, reps=2)
    log(f"[walk times] {args.label} ({args.src}); {smi}; round-1 inputs, "
        f"hinge. Sparse, rcv1 shape K={K} nk={nk} r_max={r_max}: " +
        ", ".join(f"{'ring' if str(k).startswith('ring') else 'depth'} "
                  f"{str(k).replace('ring', '')} (ran {rings[k]}): "
                  f"{t:.3f} ms, {1e3 * t / nk:.4f} us a step"
                  for k, t in sparse_ms.items()))
    out["sparse_ms"] = {str(k): t for k, t in sparse_ms.items()}
    out["sparse_rings"] = {str(k): r for k, r in rings.items()}
    if args.digests:
        digests = {}
        for name in LOSSES:
            for kappa in (None, 1e-3):
                for n_passes in (1, 2):
                    for depth in (1, 4):
                        got = call(depth, loss=get_loss(name),
                                   prox_kappa=kappa, n_passes=n_passes)
                        digests[f"{name}/kappa={kappa}/passes={n_passes}/"
                                f"depth={depth}"] = _digest(got)
        out["sparse_digests"] = digests
        log(f"[walk times] {args.label}: {len(digests)} digests of the "
            f"sparse walk's (dalpha, du); {len(set(digests.values()))} "
            f"distinct")


def dense(args, cs, dk, dev, hinge, rng, smi, out):
    """The dense walk at each of DENSE_SHAPES, at the checkout's default
    window and launch; each held to the plain version (on worker 0's
    first PLAIN_ROWS rows where the walk is long), with chip_smoke.py's
    tolerance, its absolute part scaled by the walk's length."""
    import torch

    out["dense_ms"], out["dense_config"] = {}, {}
    for name, (Kd, nkd, d) in DENSE_SHAPES.items():
        dargs = _dense_args(cs, dev, rng, Kd, nkd, d,
                            unit_rows=name != "paper")
        dense_ms, outs = cs._in_turns((name,), lambda _: dk.local_sdca(
            *dargs, loss=hinge), reps=2)
        config = getattr(dk, "LAST_DENSE_CONFIG", None)
        # worker 0's first PLAIN_ROWS rows where the walk is long
        cut = dargs if nkd <= PLAIN_ROWS else cs._prefix(
            [t[:1] if torch.is_tensor(t) and t.dim() > 1 else t
             for t in dargs], PLAIN_ROWS)
        got = dk.local_sdca(*cut, loss=hinge)
        want = dk.local_sdca_plain(*cut, loss=hinge)
        atol = cs.ATOL * max(1.0, min(nkd, PLAIN_ROWS) / cs.CUT_NK)
        errs = [cs._errors(g, p, atol) for g, p in zip(got, want)]
        if not all(ok for *_, ok in errs):
            raise SystemExit(f"walk_times: the dense kernel disagrees with "
                             f"its plain version at {name}: {errs}")
        ms = dense_ms[name]
        log(f"[walk times] {args.label} ({args.src}); {smi}. Dense {name}, "
            f"K={Kd} nk={nkd} d={d} at the default window: {ms:.3f} ms, "
            f"{1e3 * ms / nkd:.4f} us a step (against plain on "
            f"{min(nkd, PLAIN_ROWS)} rows: dalpha {errs[0][0]:.3e}, du "
            f"{errs[1][0]:.3e} max abs); launch {config}")
        out["dense_ms"][name] = ms
        out["dense_config"][name] = config
        del dargs, cut, outs
        torch.cuda.empty_cache()
    out["dense_shapes"] = DENSE_SHAPES


def _dense_args(cs, dev, rng, K, nk, d, unit_rows=True):
    """Random rows (K, nk, d) from SEED, unit length (or scaled by
    1/sqrt(d)), with round-1 inputs and a visit order."""
    import math
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    X = torch.randn((K, nk, d), generator=gen, device=dev)
    X /= torch.linalg.vector_norm(X, dim=-1, keepdim=True) if unit_rows \
        else math.sqrt(d)
    y = torch.where(torch.rand((K, nk), generator=gen, device=dev) < 0.5,
                    -1.0, 1.0)
    return (X, y, torch.zeros((K, nk), device=dev),
            torch.ones((K, nk), device=dev), torch.zeros(d, device=dev),
            8.0 / (1e-4 * K * nk),
            torch.from_numpy(cs._perm(rng, K, nk)).to(dev))


def clusters(cs, dk, dev, hinge, rng):
    """The dense walk at forced clusters, in turns (this checkout's
    `local_sdca(cluster=)`): a block's columns against the cluster's size
    (K = 7 at d = 2,000, where 7 clusters of 16 are resident; K = 4 at
    d = 1,000 and 4,000; nk = 20,000, windows of 8, C = 4, 8, 16), and the
    paper cell's rank block (K = 1, nk = d = 16,384) at every window B of
    4, 8, 16, 32 and C = 4, 8, 16. Returns {shape: {"BxC": ms}}."""
    import torch
    out = {}
    shapes = [("K7 d2000", 7, 20_000, 2_000, (8,)),
              ("K4 d1000", 4, 20_000, 1_000, (8,)),
              ("K4 d4000", 4, 20_000, 4_000, (8,)),
              ("paper", 1, 16_384, 16_384, (4, 8, 16, 32))]
    for name, K, nk, d, windows in shapes:
        args = _dense_args(cs, dev, rng, K, nk, d, unit_rows=name != "paper")
        keys = [(B, C) for B in windows for C in (4, 8, 16)]
        ms, _ = cs._in_turns(keys, lambda key: dk.local_sdca(
            *args, loss=hinge, block_rows=key[0], cluster=key[1]), reps=2)
        out[name] = {f"{B}x{C}": t for (B, C), t in ms.items()}
        log(f"[walk times] clusters, {name} (K={K} nk={nk} d={d}), ms a "
            f"call in turns: " + ", ".join(
                f"B={B} C={C} ({dk.slice_cols(d, C)} columns a block): "
                f"{t:.3f}" for (B, C), t in ms.items()))
        del args
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
