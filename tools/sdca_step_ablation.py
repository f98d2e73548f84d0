#!/usr/bin/env python3
"""Where a step of the port's LocalSDCA walks goes, on the card.

    python3 tools/sdca_step_ablation.py [--out build/sdca_step_ablation.json]
                                        [--only sparse,wide,zx,dense]
                                        [--workers 1,2,4]

Needs one NVIDIA card and nvcc; run from the root of a checkout. Builds
variants of the two walk kernels (csrc/sparse_sdca_pipelined.cu and
csrc/local_sdca.cu) and of the zx round's grid form (csrc/
sparse_sdca_zx.cu), each with one part of the step taken out or replaced
by a cheaper one, and times every variant beside the unchanged kernel, in
turns, on round-1 inputs at the shapes `chip_smoke.py` runs: rcv1's
677,399 x 47,236 at density 0.0016 (sparse, K = 8, ring depth 2; the
walk warp's step, the fetch warp off its chain; zx, the same rows as
phase 28's 4 x 32 FeatureShards, B = 16, one cooperative launch a round,
at each of `--workers` workers a block: W = 1 as the card holds it, W > 1
with the grid's residency read as ceil(4 / W) 32 blocks, so the plan
takes the lockstep instance),
phase 28's news20-shaped synthetic (wide: 19,996 x 1,355,191 at density
3.36e-4, K = 4, ring depth 4, u in device memory) and
epsilon's 400,000 x 2,000 (dense, K = 8, windows of 8 rows), hinge. A
variant computes something else than the walk; only its time is read. The
difference to the unchanged kernel is what the part costs on the chain.

Variants (the text each one replaces is named in VARIANTS), by group:
  sparse  plain_add   the scatter's compare-and-swaps as plain stores
          no_scatter  no scatter at all
          seq_rows    rows fetched in storage order, not through perm
                      (their walk still reads each row's id from perm)
          no_reduce   no warp butterfly (each lane's own partials)
          no_gather   no u[c] gather (the value itself stands in)
          no_dalpha   no dalpha store
          relaxed     the walk's arrival on a stage's `empty` relaxed, not
                      a release
          no_update   cd_update replaced by a multiply-add
          fast_div    cd_update's divisions by __fdividef
  wide    same_row    every step fetches row 0 (the fetch off device memory)
          seq_rows    as above
          no_gather   no u[c] gathers (the slot's value stands in)
          no_scatter  no atomicAdd into u
          no_reduce   as above
          no_update   as above
          no_step_sync no barrier of the walk warps between a row's
                      scatter and the next row's gathers (the order they
                      need is then not kept)
          relaxed     as above
  zx      no_poll     the M tagged partials loaded once, their tags unread
                      (no wait for the peers)
          no_exchange no load of the M partial dots at all (z = 0)
          no_update   cd_update replaced by a multiply-add
          no_scatter  no scatter into u
          no_gather   no u[c] gather in the next block's dots (v stands in)
          no_prefetch no copy of block g + 2's rows (stale stages walked)
          no_rows     the prefetch without its cols and vals
          no_scalars  the prefetch without its five scalars a row
          no_wait     no wait for the copies before the prefetch point
                      (copies still in flight are read as they are)
  dense   no_gram     no z0 / Gram tiles (the window's dots)
          no_scalar   no scalar loop (the window's B updates)
          no_fill     no next window's rows fetched (stale stages)
          no_update   no u += X_B^T c
          fast_div    as above
Each variant's replacements must each match the source once (or the
count given as a third element), or the run fails: an edit of a kernel
that moves the text shows here.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 0
DIV = ("return a / (b == 0.0f ? 1.0f : b);",
       "return __fdividef(a, b == 0.0f ? 1.0f : b);")
GROUP_KERNEL = {"sparse": "sparse_sdca_pipelined",
                "wide": "sparse_sdca_pipelined", "zx": "sparse_sdca_zx",
                "dense": "local_sdca"}
SEQ_ROWS = [("const int i = __shfl_sync(FULL, cur, "
             "static_cast<int>(p & 31));",
             "const int i = static_cast<int>(p % nk);")]
RELAXED = [("mbarrier.arrive.shared::cta.b64 %0, [%1];",
            "mbarrier.arrive.relaxed.cta.shared::cta.b64 %0, [%1];")]
NO_REDUCE = [("sdca::warp_sum2(z, sq);", "make_float2(z, sq);")]
NO_UPDATE = [("sdca::cd_update(loss_id, g, sc[1] + dai, tot.x,\n"
              "                                          scale * "
              "tot.y, sc[0]) * sc[2];",
              "(tot.x + tot.y + dai) * 1e-30f;")]
VARIANTS = {
    "wide": {
        "same_row": [("const int i = __shfl_sync(FULL, cur, "
                      "static_cast<int>(p & 31));", "const int i = 0;")],
        "seq_rows": SEQ_ROWS,
        "no_gather": [("us[i] = base + STRIDE * i < r_max ? __ldcg(u + "
                       "cs[i]) : 0.0f;", "us[i] = vs[i];")],
        "no_scatter": [("if (!U_SMEM && pend[i]) atomicAdd(u + cs[i], "
                        "add[i]);", "")],
        "no_reduce": NO_REDUCE,
        "no_update": NO_UPDATE,
        "no_step_sync": [("      if constexpr (NWALK > 1) {\n"
                          "        walk_sync<NWALK>();\n      } else {\n"
                          "        __syncwarp();\n      }\n", "")],
        "relaxed": RELAXED,
    },
    "sparse": {
        "plain_add": [("const unsigned got = atomicCAS(\n"
                       "                  reinterpret_cast<unsigned*>(u + "
                       "cs[i]), seen,\n"
                       "                  __float_as_uint(__fadd_rn(us[i], "
                       "add[i])));",
                       "u[cs[i]] = __fadd_rn(us[i], add[i]);\n"
                       "              const unsigned got = seen;")],
        "no_scatter": [("if (coef != 0.0f) {", "if (coef != coef) {")],
        "seq_rows": SEQ_ROWS,
        "no_reduce": NO_REDUCE,
        "no_gather": [("us[i] = load_u<U_SMEM>(u + cs[i]);",
                       "us[i] = vs[i];")],
        "no_dalpha": [("if (threadIdx.x == 0) dalpha[row0 + row] = dai + "
                       "delta;", "")],
        "relaxed": RELAXED,
        "no_update": NO_UPDATE,
        "fast_div": [DIV],
    },
    "zx": {
        "no_poll": [("if (__all_sync(0xffffffffu, ready)) break;",
                     "break;")],
        "no_exchange": [("exchange_rows<ZR>(words, live, M, step, zr);",
                         "for (int r = 0; r < ZR; ++r) zr[r] = 0.0f;"),
                        ("const float z = exchange_staged<ZR>(\n"
                         "              words, live, M, step,\n"
                         "              smem + W * slab + warp * (ZR * "
                         "XS_STRIDE));", "const float z = 0.0f;")],
        "no_update": [("sdca::cd_update(loss_id, g, sc[B + t] + dai, z,\n"
                       "                                          scale * "
                       "sc[3 * B + t], sc[t]) *\n"
                       "                          sc[2 * B + t];",
                       "(z + dai) * 1e-30f;")],
        "no_scatter": [("if (v != 0.0f) atomicAdd(uu_of(j) + ci[t * r_loc + "
                        "s], c * v);", "if (v != v) atomicAdd(uu_of(j) + "
                        "ci[t * r_loc + s], c * v);"),
                       ("if (v != 0.0f)\n                atomicAdd(uu_of(j) "
                        "+ ci[t * r_loc + s], c[j] * v);", "if (v != v)\n"
                        "                atomicAdd(uu_of(j) + ci[t * r_loc "
                        "+ s], c[j] * v);")],
        "no_gather": [("float uc = load_u<U_SMEM>(uu_of(j) + c2[t * r_loc + "
                       "s]);", "float uc = v2[t * r_loc + s];", 2)],
        "no_prefetch": [("    fetch_rows<W>(walk, nw, step + 2);\n", "")],
        "no_rows": [("            cp_async4(ci + t * r_loc + s, w.cols_km + "
                     "off[j] + s);\n            cp_async4(vi + t * r_loc + s, "
                     "w.vals_km + off[j] + s);\n", ""),
                    ("          cp_async4(reinterpret_cast<int*>(w.stage_of("
                     "seq)) + t * r_loc + s,\n                    w.cols_km "
                     "+ off + s);\n          cp_async4(w.stage_of(seq) + B * "
                     "r_loc + t * r_loc + s,\n                    w.vals_km "
                     "+ off + s);\n", "          (void)off;\n")],
        "no_scalars": [("        cp_async4(sc + t, w.y_k + i);\n"
                        "        cp_async4(sc + B + t, w.alpha_k + i);\n"
                        "        cp_async4(sc + 2 * B + t, w.mask_k + i);\n"
                        "        cp_async4(sc + 3 * B + t, w.sq_k + i);\n"
                        "        cp_async4(sc + 4 * B + t, w.da_km + i);\n",
                        "        (void)sc;\n")],
        "no_wait": [("    cp_async_wait_all();\n    __syncthreads();\n"
                     "    fetch_rows<W>", "    __syncthreads();\n"
                     "    fetch_rows<W>")],
    },
    "dense": {
        "no_gram": [("for (int I = 0; I < NBLK; ++I) {",
                     "for (int I = 0; I < NBLK * (nch < 0); ++I) {")],
        "no_scalar": [("        if (l < nb) {\n          const float dl",
                       "        if (l < 0) {\n          const float dl")],
        "no_fill": [("      fill((s + 1) * nch, 32);\n", "")],
        "no_update": [("          if (j < nb) v = fmaf(cj[j], "
                       "st[j * d_tile + c], v);", "")],
        "fast_div": [DIV],
    },
}


def log(msg):
    print(msg, flush=True)


def variant_dirs(base: pathlib.Path, groups=None):
    """{(group, variant): csrc dir}: a copy of csrc/ per variant of each of
    `groups` (None: all) with its replacements applied ("full":
    unchanged)."""
    from repro_torch.kernels import build
    dirs = {}
    for group, variants in VARIANTS.items():
        if groups is not None and group not in groups:
            continue
        for name, edits in {"full": [], **variants}.items():
            d = base / f"{group}-{name}"
            if d.exists():
                shutil.rmtree(d)
            shutil.copytree(build.CSRC, d)
            for path in d.iterdir():
                text = path.read_text()
                for old, new, *_ in edits:
                    text = text.replace(old, new) if text.count(old) else text
                path.write_text(text)
            for old, _, *count in edits:
                hits = sum(p.read_text().count(old) for p in
                           build.CSRC.iterdir())
                if hits != (count[0] if count else 1):
                    raise SystemExit(f"{group} {name}: {old!r} found "
                                     f"{hits} times in csrc/")
            dirs[(group, name)] = d
    return dirs


def build_variants(dirs):
    """Build every variant in parallel; returns {(group, variant): lib}."""
    import ctypes
    from repro_torch.kernels import build
    procs = {}
    for (group, name), d in dirs.items():
        kernel = GROUP_KERNEL[group]
        out = d / f"{kernel}.so"
        procs[(group, name)] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o",
             str(out), str(d / f"{kernel}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{text}")
        lib = ctypes.CDLL(str(out))
        build._bind(GROUP_KERNEL[key[0]], lib)
        libs[key] = lib
    return libs


def _time(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(group, libs, call, steps, reps=2, name=None):
    """ms a call of every variant of `group`, in turns (forward, then
    backward); returns {variant: ms}."""
    from repro_torch.kernels import build
    kernel = GROUP_KERNEL[group]
    name = name or group
    names = ["full", *VARIANTS[group]]
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        build._LIBS[kernel] = libs[(group, n)]
        ms[n].append(_time(call, reps))
    build._LIBS.pop(kernel, None)
    ms = {n: sum(v) / len(v) for n, v in ms.items()}
    full = ms["full"]
    for n, t in ms.items():
        log(f"  {name} {n:10s} {t:9.3f} ms a call, {1e3 * t / steps:.4f} us "
            f"a step, {t - full:+9.3f} ms against the kernel")
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/sdca_step_ablation.json")
    ap.add_argument("--only", default=None,
                    help="comma-separated groups to time (default: all of "
                         + ", ".join(VARIANTS) + ")")
    ap.add_argument("--workers", default="1",
                    help="comma-separated workers a block of the zx grid "
                         "form to ablate (1, 2, 4 at rcv1's 4 x 32)")
    args = ap.parse_args()
    workers = tuple(int(w) for w in args.workers.split(","))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sdca_step_ablation: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.losses import get_loss
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"[ablation] {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    groups = args.only.split(",") if args.only else list(VARIANTS)
    if set(groups) - set(VARIANTS):
        raise SystemExit(f"unknown groups {set(groups) - set(VARIANTS)}")
    dirs = variant_dirs(ROOT / "build" / "ablation", groups)
    libs = build_variants(dirs)
    log(f"  {len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda:0")
    hinge = get_loss("hinge")
    rng = np.random.default_rng(SEED)
    result = {"device": smi}

    walks = {"sparse": sparse_walk, "wide": wide_walk, "dense": dense_walk,
             "zx": lambda *a: zx_grid(*a, workers=workers)}
    for group in groups:
        result[group] = walks[group](libs, dev, rng, hinge)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    log(json.dumps(result))


def sparse_walk(libs, dev, rng, hinge):
    import numpy as np
    import torch
    from repro_torch.data import make_sparse_classification, partition_sparse
    from repro_torch.kernels import sparse_sdca as sk
    csr, y = make_sparse_classification(677_399, 47_236, density=0.0016,
                                        seed=SEED)
    sh, yp, mk = partition_sparse(csr, y, 8, device=dev)
    del csr
    K, nk, _ = sh.cols.shape
    perm = torch.from_numpy(np.stack([rng.permutation(nk) for _ in range(K)])
                            .astype(np.int32)).to(dev)
    zeros = torch.zeros((K, nk), device=dev)
    scale = 8.0 / (1e-6 * 677_399)
    sargs = (sh.cols, sh.vals, yp, zeros, mk,
             torch.zeros(sh.d, device=dev), scale, perm)
    log(f"[sparse] rcv1 shape K={K} nk={nk} r_max={sh.r_max}, depth 2")
    return in_turns(
        "sparse", libs,
        lambda: sk.sparse_local_sdca(*sargs, loss=hinge, buffer_depth=2), nk)


def wide_walk(libs, dev, rng, hinge):
    """The 1-D walk with u in device memory at phase 28's news20 shape,
    depth 4 (the card's default), the first round's inputs."""
    import numpy as np
    import torch
    from repro_torch.data import make_sparse_classification, partition_sparse
    from repro_torch.kernels import sparse_sdca as sk
    csr, y = make_sparse_classification(19_996, 1_355_191, density=3.36e-4,
                                        seed=SEED)
    sh, yp, mk = partition_sparse(csr, y, 4, device=dev)
    del csr
    K, nk, r_max = sh.cols.shape
    perm = torch.from_numpy(np.stack([rng.permutation(nk) for _ in range(K)])
                            .astype(np.int32)).to(dev)
    wargs = (sh.cols, sh.vals, yp, torch.zeros((K, nk), device=dev), mk,
             torch.zeros(sh.d, device=dev), 4.0 / (1e-4 * 19_996), perm)
    log(f"[wide] news20 shape K={K} nk={nk} r_max={r_max} d={sh.d}, depth "
        f"4, (walk warps, slots a lane) {sk.device_u_walk(r_max)}")
    return in_turns(
        "wide", libs,
        lambda: sk.sparse_local_sdca(*wargs, loss=hinge, buffer_depth=4), nk)


def zx_grid(libs, dev, rng, hinge, workers=(1,)):
    """The grid form at phase 28's 4 x 32 shape: rcv1's rows dealt round
    robin into FeatureShards, the first round's inputs (w = 0, alpha = 0),
    B = 16, one pass, at each W of `workers` (W > 1: the residency read as
    ceil(K / W) M); the time a step is the round's over its steps.
    Returns {W: {variant: ms}}."""
    import numpy as np
    import torch
    from repro_torch.data import make_sparse_classification
    from repro_torch.data.sparse import row_sqnorms, shard_features_streaming
    from repro_torch.kernels import sparse_sdca as sk
    csr, y = make_sparse_classification(677_399, 47_236, density=0.0016,
                                        seed=SEED)
    fs, yp, mk = shard_features_streaming([(csr, y)], 4, 32,
                                          n_features=csr.shape[1],
                                          device=dev)
    del csr
    K, M, nk, r_loc = fs.cols.shape
    perm = torch.from_numpy(np.stack([np.random.default_rng(k).permutation(
        nk) for k in range(K)]).astype(np.int32)).to(dev)
    sq = (row_sqnorms(fs) * mk).contiguous()
    args = (fs.cols, fs.vals, yp, torch.zeros((K, nk), device=dev), mk,
            torch.zeros(M * fs.d_local, device=dev), 4.0 / (1e-6 * 677_399),
            sq, perm)
    steps = -(-nk // 16)
    real = sk._zx_grid_resident
    got = {}
    for W in workers:
        log(f"[zx] rcv1 shape K={K} M={M} nk={nk} r_loc={r_loc} "
            f"d_local={fs.d_local}, B 16, {steps} steps a round, grid form, "
            f"W = {W}")
        held = -(-K // W) * M

        def call():
            out = sk.sparse_local_sdca_zx(*args, loss=hinge, block_rows=16)
            if (sk.LAST_ZX_FORM, sk.LAST_ZX_WORKERS) != ("grid", W):
                raise SystemExit(f"zx ablation ran {sk.LAST_ZX_FORM} at W = "
                                 f"{sk.LAST_ZX_WORKERS}, not the grid at {W}")
            return out

        if W > 1:
            sk._zx_grid_resident = lambda *a: held
        try:
            got[W] = in_turns("zx", libs, call, steps, name=f"zx W={W}")
        finally:
            sk._zx_grid_resident = real
    return got


def dense_walk(libs, dev, rng, hinge):
    import numpy as np
    import torch
    from repro_torch.data import make_classification, partition
    from repro_torch.kernels import local_sdca as dk
    X, y = make_classification(400_000, 2_000, seed=SEED)
    Xp, yp, mk = partition(X, y, 8, device=dev)
    del X, y
    K, nk, d = Xp.shape
    perm = torch.from_numpy(np.stack([rng.permutation(nk) for _ in range(K)])
                            .astype(np.int32)).to(dev)
    dargs = (Xp, yp, torch.zeros((K, nk), device=dev), mk,
             torch.zeros(d, device=dev), 8.0 / (1e-4 * 400_000), perm)
    log(f"[dense] epsilon shape K={K} nk={nk} d={d}, block_rows 8")
    return in_turns(
        "dense", libs,
        lambda: dk.local_sdca(*dargs, loss=hinge, block_rows=8), nk)


if __name__ == "__main__":
    main()
