#!/usr/bin/env python3
"""Where a step of the port's LocalSDCA walks goes, on the card.

    python3 tools/sdca_step_ablation.py [--out build/sdca_step_ablation.json]
                                        [--only sparse|dense]

Needs one NVIDIA card and nvcc; run from the root of a checkout. Builds
variants of the two walk kernels (csrc/sparse_sdca_pipelined.cu and
csrc/local_sdca.cu), each with one part of the step taken out or replaced
by a cheaper one, and times every variant beside the unchanged kernel, in
turns, on round-1 inputs at the shapes `chip_smoke.py` runs: rcv1's
677,399 x 47,236 at density 0.0016 (sparse, K = 8, ring depth 2; the
walk warp's step, the fetch warp off its chain) and
epsilon's 400,000 x 2,000 (dense, K = 8, windows of 8 rows), hinge. A
variant computes something else than the walk; only its time is read. The
difference to the unchanged kernel is what the part costs on the chain.

Variants (the text each one replaces is named in VARIANTS):
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
  dense   no_gram     no z0 / Gram tiles (the window's dots)
          no_scalar   no scalar loop (the window's B updates)
          no_fill     no next window's rows fetched (stale stages)
          no_update   no u += X_B^T c
          fast_div    as above
Each variant's replacements must each match the source once, or the run
fails: an edit of a kernel that moves the text shows here.
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
VARIANTS = {
    "sparse_sdca_pipelined": {
        "plain_add": [("const unsigned got = atomicCAS(\n"
                       "                  reinterpret_cast<unsigned*>(u + "
                       "cs[i]), seen,\n"
                       "                  __float_as_uint(__fadd_rn(us[i], "
                       "add[i])));",
                       "u[cs[i]] = __fadd_rn(us[i], add[i]);\n"
                       "              const unsigned got = seen;")],
        "no_scatter": [("if (coef != 0.0f) {", "if (coef != coef) {")],
        "seq_rows": [("const int i = __shfl_sync(FULL, cur, "
                      "static_cast<int>(p & 31));",
                      "const int i = static_cast<int>(p % nk);")],
        "no_reduce": [("sdca::warp_sum2(z, sq);", "make_float2(z, sq);")],
        "no_gather": [("          us[i] = u[cs[i]];",
                       "          us[i] = vs[i];")],
        "no_dalpha": [("if (lane == 0) dalpha[row0 + row] = dai + delta;",
                       "")],
        "relaxed": [("mbarrier.arrive.shared::cta.b64 %0, [%1];",
                     "mbarrier.arrive.relaxed.cta.shared::cta.b64 %0, [%1];")],
        "no_update": [("sdca::cd_update(loss_id, g, sc[1] + dai, tot.x,\n"
                       "                                          scale * "
                       "tot.y, sc[0]) * sc[2];",
                       "(tot.x + tot.y + dai) * 1e-30f;")],
        "fast_div": [DIV],
    },
    "local_sdca": {
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


def variant_dirs(base: pathlib.Path):
    """{(kernel, variant): csrc dir}: a copy of csrc/ per variant with its
    replacements applied ("full": unchanged)."""
    from repro_torch.kernels import build
    dirs = {}
    for kernel, variants in VARIANTS.items():
        for name, edits in {"full": [], **variants}.items():
            d = base / f"{kernel}-{name}"
            if d.exists():
                shutil.rmtree(d)
            shutil.copytree(build.CSRC, d)
            for path in d.iterdir():
                text = path.read_text()
                for old, new in edits:
                    text = text.replace(old, new) if text.count(old) else text
                path.write_text(text)
            for old, _ in edits:
                hits = sum(p.read_text().count(old) for p in
                           build.CSRC.iterdir())
                if hits != 1:
                    raise SystemExit(f"{kernel} {name}: {old!r} found "
                                     f"{hits} times in csrc/")
            dirs[(kernel, name)] = d
    return dirs


def build_variants(dirs):
    """Build every variant in parallel; returns {(kernel, variant): lib}."""
    import ctypes
    from repro_torch.kernels import build
    procs = {}
    for (kernel, name), d in dirs.items():
        out = d / f"{kernel}.so"
        procs[(kernel, name)] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o",
             str(out), str(d / f"{kernel}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{text}")
        lib = ctypes.CDLL(str(out))
        build._bind(key[0], lib)
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


def in_turns(name, libs, kernel, call, steps, reps=2):
    """ms a call of every variant of `kernel`, in turns (forward, then
    backward); returns {variant: ms}."""
    from repro_torch.kernels import build
    names = ["full", *VARIANTS[kernel]]
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        build._LIBS[kernel] = libs[(kernel, n)]
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
    ap.add_argument("--only", choices=("sparse", "dense"), default=None,
                    help="time one walk's variants only")
    args = ap.parse_args()
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
    dirs = variant_dirs(ROOT / "build" / "ablation")
    libs = build_variants(dirs)
    log(f"  {len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda:0")
    hinge = get_loss("hinge")
    rng = np.random.default_rng(SEED)
    result = {"device": smi}

    if args.only != "dense":
        result["sparse_sdca_pipelined"] = sparse_walk(libs, dev, rng, hinge)
    if args.only != "sparse":
        result["local_sdca"] = dense_walk(libs, dev, rng, hinge)
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
        "sparse", libs, "sparse_sdca_pipelined",
        lambda: sk.sparse_local_sdca(*sargs, loss=hinge, buffer_depth=2), nk)


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
        "dense", libs, "local_sdca",
        lambda: dk.local_sdca(*dargs, loss=hinge, block_rows=8), nk)


if __name__ == "__main__":
    main()
