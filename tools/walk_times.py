#!/usr/bin/env python3
"""Both LocalSDCA walks timed for any checkout, on the card.

    python3 tools/walk_times.py [--src PATH] [--label NAME]

Needs one NVIDIA card and nvcc. Imports `repro_torch` from --src (default
this checkout's src/; another checkout's src/ times that checkout's
kernels, built into that checkout's build/), so a parent and a change run
in turns, one process each, compare in one call. Times with chip_smoke.py's
own loop (`_in_turns`: CUDA events, keys in order then reversed, after a
warm-up), on round-1 inputs (alpha = 0, w = 0, one pass, hinge):

  * the 1-D sparse walk at rcv1's shape (677,399 x 47,236 at density
    0.0016, K = 8, lambda = 1e-6, as chip_smoke.py phase 4) at
    buffer_depth 1, 2, 4 and 8;
  * the dense walk at d = 20,000, K = 8, nk = 5,000 (3.2 GB of X, as
    epsilon's), at the wrapper's default: there the windows of 8 rows are
    cut into column tiles. Held to the plain version with chip_smoke.py's
    tolerance, its absolute part scaled by the walk's length.

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
DENSE = dict(K=8, nk=5_000, d=20_000)
SEED = 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("walk_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core.losses import get_loss
    from repro_torch.data import make_sparse_classification, partition_sparse
    from repro_torch.kernels import local_sdca as dk, sparse_sdca as sk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda:0")
    hinge = get_loss("hinge")
    rng = np.random.default_rng(SEED)

    csr, y = make_sparse_classification(677_399, 47_236, density=0.0016,
                                        seed=SEED)
    sh, yp, mk = partition_sparse(csr, y, 8, device=dev)
    del csr
    K, nk, r_max = sh.cols.shape
    perm = torch.from_numpy(cs._perm(rng, K, nk)).to(dev)
    sargs = (sh.cols, sh.vals, yp, torch.zeros((K, nk), device=dev), mk,
             torch.zeros(sh.d, device=dev), 8.0 / (1e-6 * 677_399), perm)
    sparse_ms, _ = cs._in_turns(DEPTHS, lambda depth: sk.sparse_local_sdca(
        *sargs, loss=hinge, buffer_depth=depth), reps=2)
    del sh, sargs

    Kd, nkd, d = DENSE["K"], DENSE["nk"], DENSE["d"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    X = torch.randn((Kd, nkd, d), generator=gen, device=dev)
    X /= torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    yd = torch.where(torch.rand((Kd, nkd), generator=gen, device=dev) < 0.5,
                     -1.0, 1.0)
    dargs = (X, yd, torch.zeros((Kd, nkd), device=dev),
             torch.ones((Kd, nkd), device=dev), torch.zeros(d, device=dev),
             8.0 / (1e-4 * Kd * nkd),
             torch.from_numpy(cs._perm(rng, Kd, nkd)).to(dev))
    dense_ms, outs = cs._in_turns(("dense",), lambda _: dk.local_sdca(
        *dargs, loss=hinge), reps=2)
    want = dk.local_sdca_plain(*dargs, loss=hinge)
    atol = cs.ATOL * max(1.0, nkd / cs.CUT_NK)
    errs = [cs._errors(g, p, atol) for g, p in zip(outs["dense"], want)]
    if not all(ok for *_, ok in errs):
        raise SystemExit(f"walk_times: the dense kernel disagrees with its "
                         f"plain version at d={d}: {errs}")

    print(f"[walk times] {args.label} ({args.src}); {smi}; round-1 inputs, "
          f"hinge. Sparse, rcv1 shape K={K} nk={nk} r_max={r_max}: " +
          ", ".join(f"depth {k}: {t:.3f} ms, {1e3 * t / nk:.4f} us a step"
                    for k, t in sparse_ms.items()) +
          f". Dense, K={Kd} nk={nkd} d={d} at the default window: "
          f"{dense_ms['dense']:.3f} ms, "
          f"{1e3 * dense_ms['dense'] / nkd:.4f} us a step (against plain: "
          f"dalpha {errs[0][0]:.3e}, du {errs[1][0]:.3e} max abs)",
          flush=True)
    print(json.dumps({"label": args.label, "device": smi,
                      "sparse_ms": {str(k): t for k, t in sparse_ms.items()},
                      "dense_ms": dense_ms["dense"],
                      "dense_shape": DENSE}))


if __name__ == "__main__":
    main()
