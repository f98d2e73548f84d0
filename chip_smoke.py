#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Needs one NVIDIA card and nvcc; run from the root of a checkout. Phases, in
order, each failing the run with a non-zero exit:

  1. device    name, count, power limit, torch and CUDA versions
  2. build     both kernels from csrc/, one nvcc each, in parallel, with
               -Xptxas -v's registers and shared memory
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the real widths (d = 2,000 dense, d = 47,236 sparse) and a cut
               row count, every closed-form loss, prox on and off, rows with
               duplicate column ids and column-0 entries next to padding
  4. sparse    the main path (`solve`, sdca_sparse_kernel) at rcv1's
               published shape, 677,399 x 47,236 at density 0.0016, K = 8,
               hinge, lambda = 1e-6, after a small-input cross-check of the
               card against the CPU
  5. dense     the main path (`solve`, sdca_kernel) at epsilon's published
               shape, 400,000 x 2,000, K = 8 (3.2 GB of X on the card),
               hinge, lambda = 1e-4
  6. times     each kernel held against its plain version once more, on the
               main path's own next-round inputs at the main path's shapes
               (those are the errors and the plain time the summary
               reports), within phase 3's tolerance with its absolute part
               scaled by the walk's length (`_against_plain`); the kernel's
               time with CUDA events beside its bound; one more round split
               on the host clock

The sparse path runs at lambda = 1e-6, not 1e-4: the synthetic rcv1-shaped
rows are nearly orthogonal, and at lambda = 1e-4 (lambda n = 68) one pass
already reaches float32's noise floor. The gap then came out 0.0 after the
first round, `solve`'s eps_gap = 0 exit (gap <= eps_gap) stopped the run
after one certified round, and there was no falling gap to check.

The line before the last is the card's name and power limit, the one
before that the kernels' JSON summary, the last line the run's JSON result.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 peak outside tensor cores
RTOL, ATOL = 1e-4, 1e-5        # kernel vs plain (reduction order differs)
CUT_NK = 1024                  # phase 3's rows per worker
SEED = 0
DENSE_LAM, SPARSE_LAM = 1e-4, 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card to run on")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1 device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    smi_line = smi.stdout.strip().splitlines()[0]
    return name, count, smi_line


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    infos = build.build_all()
    log(f"[2 build] {len(infos)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc, sm_90a)")
    from repro_torch.kernels.local_sdca import SCRATCH_BYTES
    for info in infos.values():
        log(f"  {info.name}: nvcc {info.seconds:.2f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if any(k in line for k in ("registers", "smem", "Compiling")):
                log(f"    {line.strip()}")
    log(f"  dynamic shared memory per block: {SCRATCH_BYTES} + 4 d bytes "
        f"(d=2000: {SCRATCH_BYTES + 8000} B; d=47236: "
        f"{SCRATCH_BYTES + 4 * 47236} B; limit 232448 B)")


def _errors(got, want, atol=ATOL):
    import torch
    diff = (got - want).abs()
    abs_err = float(diff.max())
    rel_err = float((diff / want.abs().clamp_min(1e-6)).max())
    ok = bool(torch.allclose(got, want, rtol=RTOL, atol=atol))
    return abs_err, rel_err, ok


def _perm(rng, K, nk):
    import numpy as np
    return np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)


def dense_case(rng, K, nk, d, dev):
    import numpy as np
    import torch
    X = rng.standard_normal((K, nk, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    X[:, -8:] = 0.0                                   # padding rows
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    mask[:, -8:] = 0.0
    alpha[:, -8:] = 0.0
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(X), t(y), t(alpha), t(mask), t(w), t(_perm(rng, K, nk)))


def sparse_case(rng, K, nk, d, r_max, dev):
    import numpy as np
    import torch
    nnz = rng.integers(1, r_max + 1, size=(K, nk))
    cols = rng.integers(0, d, size=(K, nk, r_max))
    vals = rng.standard_normal((K, nk, r_max)).astype(np.float32)
    cols[:, 0::3, 1] = cols[:, 0::3, 0]               # duplicate column ids
    cols[:, 0::3, 2] = cols[:, 0::3, 0]
    nnz[:, 0::3] = np.maximum(nnz[:, 0::3], 3)
    cols[:, 1::3, 0] = 0                              # real column 0 ...
    nnz[:, 1::3] = np.minimum(nnz[:, 1::3], r_max - 1)  # ... next to padding
    live = np.arange(r_max)[None, None, :] < nnz[..., None]
    cols = np.where(live, cols, 0).astype(np.int32)
    vals = np.where(live, vals, 0.0).astype(np.float32)
    vals /= np.maximum(np.linalg.norm(vals, axis=-1, keepdims=True), 1e-12)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(cols), t(vals), t(y), t(alpha), t(mask), t(w),
            t(_perm(rng, K, nk)))


def phase_kernels(dev):
    """Kernel against plain on the card at a cut row count. Returns the
    per-kernel max errors."""
    import numpy as np
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import local_sdca as dk, sparse_sdca as sk

    rng = np.random.default_rng(SEED)
    K, nk = 8, CUT_NK
    errs = {"local_sdca": [0.0, 0.0], "sparse_sdca": [0.0, 0.0]}
    bad = []
    log(f"[3 kernels] kernel vs plain on the card, K={K} nk={nk}; "
        f"tolerance |k - p| <= {ATOL} + {RTOL} |p| elementwise")
    dense_in = dense_case(rng, K, nk, 2000, dev)
    scale = 8.0 / (1e-4 * 400_000)
    for loss_name in ("hinge", "smooth_hinge", "squared", "absolute"):
        for n_passes in (1, 2):
            loss = get_loss(loss_name)
            got = dk.local_sdca(*dense_in[:5], scale, dense_in[5], loss=loss,
                                n_passes=n_passes)
            want = dk.local_sdca_plain(*dense_in[:5], scale, dense_in[5],
                                       loss=loss, n_passes=n_passes)
            torch.cuda.synchronize()
            for part, g, p in zip(("dalpha", "du"), got, want):
                a, r, ok = _errors(g, p)
                errs["local_sdca"][0] = max(errs["local_sdca"][0], a)
                errs["local_sdca"][1] = max(errs["local_sdca"][1], r)
                log(f"  dense  d=2000 {loss_name:12s} passes={n_passes} "
                    f"{part:6s} max_abs={a:.3e} max_rel={r:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(f"dense {loss_name} passes={n_passes} {part}")
    sparse_in = sparse_case(rng, K, nk, 47_236, 128, dev)
    for loss_name, kappa, n_passes in (
            ("hinge", None, 1), ("smooth_hinge", None, 1),
            ("squared", None, 1), ("absolute", None, 1),
            ("hinge", None, 2), ("hinge", 0.5, 1), ("smooth_hinge", 0.5, 2)):
        loss = get_loss(loss_name)
        got = sk.sparse_local_sdca(*sparse_in[:6], scale, sparse_in[6],
                                   loss=loss, n_passes=n_passes,
                                   prox_kappa=kappa)
        want = sk.sparse_local_sdca_plain(*sparse_in[:6], scale,
                                          sparse_in[6], loss=loss,
                                          n_passes=n_passes,
                                          prox_kappa=kappa)
        torch.cuda.synchronize()
        for part, g, p in zip(("dalpha", "du"), got, want):
            a, r, ok = _errors(g, p)
            errs["sparse_sdca"][0] = max(errs["sparse_sdca"][0], a)
            errs["sparse_sdca"][1] = max(errs["sparse_sdca"][1], r)
            log(f"  sparse d=47236 {loss_name:12s} kappa={kappa} "
                f"passes={n_passes} {part:6s} max_abs={a:.3e} "
                f"max_rel={r:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"sparse {loss_name} kappa={kappa} {part}")
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return errs


def _check_gaps(name, hist, rounds):
    gaps = hist["gap"]
    log(f"  {name}: " + " ".join(
        f"r{t}:gap={g:.4e},execute_s={e:.4f},certificate_s={c:.4f}"
        for t, g, e, c in zip(hist["round"], gaps, hist["execute_s"],
                              hist["certificate_s"])))
    if len(gaps) != rounds:
        fail(f"{name}: {len(gaps)} certified rounds, expected {rounds}")
    if not all(math.isfinite(g) and g >= -1e-6 for g in gaps):
        fail(f"{name}: gap not finite and >= -1e-6: {gaps}")
    if not gaps[-1] < gaps[0]:
        fail(f"{name}: gap did not fall from round 1 to {rounds}: {gaps}")


def _main_path(name, X, y, mask, solver, rounds, lam, expect):
    """Drive `solve` with the launch counters at 0 just before and read
    just after; `expect` names the kernel module that must have run."""
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.kernels import local_sdca as dk, sparse_sdca as sk
    K, nk = y.shape
    cfg = CoCoAConfig.adding(K, loss="hinge", lam=lam, H=nk, solver=solver)
    dk.LAUNCHES = 0
    sk.LAUNCHES = 0
    r = solve(cfg, X, y, mask, rounds=rounds, gap_every=1, seed=SEED)
    launches = {"local_sdca": dk.LAUNCHES, "sparse_sdca": sk.LAUNCHES}
    log(f"  launches on the main path: {launches}")
    _check_gaps(name, r.history, rounds)
    if launches[expect] != rounds:
        fail(f"{name}: {expect} launched {launches[expect]} times in "
             f"{rounds} rounds")
    return r, launches[expect], cfg


def phase_sparse(dev):
    import torch
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.data import load, make_sparse_classification
    from repro_torch.data import partition_sparse
    # small input: the card's main path against the CPU's plain versions
    csr, y = load("tiny_sparse")
    gaps = {}
    for where in ("cpu", dev):
        sh, yp, mk = partition_sparse(csr, y, 8, device=where)
        cfg = CoCoAConfig.adding(8, loss="hinge", lam=1e-3, H=128,
                                 solver="sdca_sparse_kernel",
                                 reg="elastic:0.5")
        gaps[str(where)] = solve(cfg, sh, yp, mk, rounds=5,
                                 seed=SEED).history["gap"]
    worst = max(abs(a / b - 1) for a, b in zip(gaps["cpu"], gaps[str(dev)]))
    log(f"[4 sparse] tiny_sparse elastic:0.5 gaps, card vs cpu plain: "
        f"max rel diff {worst:.3e} (limit 1e-4)")
    if worst > 1e-4:
        fail(f"tiny_sparse gaps differ between card and cpu: {gaps}")
    t0 = time.perf_counter()
    csr, y = make_sparse_classification(677_399, 47_236, density=0.0016,
                                        seed=SEED)
    sh, yp, mk = partition_sparse(csr, y, 8, device=dev)
    nnz = int(sh.nnz.sum())
    log(f"  rcv1 shape: n=677399 d=47236 nnz={nnz} r_max={sh.r_max} "
        f"nk={yp.shape[1]} (data made in {time.perf_counter() - t0:.1f} s)")
    del csr
    r, launches, cfg = _main_path("rcv1 sdca_sparse_kernel", sh, yp, mk,
                                  "sdca_sparse_kernel", 5, SPARSE_LAM,
                                  "sparse_sdca")
    return sh, yp, mk, r, cfg, launches, nnz


def phase_dense(dev):
    from repro_torch.data import make_classification, partition
    t0 = time.perf_counter()
    X, y = make_classification(400_000, 2_000, seed=SEED)
    Xp, yp, mk = partition(X, y, 8, device=dev)
    del X, y
    gc.collect()
    log(f"[5 dense] epsilon shape: n=400000 d=2000 nk={yp.shape[1]} "
        f"X on card {Xp.numel() * 4 / 1e9:.2f} GB (data made in "
        f"{time.perf_counter() - t0:.1f} s)")
    r, launches, cfg = _main_path("epsilon sdca_kernel", Xp, yp, mk,
                                  "sdca_kernel", 3, DENSE_LAM, "local_sdca")
    return Xp, yp, mk, r, cfg, launches


def _time_ms(fn, reps):
    import torch
    fn()                                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _round_inputs(cfg, X, y, mask, state):
    """The wrapper's inputs for the main path's next round, as kernels.ops
    builds them: w = conj_grad(v), scale = sigma'/(tau n), the visit perm."""
    import torch
    from repro_torch.core import cocoa, duality
    from repro_torch.kernels import ops
    K, nk = y.shape
    reg = cfg.regularizer()
    solver = cocoa.resolve_solver(cfg.solver, not torch.is_tensor(X))
    order = cocoa.draw_visit_orders(solver, K, nk, cfg.H, SEED, state.rounds)
    n = float(duality.effective_n(mask))
    scale = cfg.agg_params(K).sigma_prime / (reg.tau(cfg.lam) * n)
    w = reg.conj_grad(state.w, cfg.lam).float().contiguous()
    return w, scale, ops.perm_i32(order, nk, y.device)


def _against_plain(name, kernel, plain, args, kw):
    """One wrapper call and one plain call on the same inputs: the max
    errors over (dalpha, du), and the plain call's time in ms.

    Tolerance |k - p| <= ATOL * nk / CUT_NK + RTOL |p|: phase 3's, with its
    absolute part scaled by the walk's length. The kernel's block reduction
    and torch.sum round the row dot differently; each step's delta feeds
    the next, so the difference compounds over the nk dependent steps (the
    first run at epsilon's shape measured 1.55e-5 in dalpha, ~55x phase 3's
    error over a 49x longer walk). A wrong loss, a lost scatter or a missed
    barrier moves dalpha and du by orders of magnitude more."""
    import torch
    nk = args[-1].shape[1]                    # perm, (K, nk)
    atol = ATOL * max(1.0, nk / CUT_NK)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    worst, bad = [0.0, 0.0], []
    for part, g, p in zip(("dalpha", "du"), got, want):
        a, r, ok = _errors(g, p, atol)
        worst = [max(worst[0], a), max(worst[1], r)]
        log(f"  {name} {part:6s} kernel vs plain at the main path's shape: "
            f"max_abs={a:.3e} max_rel={r:.3e} (tolerance |k - p| <= "
            f"{atol:.3e} + {RTOL} |p|) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(part)
    if bad:
        fail(f"{name} disagrees with its plain version on the main path's "
             f"round inputs: {bad}")
    return worst[0], worst[1], start.elapsed_time(end)


def _host_split(cfg, X, y, mask, state):
    """One more main-path round split on the host clock, each part fenced
    by a synchronize: the visit-order draw, the perm's host check and copy,
    the solver call (conjugate map, launch and kernel), the exchange and the
    update. Returns ms per part."""
    import torch
    from repro_torch import comm
    from repro_torch.core import cocoa, duality
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import ops
    K, nk = y.shape
    solver = cocoa.resolve_solver(cfg.solver, not torch.is_tensor(X))
    p = cfg.agg_params(K)
    n = float(duality.effective_n(mask))
    out = {}

    def fenced(part, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[part] = (time.perf_counter() - t0) * 1e3
        return res

    order = fenced("draw", lambda: cocoa.draw_visit_orders(
        solver, K, nk, cfg.H, SEED, state.rounds))
    perm = fenced("check_copy", lambda: ops.perm_i32(order, nk, y.device))
    res = fenced("solver", lambda: solver.fn(
        X, y, state.alpha, mask, state.w, perm, get_loss(cfg.loss), cfg.lam,
        n, p.sigma_prime, cfg.H, reg=cfg.regularizer()))
    dw, _ = fenced("exchange", lambda: comm.exchange(
        comm.Topology.simulated(K), res.du, state.ef, p,
        comm.NoCompression()))
    fenced("update", lambda: comm.apply_update(state.w, state.alpha, dw,
                                               res.dalpha, p))
    return out


def phase_times(dense, sparse, cut_errs):
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import local_sdca as dk, sparse_sdca as sk
    hinge = {"loss": get_loss("hinge")}
    log("[6 times] kernel vs plain on the main path's next-round inputs; "
        "CUDA events, mean of repeated launches after a warm-up")
    out = []
    # dense at epsilon's shape
    Xp, yp, mk, r, cfg, launches = dense
    K, nk, d = Xp.shape
    w, scale, perm = _round_inputs(cfg, Xp, yp, mk, r.state)
    args = (Xp, yp, r.state.alpha, mk, w, scale, perm)
    errs = _against_plain("local_sdca", dk.local_sdca, dk.local_sdca_plain,
                          args, hinge)
    ms = _time_ms(lambda: dk.local_sdca(*args, **hinge), 3)
    out.append(("local_sdca", "src/repro_torch/kernels/csrc/local_sdca.cu",
                "src/repro/kernels/local_sdca.py:56", launches, r, errs,
                cut_errs["local_sdca"], ms,
                4 * (K * nk * d + 5 * K * nk + d + K * d), 6 * K * nk * d,
                f"K={K} nk={nk} d={d}",
                _host_split(cfg, Xp, yp, mk, r.state)))
    # sparse at rcv1's shape
    sh, yp, mk, r, cfg, launches, nnz = sparse
    K, nk, r_max = sh.cols.shape
    w, scale, perm = _round_inputs(cfg, sh, yp, mk, r.state)
    args = (sh.cols, sh.vals, yp, r.state.alpha, mk, w, scale, perm)
    errs = _against_plain("sparse_sdca", sk.sparse_local_sdca,
                          sk.sparse_local_sdca_plain, args, hinge)
    ms = _time_ms(lambda: sk.sparse_local_sdca(*args, **hinge), 3)
    out.append(("sparse_sdca", "src/repro_torch/kernels/csrc/sparse_sdca.cu",
                "src/repro/kernels/sparse_sdca.py:172", launches, r, errs,
                cut_errs["sparse_sdca"], ms,
                8 * nnz + 4 * (5 * K * nk + sh.d + K * sh.d), 6 * nnz,
                f"K={K} nk={nk} r_max={r_max} d={sh.d} nnz={nnz}",
                _host_split(cfg, sh, yp, mk, r.state)))
    rows = []
    for (name, src, repl, launches, r, (abs_err, rel_err, plain), cut, ms,
         nbytes, flops, shape, split) in out:
        rounds = len(r.history["round"])
        per_round = launches / rounds
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"  {name}: {ms:.3f} ms/launch at {shape}; bound {bound_ms:.4f} "
            f"ms ({bound_by}: {nbytes} B at 3.35 TB/s, {flops} flop at 67 "
            f"TFLOP/s) -> {ms / bound_ms:.0f}x the bound; launches/round "
            f"{per_round:g}; plain {plain:.3f} ms at the same shape; "
            f"library call: none")
        steady = r.history["execute_s"][1:] or r.history["execute_s"]
        log(f"  {name} one round on the host clock (ms): " + ", ".join(
            f"{k}={v:.3f}" for k, v in split.items())
            + f"; sum={sum(split.values()):.3f}; solver minus kernel="
            f"{split['solver'] - ms:.3f}; main path execute_s after round 1 "
            f"mean={1e3 * sum(steady) / len(steady):.3f}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "status": "ported",
                     "launches": launches, "rounds": rounds,
                     "launches_per_round": per_round,
                     "max_abs_err": abs_err, "max_rel_err": rel_err,
                     "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "shape": shape, "cut_max_abs_err": cut[0],
                     "cut_max_rel_err": cut[1], "host_split_ms": split})
    return rows


def main() -> None:
    import torch
    name, count, smi_line = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401  (the port under test)
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    cut_errs = phase_kernels(dev)
    sparse = phase_sparse(dev)
    dense = phase_dense(dev)
    rows = phase_times(dense, sparse, cut_errs)
    log(json.dumps({"kernels": rows}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
