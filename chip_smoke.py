#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Needs one NVIDIA card and nvcc; run from the root of a checkout. Phases, in
order, each failing the run with a non-zero exit:

  1. device    name, count, power limit, torch and CUDA versions
  2. build     the five kernel sources in csrc/, one nvcc each, in
               parallel, with -Xptxas -v's registers and shared memory
               (six kernels: the 1-D sparse source is rows 2 and 3 of the
               kernel table, at ring depth 1 and at depth >= 2); each
               library's shared-memory layout against the wrappers'
               budgets (the dense kernel at every window and phase 3's
               widths, the scan at every G instance and phase 7's
               N); cuobjdump -sass of flash attention: HMMA (tensor
               core) instructions in every bfloat16 instance
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the real widths (d = 2,000 dense, d = 47,236 sparse) and a cut
               row count, every closed-form loss, prox on and off, rows with
               duplicate column ids and column-0 entries next to padding;
               the windowed dense kernel also at d = 54 and 2,001, windows
               B = 1, 4, 16, 32, nk = 1, below B and not a multiple of B,
               1-3 passes, zero and masked rows, and in column tiles at
               d = 20,000 and 20,001 (B = 8, 2); the sparse kernel at
               depths 2-4 and 8 (nk below and above the depth) also bit
               for bit against itself at depth 1 on rows with unique
               column ids, and at depths 1, 2, 4, 8 with 4-byte row
               copies (K = 3, nk = 101, r_max = 117) and rows wider than
               a lane's 128 register slots (r_max = 200, duplicate ids
               across slot 128); the z-exchange kernel (one launch a
               round, a cluster of M blocks per worker) at M = 1, 2, 4, 8,
               B = 1, 16, 128 with ragged last blocks, 1-3 passes, one and
               two blocks a pass, u in shared memory and (d_loc = 65,536)
               in device memory, and at B = 1, M = 1 against the sparse
               kernel at depth 1
  4. sparse    the main path (`solve`, sdca_sparse_kernel) at rcv1's
               published shape, 677,399 x 47,236 at density 0.0016, K = 8,
               hinge, lambda = 1e-6, after a small-input cross-check of the
               card against the CPU: the sparse kernel at the card's
               cache-miss ring depth, 4 (the prefetching walk)
  5. dense     the main path (`solve`, sdca_kernel) at epsilon's published
               shape, 400,000 x 2,000, K = 8 (3.2 GB of X on the card),
               hinge, lambda = 1e-4
  6. times     each kernel held against its plain version once more, on the
               main path's own next-round inputs at the main path's shapes
               (those are the errors and the plain time the summary
               reports), within phase 3's tolerance with its absolute part
               scaled by the walk's length (`_against_plain`); the kernel's
               time with CUDA events beside its bound, and us a step; the
               dense kernel at windows B = 4, 8, 16, 32 in turns; one more
               round split on the host clock
  7. lm-kernels  flash attention and the selective scan against their plain
               versions on the card at cut shapes: GQA, MQA, softcap, ragged
               tails, float32 and bfloat16, head_dim 64, 128 and 256; the
               bfloat16 (tensor-core) instance at head_dim 32-256 and S = 1,
               63, 64, 65, 200, 1,345, GQA 4, MQA, softcap 50; scan
               d_inner 256 and 8,192, N = 16, ragged S, and the cut
               shapes of the state-group kernel: N = 1, 5, 8, 16; S = 1,
               63, 64, 65 and one past the second chunk edge (129); B =
               3; d_inner 200 and 203 (not a multiple of a block's 32
               channels; 203 takes the 4-byte copies); every G
  8. serve     the LM serving path: stablelm-1.6b at full width and depth
               (24 layers, d_model 2,048, 32 x 64 heads, vocab 100,352,
               bf16, 1.64 B random weights from the seed) with
               use_flash_attention, `ServingEngine(slots=4, s_max=2048)`, 8
               requests of 256-1,536 prompt tokens and 32 new tokens, timed
               after the same prompts warmed a throwaway engine; every
               request finishes with in-range tokens; one prefill's logits
               with the kernel against the same prefill through the plain
               `chunked_attention`
  9. mamba     the scoring forward (`forward_train`, no grad) of
               falcon-mamba-7b at full width and depth (64 layers, d_model
               4,096, d_inner 8,192, N 16, vocab 65,024, bf16, 7.27 B random
               weights) on one TokenStream batch, B = 1, S = 2,048, with
               use_fused_ssm, held against the same forward through the
               chunked scan: the loss, and the last block's output by
               relative RMS; the same forward with D x planted out of the
               kernel's y must fail that check
 10. lm-times  each LM kernel against its plain version on the path's own
               inputs (layer 0's kernel arguments, kept as phase 8's first
               prompt and phase 9's batch ran), then its time with CUDA
               events beside its bound, the plain version's and, for flash,
               scaled_dot_product_attention's; the scan's exp floor on its
               own line, and its G sweep (G = 4, 8, 16 states a thread,
               in turns after half a second of launches, each held to
               the plain version)
 11. depth-1   phase 4's main path again (rcv1 shape, K = 8, 5 rounds)
               with buffer_depth 1 resolved from a one-entry autotune cache
               named by REPRO_TORCH_AUTOTUNE_CACHE: the sparse kernel walks
               without prefetching, and the state equals phase 4's bit for
               bit; its time per launch and per step at depth 1, 2, 4, 8
 12. mesh2d    the feature-sharded path: after a small-input cross-check of
               card against CPU, phase 4's CSR partitioned K = 4, M = 2 (the
               reference's --mesh 4x2) and solved through `solve` on
               `make_test_mesh((4, 2))` with sdca_sparse_kernel, 5 rounds:
               the z-exchange kernel, one launch a round of n_passes * nb
               steps
 13. new-times the depth-1 walk and the zx kernel against their plain
               versions on their paths' next-round inputs (phase 11's are
               phase 4's, so phase 6's plain result serves), times beside
               the bounds; the zx kernel's ms a round and us a step
 14. wire      the wire stack on the main path's tensors, each run through
               `solve` with the launch counts at 0 just before it: phase
               4's rcv1 path (K = 8, 5 rounds) under `topology="a2a"` (the
               gaps equal phase 4's to their printed digits), `hier:4`
               (within 1e-6 relative) and top-k 64 gathered over hier:4
               (its gap is `gap_at_v`'s at the carried v; comm_floats is
               the tracer's plan with inter_gather measured after the
               pods' dedup and at most its bound; on the next round's du
               the gathered sum equals the dense top-k sum within 1e-6 of
               its largest entry, with the same EF residual; the
               exchange's ms a round by CUDA events beside the kernel's);
               phase 5's epsilon path (K = 8) 3 rounds each under int8 and
               QSGD, sigma_k and the Table-1 ratio at the full (8, 50,000,
               2,000) shape, and the gd and sdca_deadline solvers for 2
               rounds at H = 2,048 with worker 3's budget cut to 204 (its
               steps and its dalpha against a static 204-step run); phase
               12's 4 x 2 mesh, top-k 64 split 32 / 32 over the model
               shards and gathered over hier:2, 3 rounds of the zx kernel

The sparse path runs at lambda = 1e-6, not 1e-4: the synthetic rcv1-shaped
rows are nearly orthogonal, and at lambda = 1e-4 (lambda n = 68) one pass
already reaches float32's noise floor. The gap then came out 0.0 after the
first round, `solve`'s eps_gap = 0 exit (gap <= eps_gap) stopped the run
after one certified round, and there was no falling gap to check.

The line before the last is the card's name and power limit, the one
before that the kernels' JSON summary, the last line the run's JSON result.
"""
from __future__ import annotations

import contextlib
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
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 dense tensor-core peak
SMS, MUFU_PER_CLOCK = 132, 16  # H100 SXM SMs; MUFU.EX2 lanes an SM
RTOL, ATOL = 1e-4, 1e-5        # kernel vs plain (reduction order differs)
CUT_NK = 1024                  # phase 3's rows per worker
CACHE_DEPTH = 1                # phase 11's cached buffer_depth
TABLE_ORDER = ("local_sdca", "sparse_sdca", "sparse_sdca_pipelined",
               "sparse_sdca_zx", "ssm_scan", "flash_attention")
DEPTHS = (1, 2, 4, 8)          # phase 11's timed ring depths
SWEEP_B = (4, 8, 16, 32)       # phase 6's timed dense windows
DENSE_WIDTHS = (54, 2_000, 2_001)   # phase 3's dense widths
WIDE_D = 20_000                # phase 3's dense width in column tiles
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
    if set(infos) != set(build.KERNELS):
        fail(f"built {sorted(infos)}, expected {sorted(build.KERNELS)}")
    from repro_torch.kernels import sparse_sdca as sk
    for info in infos.values():
        log(f"  {info.name}: nvcc {info.seconds:.2f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if any(k in line for k in ("registers", "smem", "Compiling",
                                       "spill")):
                log(f"    {line.strip()}")
    log(f"  sparse_sdca_pipelined dynamic shared memory per block, limit "
        f"232448 B: 4 d + 4 depth (2 r_max + {sk.STAGE_SCALARS}) bytes "
        f"(d=47236, r_max=118: " + ", ".join(
            f"depth {k}: "
            f"{sk.smem_budget(d=47_236, r_max=118, buffer_depth=k)['total_bytes']}"
            f" B" for k in DEPTHS) + ")")
    _layouts()
    _tensor_cores(infos["flash_attention"].path)


def _layouts():
    """Each library's shared-memory layout against its wrapper's budget:
    the dense kernel at every window and phase 3's widths (whole rows and
    column tiles), flash at every (head dim, dtype), the zx kernel at
    rcv1's 4 x 2 shape (u in shared memory) and at d_loc = 65,536 (u in
    device memory)."""
    from repro_torch.kernels import build, flash_attention as fa
    from repro_torch.kernels import local_sdca as dk
    from repro_torch.kernels import sparse_sdca as sk
    lib = build.load("local_sdca")
    for d in DENSE_WIDTHS + (WIDE_D,):
        parts = []
        for B in dk.BLOCK_ROWS:
            want = dk.dense_smem_budget(d, B)
            got = lib.local_sdca_smem_bytes(d, B, want["d_tile"])
            parts.append(f"B={B}: {got} B ({want['chunks']} x "
                         f"{want['d_tile']})")
            if got != want["total_bytes"]:
                fail(f"local_sdca's shared memory at d={d} B={B}: {got}, "
                     f"dense_smem_budget {want}")
        log(f"  local_sdca d={d} shared memory per block (column tiles x "
            f"d_tile), equal to dense_smem_budget: " + ", ".join(parts))
    lib = build.load("flash_attention")
    for dt, code in fa.DTYPES.items():
        got = {hd: lib.flash_attention_smem_bytes(hd, code)
               for hd in fa.HEAD_DIMS}
        want = {hd: fa.smem_bytes(hd, dt) for hd in fa.HEAD_DIMS}
        log(f"  flash_attention {str(dt)[6:]} dynamic shared memory per "
            f"block: " + ", ".join(f"hd={hd}: {b} B" for hd, b in got.items())
            + f" (the wrapper's smem_bytes: {'equal' if got == want else want})")
        if got != want:
            fail("flash_attention's shared memory differs from smem_bytes")
    lib = build.load("sparse_sdca_zx")
    for K, M, nk, d_loc, B, r in ((4, 2, 169_350, 23_618, 16, 70),
                                  (8, 1, 84_675, 65_536, 16, 118)):
        plan = sk.zx_launch_plan(K, M, nk, d_loc, B, r_loc=r)
        got = lib.sparse_sdca_zx_smem_bytes(B, r, d_loc,
                                            int(plan["u_in_smem"]))
        fit = sk._zx_clusters_fit(lib, M, B, r, d_loc, plan["u_in_smem"])
        log(f"  sparse_sdca_zx at K={K} M={M} d_local={d_loc} B={B} "
            f"r_loc={r}: {plan['launches']} launch of {K} clusters of {M}, "
            f"{plan['steps']} steps; u in "
            f"{'shared' if plan['u_in_smem'] else 'device'} memory; {got} B "
            f"of shared memory per block (smem_budget: "
            f"{plan['smem_bytes']}); clusters resident at once: {fit}")
        if got != plan["smem_bytes"] or fit < 1:
            fail(f"sparse_sdca_zx layout or cluster fit: {got}, {plan}, {fit}")
    from repro_torch.kernels import ssm_scan as ss
    lib = build.load("ssm_scan")
    for N in SCAN_STATES:
        got = {g: lib.ssm_scan_smem_bytes(N, g) for g in ss.GROUPS}
        want = {g: ss.scan_launch_plan(1, 1, 1, N, g)["smem_bytes"]
                for g in got}
        log(f"  ssm_scan N={N} dynamic shared memory per block by G: "
            + ", ".join(f"G={g}: {b} B" for g, b in got.items())
            + f" (scan_launch_plan: {'equal' if got == want else want})")
        if got != want:
            fail("ssm_scan's shared memory differs from scan_launch_plan")
    if lib.ssm_scan_smem_bytes(17, ss.DEFAULT_GROUP) != -1:
        fail("ssm_scan's library takes N = 17")


def _tensor_cores(path):
    """Count HMMA (tensor-core) instructions per kernel in the flash
    library's SASS; every bfloat16 instance (flash_tc_kernel) must have
    them."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    tc = {k: v for k, v in counts.items() if "flash_tc_kernel" in k}
    simt = {k: v for k, v in counts.items() if "flash_tc_kernel" not in k}
    log(f"  flash_attention SASS: HMMA per bfloat16 instance "
        f"{sorted(tc.values())}, per float32 (SIMT) instance "
        f"{sorted(simt.values())}")
    if len(tc) != 4 or not all(tc.values()):
        fail(f"flash_attention's bfloat16 instances lack tensor-core "
             f"instructions: {tc}")


def _errors(got, want, atol=ATOL, rtol=RTOL):
    """(max abs error, max rel error, ok) for |got - want| <= atol + rtol
    |want|, compared in float32."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    abs_err = float(diff.max())
    rel_err = float((diff / want.abs().clamp_min(1e-6)).max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
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


def _ell(rng, K, nk, d, r_max):
    """(cols, vals, nnz) numpy, padded ELL with duplicate column ids and
    column-0 entries next to padding."""
    import numpy as np
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
    return cols, vals, nnz.astype(np.int32)


def _unique_ell(rng, K, nk, d, r_max):
    """(cols, vals) numpy, padded ELL rows without duplicate column ids
    (the condition for the prefetching kernel's bit equality)."""
    import numpy as np
    nnz = rng.integers(1, r_max + 1, size=(K, nk))
    cols = np.stack([[np.sort(rng.choice(d, r_max, replace=False))
                      for _ in range(nk)] for _ in range(K)])
    live = np.arange(r_max)[None, None, :] < nnz[..., None]
    vals = np.where(live, rng.standard_normal((K, nk, r_max)), 0.0)
    vals /= np.linalg.norm(vals, axis=-1, keepdims=True)
    return (np.where(live, cols, 0).astype(np.int32),
            vals.astype(np.float32))


def _rows_case(rng, cols, vals, d, dev):
    """The case's tensors on `dev`: cols, vals, y, alpha, mask, w, perm."""
    import numpy as np
    import torch
    K, nk = cols.shape[:2]
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(cols), t(vals), t(y), t(alpha), t(mask), t(w),
            t(_perm(rng, K, nk)))


def sparse_case(rng, K, nk, d, r_max, dev):
    cols, vals, _ = _ell(rng, K, nk, d, r_max)
    return _rows_case(rng, cols, vals, d, dev)


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
    errs["local_sdca"] = [max(a, b) for a, b in zip(
        errs["local_sdca"], _cut_dense(rng, dev, scale, bad))]
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
    errs["sparse_sdca_pipelined"] = _cut_pipelined(rng, dev, sparse_in,
                                                   scale, bad)
    errs["sparse_sdca_zx"] = _cut_zx(rng, dev, scale, bad)
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return errs


def _dense_rows(rng, K, nk, d, dev):
    """A dense case with a zero row of mask 1 (q = 0, the guarded no-op),
    a masked row with values and a zero masked row where nk allows."""
    import numpy as np
    import torch
    X = rng.standard_normal((K, nk, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    if nk >= 4:
        X[:, 1] = 0.0
        mask[:, 2] = 0.0
        X[:, -1], mask[:, -1], alpha[:, -1] = 0.0, 0.0, 0.0
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(X), t(y), t(alpha), t(mask), t(w), t(_perm(rng, K, nk)))


def _cut_dense(rng, dev, scale, bad):
    """The windowed dense kernel at cut shapes against its plain version:
    d = 54 (fewer columns than threads), 2,000 (16-byte copies; column
    tiles at B = 16 and 32) and 2,001 (4-byte copies); B = 1, 4, 16, 32;
    column tiles at the default B = 8 (d = 20,000 and 20,001) and B = 2;
    nk = 1, below B and not a multiple of B; 1-3 passes; every loss; zero
    and masked rows. Returns the max (abs, rel) errors."""
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import local_sdca as dk
    losses = ("hinge", "smooth_hinge", "squared", "absolute")
    runs = []
    for i, (d, B) in enumerate((d, B) for d in DENSE_WIDTHS
                               for B in (1, 4, 16, 32)):
        runs.append((8, 1000, d, B, losses[i % 4], 1 + i % 3))
    runs += [(8, nk, 2_000, B, losses[i % 4], 2 + i % 2)
             for i, (nk, B) in enumerate(((1, 16), (1, 32), (5, 16),
                                          (13, 32), (40, 16), (3, 4)))]
    # column tiles at the default window and at B = 2 (9 and 2 tiles)
    runs += [(8, 40, WIDE_D, 8, "hinge", 2),
             (4, 19, WIDE_D + 1, 8, "squared", 3),
             (4, 13, WIDE_D, 2, "smooth_hinge", 2)]
    worst = [0.0, 0.0]
    for K, nk, d, B, loss_name, n_passes in runs:
        ins = _dense_rows(rng, K, nk, d, dev)
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes)
        got = dk.local_sdca(*ins[:5], scale, ins[5], block_rows=B, **kw)
        want = dk.local_sdca_plain(*ins[:5], scale, ins[5], **kw)
        torch.cuda.synchronize()
        for part, g, p in zip(("dalpha", "du"), got, want):
            a, r, ok = _errors(g, p)
            worst = [max(worst[0], a), max(worst[1], r)]
            log(f"  dense d={d} B={B:2d} nk={nk} {loss_name:12s} "
                f"passes={n_passes} {part:6s} max_abs={a:.3e} "
                f"max_rel={r:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"dense d={d} B={B} nk={nk} {loss_name} {part}")
        if nk >= 4 and not bool((got[0][:, [2, nk - 1]] == 0).all()):
            bad.append(f"dense d={d} B={B} nk={nk}: a masked row moved")
    return worst


def _cut_pipelined(rng, dev, sparse_in, scale, bad):
    """The prefetching kernel at cut shapes: against the plain version on
    rows with duplicate ids, and bit for bit against the depth-1 kernel on
    rows with unique ids, at depths 2-4 and 8 with nk above and below the
    depth.
    Returns the max (abs, rel) errors against the plain version."""
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import sparse_sdca as sk
    worst = [0.0, 0.0]
    cases = [(loss_name, kappa, depth, n_passes)
             for depth in (2, 3, 4, 8)
             for loss_name, kappa, n_passes in (
                 ("hinge", None, 1), ("smooth_hinge", 0.5, 2),
                 ("squared", None, 2), ("absolute", 0.5, 1))]
    for loss_name, kappa, depth, n_passes in cases:
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes,
                  prox_kappa=kappa)
        got = sk.sparse_local_sdca(*sparse_in[:6], scale, sparse_in[6],
                                   buffer_depth=depth, **kw)
        want = sk.sparse_local_sdca_plain(*sparse_in[:6], scale,
                                          sparse_in[6], **kw)
        torch.cuda.synchronize()
        for part, g, p in zip(("dalpha", "du"), got, want):
            a, r, ok = _errors(g, p)
            worst = [max(worst[0], a), max(worst[1], r)]
            log(f"  pipelined d=47236 depth={depth} {loss_name:12s} "
                f"kappa={kappa} passes={n_passes} {part:6s} max_abs={a:.3e} "
                f"max_rel={r:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"pipelined depth={depth} {loss_name} {part}")
    K, d = 8, 47_236
    for nk, depth, n_passes in ((CUT_NK, 2, 2), (CUT_NK, 3, 1),
                                (CUT_NK, 4, 2), (CUT_NK, 8, 2), (97, 8, 3),
                                (3, 4, 3), (1, 2, 2), (40, 8, 2)):
        uniq = _rows_case(rng, *_unique_ell(rng, K, nk, d, 118), d, dev)
        same = []
        for loss_name in ("hinge", "smooth_hinge", "squared", "absolute"):
            for kappa in (None, 0.5):
                kw = dict(loss=get_loss(loss_name), n_passes=n_passes,
                          prox_kappa=kappa)
                deep = sk.sparse_local_sdca(*uniq[:6], scale, uniq[6],
                                            buffer_depth=depth, **kw)
                one = sk.sparse_local_sdca(*uniq[:6], scale, uniq[6], **kw)
                torch.cuda.synchronize()
                same.append(all(torch.equal(a, b)
                                for a, b in zip(deep, one)))
        log(f"  pipelined vs depth 1, unique column ids, nk={nk} "
            f"depth={depth} passes={n_passes}, 4 losses x prox on/off: "
            f"{'bit for bit' if all(same) else 'DIFFER'}")
        if not all(same):
            bad.append(f"pipelined nk={nk} depth={depth} not bit-equal")
    worst = [max(a, b) for a, b in zip(worst, _cut_walk_branches(
        rng, dev, scale, bad))]
    return worst


def _straddle(cols, vals, slot=128):
    """A copy of padded-ELL `cols` where every row live at slot + 2 repeats
    ids across `slot`, the first slot a walk lane reads from the stage and
    not from its registers: slot -> slot 0 (the same lane), slot + 1 ->
    slot - 1 and slot + 2 -> slot / 2 (other lanes)."""
    import numpy as np
    cols = cols.copy()
    live = vals[..., slot + 2] != 0
    for dst, src in ((slot, 0), (slot + 1, slot - 1), (slot + 2, slot // 2)):
        cols[..., dst] = np.where(live, cols[..., src], cols[..., dst])
    return cols


def _cut_walk_branches(rng, dev, scale, bad):
    """The 1-D walk's two other branches at depths 1, 2, 4 and 8: 4-byte
    row copies (K * nk * r_max % 4 != 0: K = 3, nk = 101, r_max = 117) and
    rows wider than the 128 slots a lane keeps in registers (r_max = 200,
    duplicate ids across slot 128). Against the plain version on rows with
    duplicate ids, and bit for bit against depth 1 on rows with unique ids.
    Returns the max (abs, rel) errors against the plain version."""
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import sparse_sdca as sk
    worst = [0.0, 0.0]
    d = 47_236
    for K, nk, r_max in ((3, 101, 117), (4, 96, 200)):
        cols, vals, _ = _ell(rng, K, nk, d, r_max)
        if r_max > 130:
            cols = _straddle(cols, vals)
        dup = _rows_case(rng, cols, vals, d, dev)
        uniq = _rows_case(rng, *_unique_ell(rng, K, nk, d, r_max), d, dev)
        held = {depth: [0.0, True, True] for depth in (1, 2, 4, 8)}
        for i, (loss_name, kappa) in enumerate(
                (ln, kp) for ln in ("hinge", "smooth_hinge", "squared",
                                    "absolute") for kp in (None, 0.5)):
            kw = dict(loss=get_loss(loss_name), n_passes=1 + i % 2,
                      prox_kappa=kappa)
            want = sk.sparse_local_sdca_plain(*dup[:6], scale, dup[6], **kw)
            one = sk.sparse_local_sdca(*uniq[:6], scale, uniq[6], **kw)
            for depth, h in held.items():
                got = sk.sparse_local_sdca(*dup[:6], scale, dup[6],
                                           buffer_depth=depth, **kw)
                deep = sk.sparse_local_sdca(*uniq[:6], scale, uniq[6],
                                            buffer_depth=depth, **kw)
                torch.cuda.synchronize()
                h[2] &= all(torch.equal(a, b) for a, b in zip(deep, one))
                for g, p in zip(got, want):
                    a, r, ok = _errors(g, p)
                    worst = [max(worst[0], a), max(worst[1], r)]
                    h[0], h[1] = max(h[0], a), h[1] and ok
        for depth, (a, ok, same) in held.items():
            log(f"  walk K={K} nk={nk} r_max={r_max} depth={depth}, 4 "
                f"losses x prox on/off, 1-2 passes: vs plain max_abs="
                f"{a:.3e} {'ok' if ok else 'FAIL'}; unique ids vs depth 1 "
                f"{'bit for bit' if same else 'DIFFER'}")
            if not (ok and same):
                bad.append(f"walk K={K} r_max={r_max} depth={depth}")
    return worst


def _cut_zx(rng, dev, scale, bad):
    """The z-exchange kernel at cut shapes against its plain version: M =
    1, 2, 4, 8 and B = 1, 16, 128 at nk = 1,000 (B = 16 and 128 leave a
    ragged last block), 1-3 passes, prox on and off; one and two blocks a
    pass (nk = 100 and 200 at B = 128); one, two and three at B = 1 (nk =
    1, 2, 3, three passes); u in device memory (d_loc = 65,536 at M = 1);
    and at B = 1, M = 1 against the depth-1 kernel.
    Returns the max (abs, rel) errors against the plain version."""
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.data.sparse import SparseShards, shard_features
    from repro_torch.kernels import sparse_sdca as sk

    def rows(K, nk, d, r_max):
        cols, vals, nnz = _ell(rng, K, nk, d, r_max)
        ins = _rows_case(rng, cols, vals, d, dev)
        return SparseShards(ins[0], ins[1], torch.from_numpy(nnz).to(dev),
                            d=d), ins

    worst = [0.0, 0.0]
    sh, base = rows(4, 1000, 47_236, 128)
    cases = [(M, B, loss_name, kappa, 2 if B > 1 else 1)
             for M in (1, 2, 4) for B, loss_name, kappa in (
                 (1, "hinge", None), (16, "smooth_hinge", 0.5))]
    cases += [(2, 16, loss_name, kappa, 2)
              for loss_name in ("hinge", "squared", "absolute")
              for kappa in (None, 0.5)]
    cases += [(8, 16, "hinge", 0.5, 2), (8, 128, "squared", None, 3),
              (8, 1, "smooth_hinge", None, 1), (4, 128, "absolute", 0.5, 1),
              (2, 128, "hinge", None, 3), (2, 1, "hinge", 0.5, 2),
              (8, 1, "squared", None, 3)]
    runs = [(f"M={case[0]} B={case[1]:3d} nk=1000", sh, base, *case)
            for case in cases]
    # B = 1 with one, two and three blocks a pass: dalpha prefetched two
    # blocks ahead reads rows the previous pass (or step) wrote
    for nk, M, loss_name, kappa in ((1, 2, "hinge", 0.5),
                                    (2, 4, "squared", None),
                                    (3, 2, "smooth_hinge", None)):
        runs.append((f"M={M} B=  1 nk={nk}", *rows(4, nk, 47_236, 128), M, 1,
                     loss_name, kappa, 3))
    for nk, loss_name, kappa in ((100, "hinge", 0.5), (200, "squared", None)):
        runs.append((f"M=2 B=128 nk={nk}", *rows(4, nk, 47_236, 128), 2, 128,
                     loss_name, kappa, 3))
    wide = rows(2, 300, 65_536, 64)
    runs += [(f"M=1 B={B:3d} d_loc=65536 (u in device memory)", *wide, 1, B,
              loss_name, kappa, 2)
             for B, loss_name, kappa in ((16, "hinge", 0.5),
                                         (1, "smooth_hinge", None))]
    for what, sh_, ins, M, B, loss_name, kappa, n_passes in runs:
        fs = shard_features(sh_, M)
        w = torch.nn.functional.pad(ins[5], (0, fs.d_padded - fs.d))
        sq = torch.sum(fs.vals * fs.vals, dim=(1, 3))
        args = (fs.cols, fs.vals, *ins[2:5], w, scale, sq, ins[6])
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes, block_rows=B,
                  prox_kappa=kappa)
        got = sk.sparse_local_sdca_zx(*args, **kw)
        want = sk.sparse_local_sdca_zx_plain(*args, **kw)
        torch.cuda.synchronize()
        for part, g, p in zip(("dalpha", "du"), got, want):
            a, r, ok = _errors(g, p)
            worst = [max(worst[0], a), max(worst[1], r)]
            log(f"  zx {what} {loss_name:12s} kappa={kappa} "
                f"passes={n_passes} {part:6s} max_abs={a:.3e} "
                f"max_rel={r:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"zx {what} {loss_name} {part}")
    fs = shard_features(sh, 1)
    hinge = get_loss("hinge")
    zx = sk.sparse_local_sdca_zx(fs.cols, fs.vals, *base[2:6], scale,
                                 torch.sum(fs.vals * fs.vals, dim=(1, 3)),
                                 base[6], loss=hinge, block_rows=1)
    one = sk.sparse_local_sdca(fs.cols[:, 0].contiguous(),
                               fs.vals[:, 0].contiguous(), *base[2:6], scale,
                               base[6], loss=hinge)
    torch.cuda.synchronize()
    for part, g, p in zip(("dalpha", "du"), zx, one):
        a, r, ok = _errors(g, p)
        log(f"  zx B=1 M=1 vs the depth-1 kernel {part:6s} max_abs={a:.3e} "
            f"max_rel={r:.3e} (phase 3's tolerance) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"zx B=1 M=1 vs sparse_sdca {part}")
    return worst


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
    K, nk = y.shape
    cfg = CoCoAConfig.adding(K, loss="hinge", lam=lam, H=nk, solver=solver)
    counts = _counts_zero()
    r = solve(cfg, X, y, mask, rounds=rounds, gap_every=1, seed=SEED)
    launches = counts()
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
    from repro_torch.kernels import autotune, ops
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
    r, launches, cfg = _main_path("rcv1 sdca_sparse_kernel", sh, yp, mk,
                                  "sdca_sparse_kernel", 5, SPARSE_LAM,
                                  "sparse_sdca_pipelined")
    used = dict(ops.LAST_SPARSE_CONFIG)
    log(f"  LAST_SPARSE_CONFIG {used}")
    if (used["buffer_depth"], used["source"]) != (
            autotune.CUDA_DEFAULT_BUFFER_DEPTH, "default"):
        fail(f"phase 4 did not run the card's cache-miss depth: {used}")
    return sh, yp, mk, r, cfg, launches, nnz, (csr, y), used["buffer_depth"]


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


def _time_ms(fn, reps=1, warm=True):
    """(ms per call on CUDA events, the last call's result): the mean of
    `reps` calls, after one warm-up call when `warm`."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _in_turns(keys, call, reps=1, each=None, rounds=1, warm_s=0.5):
    """Times `call(key)` for every key in turns: `rounds` rounds of keys
    in order, then reversed, `reps` calls a turn after a warm-up, with CUDA
    events, once `call` of the first key has run for `warm_s` seconds (the
    card's first turn otherwise reads slow, its clocks still rising).
    `each(key, result)` sees every turn's last result. Returns ({key: the
    median of its turns' ms a call}, {key: the last result})."""
    import statistics
    import torch
    keys = tuple(keys)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        call(keys[0])
        torch.cuda.synchronize()
    ms, outs = {k: [] for k in keys}, {}
    for _ in range(rounds):
        for k in keys + keys[::-1]:
            t, outs[k] = _time_ms(lambda: call(k), reps=reps)
            ms[k].append(t)
            if each is not None:
                each(k, outs[k])
    return {k: statistics.median(v) for k, v in ms.items()}, outs


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


def _against_plain(name, kernel, plain, args, kw, known=None):
    """One wrapper call and one plain call on the same inputs: the max
    errors over (dalpha, du), the plain call's time in ms and its result.
    `known` = (plain ms, plain result) of the same inputs, from an earlier
    phase, stands in for the plain call.

    Tolerance |k - p| <= ATOL * nk / CUT_NK + RTOL |p|: phase 3's, with its
    absolute part scaled by the walk's length. The kernel's block reduction
    and torch.sum round the row dot differently; each step's delta feeds
    the next, so the difference compounds over the nk dependent steps (the
    first run at epsilon's shape measured 1.55e-5 in dalpha, ~55x phase 3's
    error over a 49x longer walk). A wrong loss, a lost scatter or a missed
    barrier moves dalpha and du by orders of magnitude more."""
    nk = args[-1].shape[1]                    # perm, (K, nk)
    atol = ATOL * max(1.0, nk / CUT_NK)
    got = kernel(*args, **kw)
    if known is None:
        known = _time_ms(lambda: plain(*args, **kw), warm=False)
    plain_ms, want = known
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
    return worst[0], worst[1], plain_ms, want


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


def _at_depth(depth):
    """The 1-D sparse wrapper at ring depth `depth` (its plain version
    takes no depth)."""
    from repro_torch.kernels import sparse_sdca as sk
    return lambda *args, **kw: sk.sparse_local_sdca(
        *args, buffer_depth=depth, **kw)


def _sparse_bytes(nnz, K, nk, d):
    """Bytes a 1-D sparse round must move: 8 per nonzero (col id and
    value), the rows' y, alpha, mask, dalpha and perm, w, and du."""
    return 8 * nnz + 4 * (5 * K * nk + d + K * d)


def phase_times(dense, sparse, cut_errs):
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import local_sdca as dk, ops, sparse_sdca as sk
    hinge = {"loss": get_loss("hinge")}
    log("[6 times] kernel vs plain on the main path's next-round inputs; "
        "CUDA events, mean of repeated launches after a warm-up")
    out = []
    # dense at epsilon's shape
    Xp, yp, mk, r, cfg, launches = dense
    K, nk, d = Xp.shape
    w, scale, perm = _round_inputs(cfg, Xp, yp, mk, r.state)
    args = (Xp, yp, r.state.alpha, mk, w, scale, perm)
    *errs, dense_want = _against_plain("local_sdca", dk.local_sdca,
                                       dk.local_sdca_plain, args, hinge)
    ms, _ = _time_ms(lambda: dk.local_sdca(*args, **hinge), reps=3)
    steps = ops.n_passes_of(cfg.H, nk) * nk       # the chain of one worker
    sweep = _dense_sweep(args, hinge, dense_want)
    out.append(("local_sdca", "src/repro_torch/kernels/csrc/local_sdca.cu",
                "src/repro/kernels/local_sdca.py:56", launches, r, errs,
                cut_errs["local_sdca"], ms,
                4 * (K * nk * d + 5 * K * nk + d + K * d), 6 * K * nk * d,
                f"K={K} nk={nk} d={d} block_rows={dk.DEFAULT_BLOCK_ROWS}",
                _host_split(cfg, Xp, yp, mk, r.state),
                dict(us_per_step=1e3 * ms / steps,
                     block_rows=dk.DEFAULT_BLOCK_ROWS, block_rows_ms=sweep)))
    # sparse at rcv1's shape, at the main path's ring depth
    sh, yp, mk, r, cfg, launches, nnz, _, depth = sparse
    K, nk, r_max = sh.cols.shape
    w, scale, perm = _round_inputs(cfg, sh, yp, mk, r.state)
    args = (sh.cols, sh.vals, yp, r.state.alpha, mk, w, scale, perm)
    walk = _at_depth(depth)
    *errs, sparse_want = _against_plain(
        "sparse_sdca_pipelined", walk, sk.sparse_local_sdca_plain, args,
        hinge)
    ms, _ = _time_ms(lambda: walk(*args, **hinge), reps=3)
    steps = ops.n_passes_of(cfg.H, nk) * nk
    out.append(("sparse_sdca_pipelined",
                "src/repro_torch/kernels/csrc/sparse_sdca_pipelined.cu",
                "src/repro/kernels/sparse_sdca.py:205", launches, r, errs,
                cut_errs["sparse_sdca_pipelined"], ms,
                _sparse_bytes(nnz, K, nk, sh.d), 6 * nnz,
                f"K={K} nk={nk} r_max={r_max} d={sh.d} nnz={nnz} "
                f"depth={depth}",
                _host_split(cfg, sh, yp, mk, r.state),
                dict(us_per_step=1e3 * ms / steps)))
    rows = []
    for (name, src, repl, launches, r, (abs_err, rel_err, plain), cut, ms,
         nbytes, flops, shape, split, extra) in out:
        rounds = len(r.history["round"])
        rows.append(_row(name, src, repl, launches, launches / rounds,
                         "per round", (abs_err, rel_err), cut, ms, plain,
                         None, nbytes, flops, F32_FLOPS_PER_S,
                         "67 TFLOP/s f32", shape, rounds=rounds,
                         host_split_ms=split, **extra))
        log(f"  {name}: {extra['us_per_step']:.4f} us a step (the "
            f"{ms:.3f} ms over one worker's chain of steps)")
        steady = r.history["execute_s"][1:] or r.history["execute_s"]
        log(f"  {name} one round on the host clock (ms): " + ", ".join(
            f"{k}={v:.3f}" for k, v in split.items())
            + f"; sum={sum(split.values()):.3f}; solver minus kernel="
            f"{split['solver'] - ms:.3f}; main path execute_s after round 1 "
            f"mean={1e3 * sum(steady) / len(steady):.3f}")
    sparse_plain = (rows[1]["plain_ms"], sparse_want)
    return rows, sparse_plain


def _dense_sweep(args, hinge, want):
    """The dense kernel at every window of SWEEP_B on the main path's
    next-round inputs, in turns (B ascending, then descending), each result
    held to the plain version's `want` with `_against_plain`'s tolerance.
    Returns {B: ms a call}."""
    from repro_torch.kernels import local_sdca as dk
    nk = args[-1].shape[1]
    atol = ATOL * max(1.0, nk / CUT_NK)

    def held(B, got):
        for part, g, p in zip(("dalpha", "du"), got, want):
            a, _, ok = _errors(g, p, atol)
            if not ok:
                fail(f"local_sdca at block_rows={B} disagrees with its plain "
                     f"version on the main path's inputs: {part} {a:.3e}")
    ms, _ = _in_turns(SWEEP_B, lambda B: dk.local_sdca(
        *args, block_rows=B, **hinge), each=held)
    order = SWEEP_B + SWEEP_B[::-1]
    log(f"  local_sdca window sweep, ms a call (CUDA events, in turns "
        f"{', '.join(map(str, order))}; each held to the plain version): "
        + ", ".join(f"B={B}: {t:.3f} ({1e3 * t / nk:.4f} us a step)"
                    for B, t in ms.items())
        + f"; fastest B={min(ms, key=ms.get)}, default "
        f"{dk.DEFAULT_BLOCK_ROWS}")
    return ms


def _row(name, src, repl, launches, per, per_what, errs, cut, ms, plain_ms,
         lib_ms, nbytes, flops, peak, peak_name, shape, **extra):
    """One kernel's entry of the summary line, logged as it is made. `errs`
    and `cut` are (max abs, max rel) errors against the plain version on
    the path's inputs and at the cut shapes; `extra` adds keys."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
    log(f"  {name}: {ms:.3f} ms a call at {shape}; bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B at 3.35 TB/s, {flops} flop at "
        f"{peak_name}) -> {ms / bound_ms:.1f}x the bound; launches "
        f"{per:g} {per_what}; plain {plain_ms:.3f} ms at the same shape; "
        f"library call {lib}")
    return {"name": name, "route": "cuda", "source": src, "replaces": repl,
            "status": "ported", "launches": launches,
            f"launches_{per_what.replace(' ', '_')}": per,
            "max_abs_err": errs[0], "max_rel_err": errs[1], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "shape": shape, "cut_max_abs_err": cut[0],
            "cut_max_rel_err": cut[1], **extra}


# ----------------------------------------------------------------------------
# the LM seed: flash attention (phase 8) and the selective scan (phase 9)
# ----------------------------------------------------------------------------

FLASH_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2e-2, 2e-3)}
SCAN_RTOL, SCAN_ATOL = 2e-4, 2e-5
SCAN_STATES = (1, 5, 8, 16)    # phase 7's N: below, not dividing, equal to G
# phase 7's scan shapes (B, S, di, N, G; None: the default G): N, then S
# around the 64-step chunk, B = 3, di past a 32-channel block (203: the
# 4-byte copies and stores), then every instance of G
SCAN_CUTS = ([(2, 300, 256, 16, None), (1, 130, 8_192, 16, None)]
             + [(1, 100, 256, N, None) for N in SCAN_STATES]
             + [(1, S, 256, 16, None) for S in (1, 63, 64, 65, 129)]
             + [(3, 70, 256, 16, None), (2, 70, 200, 16, None),
                (1, 70, 203, 5, None)]
             + [(B, S, di, N, G) for G in (4, 8, 16)
                for B, S, di, N in ((3, 129, 200, 5), (1, 65, 256, 16),
                                    (2, 33, 203, 8))])
# prefill logits, flash kernel vs plain chunked_attention, both in bf16:
# relative RMS of the difference over the logits. Each attention output
# rounds to bf16 on both sides (p relative to the running max there, to
# the final max here), so they part by ~1 bf16 ulp per layer, carried
# through 24 layers; a wrong mask or head mapping moves it by O(1).
LOGITS_REL_RMS = 5e-2
# scoring forward, fused scan vs chunked scan (both float32 recurrences;
# their outputs round to bf16 before out_proj): relative RMS of the
# difference of the last block's outputs (the residual stream the loss
# reads). The two part by bf16 roundings that the random 64-layer stack
# amplifies layer by layer; the first full run read 5.59e-2 there, and the
# same forward with D x planted out of the kernel's y 1.02, so the limit
# sits between. Phase 9 logs the difference after every few blocks.
HIDDEN_REL_RMS = 0.2
# and the scoring loss of the two: relative difference
LOSS_RTOL = 2e-3


def _counts_zero():
    """Set every kernel's launch count to 0; returns a reader of them."""
    from repro_torch.kernels import (flash_attention as fa, local_sdca as dk,
                                     sparse_sdca as sk, ssm_scan as ss)
    for mod in (dk, sk, fa, ss):
        mod.LAUNCHES = 0
    sk.PIPELINED_LAUNCHES = 0
    sk.ZX_LAUNCHES = 0
    sk.ZX_STEPS = 0
    return lambda: {"local_sdca": dk.LAUNCHES, "sparse_sdca": sk.LAUNCHES,
                    "sparse_sdca_pipelined": sk.PIPELINED_LAUNCHES,
                    "sparse_sdca_zx": sk.ZX_LAUNCHES,
                    "sparse_sdca_zx_steps": sk.ZX_STEPS,
                    "flash_attention": fa.LAUNCHES,
                    "ssm_scan": ss.LAUNCHES}


@contextlib.contextmanager
def _wrapped(module, attr, around):
    """Inside the block, calls of `module.attr` (a kernel wrapper as a model
    module imported it) go to `around(wrapper, *args, **kw)`."""
    real = getattr(module, attr)
    setattr(module, attr, lambda *args, **kw: around(real, *args, **kw))
    try:
        yield
    finally:
        setattr(module, attr, real)


def _keep_first(seen):
    """An `around` that forwards every call and keeps the first call's
    (args, kwargs) in `seen`: layer 0's own kernel inputs."""
    def around(real, *args, **kw):
        if not seen:
            seen.append((args, kw))
        return real(*args, **kw)
    return around


def _rel_rms(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _rand(rng, shape, dev, dtype=None):
    import torch
    t = torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(dev)
    return t if dtype is None else t.to(dtype)


def _scan_case(rng, B, S, di, N, dev):
    import numpy as np
    import torch
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(rng.standard_normal((B, S, di))),
            t(0.1 * np.abs(rng.standard_normal((B, S, di)))),
            t(rng.standard_normal((B, S, N))),
            t(rng.standard_normal((B, S, N))),
            t(-np.abs(rng.standard_normal((di, N)))),
            t(rng.standard_normal(di)))


def phase_lm_kernels(dev):
    """Flash attention and the scan against their plain versions on the
    card at cut shapes. Returns the max (abs, rel) errors per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
    rng = np.random.default_rng(SEED)
    errs = {"flash_attention": [0.0, 0.0], "ssm_scan": [0.0, 0.0]}
    bad = []
    log("[7 lm-kernels] kernel vs plain on the card; tolerance |k - p| <= "
        f"atol + rtol |p|: flash float32 {FLASH_TOL['float32']}, bfloat16 "
        f"{FLASH_TOL['bfloat16']}; scan ({SCAN_RTOL}, {SCAN_ATOL})")

    def note(name, what, got, want, rtol, atol):
        torch.cuda.synchronize()
        a, r, ok = _errors(got, want, atol, rtol)
        errs[name] = [max(errs[name][0], a), max(errs[name][1], r)]
        log(f"  {what}: max_abs={a:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(what)

    cases = [(B, S, H, KV, hd, cap, dtype)
             for B, S, H, KV, hd, cap in ((2, 256, 8, 2, 64, None),  # GQA
                                          (1, 200, 8, 1, 128, None),  # MQA
                                          (2, 192, 4, 4, 64, 50.0),  # softcap
                                          (1, 130, 4, 2, 256, None))  # hd 256
             for dtype in ("float32", "bfloat16")]
    # the bfloat16 (tensor-core) instance at every head dim: S around the
    # 64-row tile and a prefill's length at GQA 4, then MQA and softcap 50
    cases += [(1, S, 8, 2, hd, None, "bfloat16") for hd in (32, 64, 128, 256)
              for S in (1, 63, 64, 65, 200, 1345)]
    cases += [(2, 130, 8, 1, hd, None, "bfloat16") for hd in (32, 64, 128,
                                                              256)]
    cases += [(1, 200, 4, 4, hd, 50.0, "bfloat16") for hd in (32, 64, 128,
                                                              256)]
    for B, S, H, KV, hd, cap, dtype in cases:
        dt = getattr(torch, dtype)
        q = _rand(rng, (B, S, H, hd), dev, dt)
        k, v = (_rand(rng, (B, S, KV, hd), dev, dt) for _ in range(2))
        note("flash_attention", f"flash B={B} S={S} H={H} KV={KV} hd={hd} "
             f"softcap={cap} {dtype}",
             fa.flash_attention(q, k, v, softcap=cap),
             fa.flash_attention_plain(q, k, v, softcap=cap),
             *FLASH_TOL[dtype])
    for B, S, di, N, G in SCAN_CUTS:
        ins = _scan_case(rng, B, S, di, N, dev)
        G = G or ss.DEFAULT_GROUP
        note("ssm_scan", f"ssm_scan B={B} S={S} di={di} N={N} G={G}",
             ss.ssm_scan(*ins, group=G), ss.ssm_scan_plain(*ins),
             SCAN_RTOL, SCAN_ATOL)
    if bad:
        fail(f"LM kernel disagrees with its plain version: {bad}")
    return errs


def _device_busy_ms(fn):
    """(ms, count): summed device time and number of the kernels (and
    copies) one call of `fn` runs, from a torch.profiler trace; (None, 0)
    when the trace holds no device activity. Kernels on one stream do not
    overlap, so the sum is the time the card was busy for the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return (sum(times) / 1e3, len(times)) if sum(times) > 0 else (None, 0)


def _busy_line(what, busy, wall_ms):
    ms, count = busy
    if ms is None:
        return f"  {what}: device busy not measured (no device events)"
    return (f"  {what}: {count} device kernels busy {ms:.3f} ms of "
            f"{wall_ms:.3f} ms on the host clock (unprofiled) -> idle share "
            f"{1 - ms / wall_ms:.3f}")


def phase_serve(dev):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.serving_runtime import ServingEngine
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              use_flash_attention=True)
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    lens = rng.integers(256, 1537, size=8)
    stream = TokenStream(cfg.vocab, 1, int(lens.max()), seed=SEED)
    prompts = [stream.batch_at(i)["tokens"][0, :n] for i, n in
               enumerate(lens)]
    log(f"[8 serve] stablelm-1.6b: {cfg.n_layers} layers d_model "
        f"{cfg.d_model} {cfg.n_heads}x{cfg.head_dim} heads vocab "
        f"{cfg.vocab} {cfg.dtype}, {n_params} params (random, made in "
        f"{time.perf_counter() - t0:.1f} s); prompts {lens.tolist()}")
    # warm-up: the same prompts, 2 tokens each, through a throwaway engine,
    # so that the timed run pays no first use (allocator growth, GEMM
    # heuristics for each prefill shape, each kernel's first launch)
    t0 = time.perf_counter()
    warm = ServingEngine(cfg, model, slots=4, s_max=2048, device=dev)
    for p in prompts:
        warm.submit(p, max_new=2)
    warm.run_until_drained()
    torch.cuda.synchronize()
    log(f"  warm-up engine: {len(prompts)} requests x 2 tokens in "
        f"{time.perf_counter() - t0:.3f} s")
    del warm
    eng = ServingEngine(cfg, model, slots=4, s_max=2048, device=dev)
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    counts = _counts_zero()
    steps = []
    t_run = time.perf_counter()
    while True:
        queued = len(eng.queue)
        t0 = time.perf_counter()
        live = eng.step()
        torch.cuda.synchronize()
        if live == 0 and not eng.queue:
            break
        steps.append((queued - len(eng.queue), live,
                      (time.perf_counter() - t0) * 1e3))
    run_s = time.perf_counter() - t_run
    launches = counts()
    log(f"  launches on the serving path: {launches}")
    if launches["flash_attention"] != len(reqs) * cfg.n_layers:
        fail(f"flash_attention launched {launches['flash_attention']} "
             f"times for {len(reqs)} prefills of {cfg.n_layers} layers")
    for r, p in zip(reqs, prompts):
        if not (r.done and len(r.out) == 32
                and all(0 <= t < cfg.vocab for t in r.out)):
            fail(f"request {r.rid} (prompt {len(p)}): done={r.done} "
                 f"{len(r.out)} tokens {r.out[:8]}...")
    generated = sum(len(r.out) for r in reqs)
    decode = [(live, ms) for n, live, ms in steps if n == 0]
    decode_ms = [ms for _, ms in decode]
    log(f"  {len(reqs)} requests done, {generated} tokens in {len(steps)} "
        f"engine steps, {run_s:.3f} s: {generated / run_s:.1f} generated "
        f"tokens/s over the run (prefills included); live per step "
        f"{[live for _, live, _ in steps]}")
    log(f"  decode ms per engine step (steps without a prefill, "
        f"{len(decode_ms)}): mean {sum(decode_ms) / len(decode_ms):.3f} "
        f"min {min(decode_ms):.3f} max {max(decode_ms):.3f}; "
        f"{1e3 * sum(n for n, _ in decode) / sum(decode_ms):.1f} tokens/s "
        f"over those steps")
    # one slot's prefill per request, timed alone on the host clock
    prefill_ms = []
    for p in prompts:
        cache = M.init_cache(cfg, 1, 2048, dev)
        tok = torch.from_numpy(p[None].astype(np.int64)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(model, {"tokens": tok}, cache)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    log("  prefill ms per request (one slot, host clock): " + ", ".join(
        f"S={len(p)}: {ms:.3f}" for p, ms in zip(prompts, prefill_ms)))
    tok = torch.from_numpy(prompts[0][None].astype(np.int64)).to(dev)
    busy = _device_busy_ms(lambda: M.prefill(
        model, {"tokens": tok}, M.init_cache(cfg, 1, 2048, dev)))
    log(_busy_line(f"prefill S={len(prompts[0])}", busy, prefill_ms[0]))
    toks = torch.ones((4, 1), dtype=torch.int64, device=dev)
    pos = int(lens.max()) + 16
    busy = _device_busy_ms(lambda: M.decode_step(model, eng.cache, toks,
                                                 pos))
    log(_busy_line(f"decode step (4 slots, pos {pos})", busy,
                   sum(decode_ms) / len(decode_ms)))
    # the kernel's prefill against the plain chunked_attention's, keeping
    # layer 0's flash inputs for phase 10
    logits, seen = {}, []
    for flag in (True, False):
        cache = M.init_cache(cfg, 1, 2048, dev)
        with _wrapped(M, "flash_attention", _keep_first(seen)):
            logits[flag], _ = M.prefill(
                model, {"tokens": tok}, cache,
                dataclasses.replace(cfg, use_flash_attention=flag))
    rel_rms = _rel_rms(logits[True], logits[False])
    log(f"  prefill logits (S={len(prompts[0])}) flash vs chunked_attention: "
        f"rel RMS {rel_rms:.3e} (limit {LOGITS_REL_RMS}), max abs "
        f"{float((logits[True] - logits[False]).abs().max()):.3e}, max "
        f"|logit| {float(logits[False].abs().max()):.3e}")
    if not (torch.isfinite(logits[True]).all() and rel_rms <= LOGITS_REL_RMS):
        fail(f"flash prefill logits differ from the plain path: {rel_rms}")
    del model, eng, cache
    return {"launches": launches["flash_attention"], "prefills": len(reqs),
            "call": seen[0]}


def phase_mamba(dev):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import model as M, ssm as S
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              use_fused_ssm=True)
    chunked = dataclasses.replace(cfg, use_fused_ssm=False)
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=SEED, device=dev)
    batch = TokenStream(cfg.vocab, 1, 2048, seed=SEED).tensors_at(0, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[9 mamba] falcon-mamba-7b: {cfg.n_layers} layers d_model "
        f"{cfg.d_model} d_inner {cfg.d_inner} N {cfg.ssm_state} vocab "
        f"{cfg.vocab} {cfg.dtype}, {n_params} params (random, made in "
        f"{time.perf_counter() - t0:.1f} s); B=1 S=2048")

    def score(c, around=None):
        """(loss, every block's output) of one scoring forward under `c`,
        its scan calls going through `around` when one is given."""
        out = []
        hooks = [blk.register_forward_hook(
            lambda _mod, _args, o: out.append(o[0])) for blk in model.blocks]
        with (_wrapped(S, "ssm_scan", around) if around
              else contextlib.nullcontext()):
            loss, _ = M.forward_train(model, batch, c)
        for hook in hooks:
            hook.remove()
        return float(loss), out

    def no_dx(real, xin, dt, Bm, Cm, A, D):
        return real(xin, dt, Bm, Cm, A, torch.zeros_like(D))

    counts = _counts_zero()
    with torch.no_grad():
        t0 = time.perf_counter()
        loss, hid = score(cfg)
        fused_s = time.perf_counter() - t0
        launches = counts()
        log(f"  launches on the scoring path: {launches}")
        if launches["ssm_scan"] != cfg.n_layers:
            fail(f"ssm_scan launched {launches['ssm_scan']} times in one "
                 f"forward of {cfg.n_layers} layers")
        t0 = time.perf_counter()
        plain, hid_plain = score(chunked)
        chunked_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(M.forward_train(model, batch, cfg)[0])
        warm_s = time.perf_counter() - t0
        seen = []
        with _wrapped(S, "ssm_scan", _keep_first(seen)):
            busy = _device_busy_ms(lambda: M.forward_train(model, batch, cfg))
        bad_loss, hid_bad = score(cfg, no_dx)
    rel = abs(loss - plain) / abs(plain)
    curve = [_rel_rms(a, b) for a, b in zip(hid, hid_plain)]
    curve_bad = [_rel_rms(a, b) for a, b in zip(hid_bad, hid_plain)]
    rms, rms_bad = curve[-1], curve_bad[-1]
    del hid, hid_plain, hid_bad
    at = [i for i in (1, 2, 4, 8, 16, 32) if i < cfg.n_layers] + [cfg.n_layers]
    log("  block output rel RMS vs chunked scan, fused / planted fault, "
        "after layer: " + ", ".join(
            f"{i}: {curve[i - 1]:.3e} / {curve_bad[i - 1]:.3e}" for i in at))
    log(f"  loss fused {loss:.6f} ({fused_s:.3f} s; again, warm: "
        f"{warm_s:.3f} s) vs chunked scan {plain:.6f} ({chunked_s:.3f} s): "
        f"rel diff {rel:.3e} (limit {LOSS_RTOL}); ln(vocab) = "
        f"{math.log(cfg.vocab):.4f}")
    log(f"  last block's output, fused vs chunked scan: rel RMS {rms:.3e} "
        f"(limit {HIDDEN_REL_RMS}); planted fault, D x dropped from the "
        f"kernel's y: rel RMS {rms_bad:.3e}, loss {bad_loss:.6f} (rel diff "
        f"{abs(bad_loss - plain) / abs(plain):.3e})")
    log(_busy_line("fused scoring forward, warm", busy, warm_s * 1e3))
    if not (math.isfinite(loss) and rel <= LOSS_RTOL
            and rms <= HIDDEN_REL_RMS):
        fail(f"fused-scan forward differs from the chunked scan's: rel RMS "
             f"{rms}, loss {loss} vs {plain}")
    if not rms_bad > HIDDEN_REL_RMS:
        fail(f"the fused-vs-chunked check does not see a planted fault "
             f"(rel RMS {rms_bad} <= {HIDDEN_REL_RMS})")
    del model
    return {"launches": launches["ssm_scan"], "call": seen[0]}


def phase_lm_times(serve, mamba, cut_errs):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
    log("[10 lm-times] kernel vs plain on layer 0's own inputs, kept from "
        "phases 8 and 9, then CUDA events (mean of 10 launches after a "
        "warm-up)")
    rows = []
    # flash at the first prompt's prefill shape
    args, kw = serve["call"]
    q, k, v = args
    B, S, H, hd = q.shape
    KV = k.shape[2]
    got = fa.flash_attention(*args, **kw)
    plain_ms, want = _time_ms(lambda: fa.flash_attention_plain(*args, **kw),
                              warm=False)
    abs_err, rel_err, ok = _errors(got, want, FLASH_TOL["bfloat16"][1],
                                   FLASH_TOL["bfloat16"][0])
    log(f"  flash_attention kernel vs plain at B={B} S={S} H={H} KV={KV} "
        f"hd={hd} bf16 {kw}: max_abs={abs_err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flash_attention disagrees with its plain version on the "
             "serving path's inputs")
    ms, _ = _time_ms(lambda: fa.flash_attention(*args, **kw), reps=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms, _ = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=H != KV), reps=10)
    flops = 4 * B * H * hd * S * (S + 1) // 2
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    rows.append(_row(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:34", serve["launches"],
        serve["launches"] / serve["prefills"], "per prefill",
        (abs_err, rel_err), cut_errs["flash_attention"], ms, plain_ms,
        lib_ms, nbytes, flops, BF16_FLOPS_PER_S, "989 TFLOP/s bf16",
        f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal"))
    # the selective scan at the scoring forward's shape
    args, kw = mamba["call"]
    Bb, S, di = args[0].shape
    N = args[2].shape[-1]
    got = ss.ssm_scan(*args, **kw)
    plain_ms, want = _time_ms(lambda: ss.ssm_scan_plain(*args, **kw),
                              warm=False)
    scale = max(1.0, float(want.abs().max()))
    abs_err, rel_err, ok = _errors(got, want, SCAN_ATOL * scale, SCAN_RTOL)
    log(f"  ssm_scan kernel vs plain at B={Bb} S={S} di={di} N={N}: "
        f"max_abs={abs_err:.3e} (tolerance {SCAN_ATOL} max(1, max|p|) = "
        f"{SCAN_ATOL * scale:.3e} + {SCAN_RTOL} |p|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("ssm_scan disagrees with its plain version on the scoring "
             "path's inputs")
    ms, _ = _time_ms(lambda: ss.ssm_scan(*args, **kw), reps=10)
    # per (b, t, c, n): exp, dt*A, decay*h, the add, *B, h*C, the sum;
    # per (b, t, c): dt*x, D*x and its add
    flops = 7 * Bb * S * di * N + 3 * Bb * S * di
    nbytes = 4 * ((3 * di + 2 * N) * S * Bb + di * N + di)
    exps = Bb * S * di * N
    mhz = _max_sm_mhz()
    exp_ms = exps / (SMS * MUFU_PER_CLOCK * mhz * 1e6) * 1e3
    log(f"  ssm_scan exp floor: {exps} exps, one MUFU.EX2 each at "
        f"{MUFU_PER_CLOCK} a clock on each of {SMS} SMs at the card's "
        f"{mhz} MHz maximum SM clock: {exp_ms:.4f} ms (the bytes bound: "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    sweep_bad = []

    def held(G, y):
        a, _, ok = _errors(y, want, SCAN_ATOL * scale, SCAN_RTOL)
        if not ok:
            sweep_bad.append((G, a))
    sweep, _ = _in_turns(ss.GROUPS, lambda G: ss.ssm_scan(
        *args, **kw, group=G), reps=10, each=held)
    log(f"  ssm_scan G sweep (states a thread, chunks of {ss.CHUNK} steps, "
        f"in turns after half a second of launches, the mean of 10 launches "
        f"a turn, each held to the plain version): " + ", ".join(
            f"G={G}: {t:.4f} ms" for G, t in sweep.items())
        + f"; default G={ss.DEFAULT_GROUP}")
    if sweep_bad:
        fail(f"ssm_scan instances disagree with the plain version on the "
             f"scoring path's inputs: {sweep_bad}")
    rows.append(_row(
        "ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "src/repro/kernels/ssm_scan.py:32", mamba["launches"],
        float(mamba["launches"]), "per forward", (abs_err, rel_err),
        cut_errs["ssm_scan"], ms, plain_ms, None, nbytes, flops,
        F32_FLOPS_PER_S, "67 TFLOP/s f32", f"B={Bb} S={S} di={di} N={N} f32",
        group_ms={str(G): t for G, t in sweep.items()}))
    return rows


def _max_sm_mhz():
    """The card's maximum SM clock in MHz, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm failed: {out.stderr.strip()}")
    return int(out.stdout.split()[0])


# ----------------------------------------------------------------------------
# the third slice: the prefetching walk (phase 11), the feature-sharded
# z-exchange path (phase 12), and both kernels' times (phase 13)
# ----------------------------------------------------------------------------

def phase_depth_one(sparse):
    """Phase 4's main path with buffer_depth 1 from a one-entry autotune
    cache: the sparse kernel must walk without prefetching and give phase
    4's state."""
    import os
    import tempfile
    import torch
    from repro_torch.core import solve
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import sparse_sdca as sk
    sh, yp, mk, r4, cfg, _, nnz, _, _ = sparse
    K, nk, r_max = sh.cols.shape
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "autotune_cache.json"
        autotune.AutotuneCache(path).record(
            "sparse_sdca", sh.device.type, d=sh.d, r_max=r_max,
            density=sh.density,
            config={"block_rows": 128, "buffer_depth": CACHE_DEPTH},
            wall_s=0.0)
        os.environ[autotune.ENV_VAR] = str(path)
        autotune.reset_cache()
        try:
            counts = _counts_zero()
            r = solve(cfg, sh, yp, mk, rounds=len(r4.history["round"]),
                      gap_every=1, seed=SEED)
            launches = counts()
            used = dict(ops.LAST_SPARSE_CONFIG)
        finally:
            del os.environ[autotune.ENV_VAR]
            autotune.reset_cache()
    log(f"[11 depth-1] rcv1 shape, K={K}, buffer_depth from the cache "
        f"file {path.name} ({autotune.ENV_VAR}): LAST_SPARSE_CONFIG {used}")
    log(f"  launches on the main path: {launches}")
    rounds = len(r4.history["round"])
    _check_gaps("rcv1 sdca_sparse_kernel, depth 1", r.history, rounds)
    if used["buffer_depth"] != CACHE_DEPTH or used["source"] != "cache":
        fail(f"phase 11 did not resolve depth {CACHE_DEPTH} from the "
             f"cache: {used}")
    if launches["sparse_sdca"] != rounds or \
            launches["sparse_sdca_pipelined"] != 0:
        fail(f"phase 11 launched {launches} in {rounds} rounds")
    # the states must be the same bits; the gaps then agree in every
    # printed digit, and their float64 values within the certificate's own
    # run-to-run noise (v's index_add_ lands its float32 atomics in no
    # fixed order)
    states = (torch.equal(r.state.w, r4.state.w)
              and torch.equal(r.state.alpha, r4.state.alpha))
    printed = [f"{g:.4e}" for g in r.history["gap"]]
    same = printed == [f"{g:.4e}" for g in r4.history["gap"]]
    noise = max(abs(a / b - 1) for a, b in zip(r.history["gap"],
                                               r4.history["gap"]))
    log(f"  state (w, alpha) after {rounds} rounds equal to phase 4's bit "
        f"for bit: {states}; gaps {' '.join(printed)} "
        f"{'equal digit for digit' if same else 'DIFFER'} to phase 4's "
        f"(float64 values within {noise:.1e} relative)")
    if not (states and same):
        fail("phase 11's run differs from phase 4's")
    w, scale, perm = _round_inputs(cfg, sh, yp, mk, r.state)
    args = (sh.cols, sh.vals, yp, r.state.alpha, mk, w, scale, perm)
    hinge = {"loss": get_loss("hinge")}
    ms, outs = _in_turns(DEPTHS, lambda depth: sk.sparse_local_sdca(
        *args, buffer_depth=depth, **hinge), reps=2)
    cfg_passes = ops.n_passes_of(cfg.H, nk)
    equal = all(torch.equal(a, b) for depth in DEPTHS[1:]
                for a, b in zip(outs[depth], outs[1]))
    order = DEPTHS + DEPTHS[::-1]
    log(f"  ms per launch on the next round's inputs (CUDA events, depths "
        f"in turns {', '.join(map(str, order))}): " + ", ".join(
            f"depth {k}: {v:.3f}" for k, v in ms.items())
        + f"; us a step: " + ", ".join(
            f"depth {k}: {1e3 * v / (nk * cfg_passes):.4f}"
            for k, v in ms.items())
        + f"; depths {DEPTHS[1:]} equal depth 1 bit for bit: {equal}")
    if not equal:
        fail("the sparse kernel at depth >= 2 differs from depth 1 on "
             "rcv1's rows")
    return {"r": r, "launches": launches["sparse_sdca"], "args": args,
            "ms": ms, "nnz": nnz}


def phase_mesh2d(dev, csr_y):
    """The feature-sharded path through `solve` on a (4, 2) mesh."""
    import torch
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.data import load, partition_sparse
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    K, M = 4, 2
    kw = dict(backend="shard_map", model_axis="model",
              solver="sdca_sparse_kernel", loss="hinge")
    csr, y = load("tiny_sparse")
    gaps = {}
    for where in ("cpu", dev):
        fs, yp, mk = partition_sparse(csr, y, K, M=M, device=where)
        cfg = CoCoAConfig.adding(K, lam=1e-3, H=128, **kw)
        gaps[str(where)] = solve(cfg, fs, yp, mk, rounds=5, seed=SEED,
                                 mesh=make_test_mesh((K, M), device=where)
                                 ).history["gap"]
    worst = max(abs(a / b - 1) for a, b in zip(gaps["cpu"], gaps[str(dev)]))
    log(f"[12 mesh2d] tiny_sparse K={K} M={M} zx gaps, card vs cpu plain: "
        f"max rel diff {worst:.3e} (limit 1e-4)")
    if worst > 1e-4:
        fail(f"tiny_sparse 2-D gaps differ between card and cpu: {gaps}")
    t0 = time.perf_counter()
    csr, y = csr_y
    fs, yp, mk = partition_sparse(csr, y, K, M=M, device=dev)
    nk = yp.shape[1]
    log(f"  rcv1 shape as FeatureShards: K={K} M={M} nk={nk} d_local="
        f"{fs.d_local} r_loc={fs.r_loc} nnz={int(fs.nnz.sum())} (sliced in "
        f"{time.perf_counter() - t0:.1f} s)")
    cfg = CoCoAConfig.adding(K, lam=SPARSE_LAM, H=nk, **kw)
    rounds = 5
    counts = _counts_zero()
    r = solve(cfg, fs, yp, mk, rounds=rounds, gap_every=1, seed=SEED,
              mesh=make_test_mesh((K, M), device=dev))
    launches = counts()
    used = dict(ops.LAST_SPARSE_CONFIG)
    plan = ops.sparse_zx_plan(nk, fs.d_local, nk, r_max=fs.r_loc,
                              model_shards=M, backend=dev.type)
    per_round = plan["n_passes"] * plan["blocks"]
    log(f"  LAST_SPARSE_CONFIG {used}; launches on the path: {launches}")
    _check_gaps("rcv1 4x2 sdca_sparse_kernel zx", r.history, rounds)
    if not (used["zx"] is True and used["model_shards"] == M):
        fail(f"phase 12 did not run the z-exchange schedule: {used}")
    if launches["sparse_sdca_zx"] != rounds or \
            launches["sparse_sdca_zx_steps"] != rounds * per_round or any(
                launches[k] for k in ("local_sdca", "sparse_sdca",
                                      "sparse_sdca_pipelined")):
        fail(f"phase 12 launched {launches}, expected {rounds} zx launches "
             f"of {per_round} steps each")
    ex = r.history["execute_s"]
    log(f"  1 launch a round of {per_round} steps (n_passes "
        f"{plan['n_passes']} x {plan['blocks']} blocks of "
        f"{plan['block_rows']}); execute_s per round "
        + ", ".join(f"{e:.4f}" for e in ex) + "; us per step "
        + ", ".join(f"{1e6 * e / per_round:.3f}" for e in ex)
        + f"; gaps " + " ".join(f"{g:.5f}" for g in r.history["gap"])
        + f"; comm_floats per round {r.history['comm_floats'][0]}")
    del csr
    return {"fs": fs, "yp": yp, "mk": mk, "r": r, "cfg": cfg,
            "launches": launches["sparse_sdca_zx"], "per_round": per_round,
            "B": plan["block_rows"], "n_passes": plan["n_passes"]}


def phase_new_times(pipe, sparse_plain, mesh, cut_errs):
    """The depth-1 walk and the zx kernel against their plain versions on
    their paths' next-round inputs, and their times beside their bounds."""
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.data.sparse import row_sqnorms
    from repro_torch.kernels import sparse_sdca as sk
    hinge = {"loss": get_loss("hinge")}
    log("[13 new-times] the depth-1 walk and the zx kernel vs plain on "
        "their paths' next-round inputs; CUDA events")
    rows = []
    args = pipe["args"]
    K, nk, r_max = args[0].shape
    d = args[5].shape[0]
    errs = _against_plain("sparse_sdca", _at_depth(1),
                          sk.sparse_local_sdca_plain, args, hinge,
                          known=sparse_plain)[:3]
    nnz = pipe["nnz"]
    rounds = len(pipe["r"].history["round"])
    rows.append(_row(
        "sparse_sdca",
        "src/repro_torch/kernels/csrc/sparse_sdca_pipelined.cu",
        "src/repro/kernels/sparse_sdca.py:172", pipe["launches"],
        pipe["launches"] / rounds, "per round", errs[:2],
        cut_errs["sparse_sdca"], pipe["ms"][1], errs[2], None,
        _sparse_bytes(nnz, K, nk, d), 6 * nnz, F32_FLOPS_PER_S,
        "67 TFLOP/s f32", f"K={K} nk={nk} r_max={r_max} d={d} nnz={nnz} "
        f"depth=1", rounds=rounds, depth_ms=pipe["ms"],
        us_per_step=1e3 * pipe["ms"][1] / nk))
    # zx at rcv1's 4 x 2 shape
    fs, yp, mk, r, cfg = (mesh[k] for k in ("fs", "yp", "mk", "r", "cfg"))
    w, scale, perm = _round_inputs(cfg, fs, yp, mk, r.state)
    sq = (row_sqnorms(fs) * mk).contiguous()
    B, n_passes = mesh["B"], mesh["n_passes"]
    zargs = (fs.cols, fs.vals, yp, r.state.alpha, mk, w, scale, sq, perm)
    zkw = dict(hinge, n_passes=n_passes, block_rows=B)
    errs = _against_plain("sparse_sdca_zx", sk.sparse_local_sdca_zx,
                          sk.sparse_local_sdca_zx_plain, zargs, zkw)[:3]
    ms, _ = _time_ms(lambda: sk.sparse_local_sdca_zx(*zargs, **zkw), reps=3)
    K, M, nk, r_loc = fs.cols.shape
    inv = mesh["per_round"]
    zx_nnz = int(fs.nnz.sum())
    # each pass reads every nonzero once (col id and value: a block's rows
    # are read again as the next step's walk); per step the z vectors (M
    # read, one written -- counted though the one-launch kernel keeps them
    # in shared memory: the bound is the work's, not an implementation's);
    # once a round the rows' y, alpha, mask, sqnorms, perm and dalpha, w
    # and du. Per nonzero and pass, the scatter's and the next partial
    # dot's multiply-adds
    nbytes = (n_passes * 8 * zx_nnz + inv * K * M * B * (M + 1) * 4
              + 4 * (6 * K * nk + M * fs.d_local + K * M * fs.d_local))
    flops = n_passes * 4 * zx_nnz
    rounds = len(r.history["round"])
    rows.append(_row(
        "sparse_sdca_zx", "src/repro_torch/kernels/csrc/sparse_sdca_zx.cu",
        "src/repro/kernels/sparse_sdca.py:394", mesh["launches"],
        mesh["launches"] / rounds, "per round", errs[:2],
        cut_errs["sparse_sdca_zx"], ms, errs[2], None, nbytes, flops,
        F32_FLOPS_PER_S, "67 TFLOP/s f32",
        f"K={K} M={M} nk={nk} r_loc={r_loc} d_local={fs.d_local} B={B} "
        f"(one call: 1 launch of {inv} steps)", rounds=rounds,
        steps_per_round=inv, us_per_step=1e3 * ms / inv))
    log(f"  sparse_sdca_zx: {ms:.3f} ms a round, 1 launch, {inv} steps, "
        f"{1e3 * ms / inv:.3f} us a step")
    return rows



# ----------------------------------------------------------------------------
# the wire stack (phase 14): compression, error feedback, hier / a2a
# reduces, compressed gather and the tracer, on the main path's tensors
# ----------------------------------------------------------------------------

WIRE_K = 64                    # phase 14's top-k budget


def _wire_solve(name, cfg, X, y, mask, rounds, expect, mesh=None,
                falling=True, **kw):
    """`solve` with the launch counts at 0 just before and read just
    after; `expect` names the kernel that must launch once a round."""
    from repro_torch.core import solve
    counts = _counts_zero()
    r = solve(cfg, X, y, mask, rounds=rounds, gap_every=1, seed=SEED,
              mesh=mesh, **kw)
    launches = counts()
    log(f"  {name}: launches {launches}")
    if falling:
        _check_gaps(name, r.history, rounds)
    else:
        gaps = r.history["gap"]
        log(f"  {name}: gaps " + " ".join(f"{g:.4e}" for g in gaps)
            + f"; execute_s " + ", ".join(
                f"{e:.3f}" for e in r.history["execute_s"]))
        if len(gaps) != rounds or not all(
                math.isfinite(g) and g >= -1e-6 for g in gaps):
            fail(f"{name}: gaps not finite and >= -1e-6: {gaps}")
    if expect is not None and launches[expect] != rounds:
        fail(f"{name}: {expect} launched {launches[expect]} times in "
             f"{rounds} rounds")
    return r


def _measured_inter(name, hist, tracer):
    """comm_floats against the tracer's plan: every hop as planned except
    inter_gather, whose per-round volume is measured after the pods'
    dedup and must be positive and at most its analytic bound."""
    plan = {h.name: h.floats for h in tracer.hops}
    fixed = sum(f for n, f in plan.items() if n != "inter_gather")
    cf = hist["comm_floats"]
    inters = [b - a - fixed for a, b in zip([0] + cf[:-1], cf)]
    log(f"  {name} comm_floats {cf}: plan per round {plan}; inter_gather "
        f"measured per round {inters} (bound {plan['inter_gather']})")
    if not all(0 < v <= plan["inter_gather"] for v in inters):
        fail(f"{name}: measured inter_gather {inters} outside (0, "
             f"{plan['inter_gather']}]")
    return inters


def phase_wire(dev, sparse, dense, mesh):
    """Phase 14: the wire stack on the main path's tensors: rcv1 (K = 8)
    under a2a, hier:4 and top-k gathered over hier:4; epsilon (K = 8) under
    int8 and QSGD, sigma_k and the Table-1 ratio at full width, and the gd
    and deadline solvers; the 4 x 2 mesh with top-k split over M = 2 and
    gathered over hier:2."""
    import dataclasses
    import torch
    from repro_torch import comm
    from repro_torch.core import cocoa, duality, sigma
    from repro_torch.core.losses import get_loss
    from repro_torch.device import synchronize
    from repro_torch.launch.mesh import make_test_mesh
    out = {}
    # --- rcv1, K = 8: a2a and hier:4 against phase 4, then top-k gather
    sh, yp, mk, r4, cfg4, _, _, _, depth = sparse
    K, nk, r_max = sh.cols.shape
    rounds = len(r4.history["round"])
    log(f"[14 wire] rcv1 shape, K={K}, {rounds} rounds of "
        f"{cfg4.solver} under each wire setting")
    ra = _wire_solve("rcv1 a2a", dataclasses.replace(cfg4, topology="a2a"),
                     sh, yp, mk, rounds, "sparse_sdca_pipelined")
    printed = [f"{g:.4e}" for g in ra.history["gap"]]
    if printed != [f"{g:.4e}" for g in r4.history["gap"]]:
        fail(f"a2a gaps {printed} differ from phase 4's in their printed "
             f"digits")
    rh = _wire_solve("rcv1 hier:4",
                     dataclasses.replace(cfg4, topology="hier:4"), sh, yp,
                     mk, rounds, "sparse_sdca_pipelined")
    hier_rel = max(abs(a / b - 1) for a, b in zip(rh.history["gap"],
                                                  r4.history["gap"]))
    log(f"  a2a gaps equal phase 4's to their printed digits; hier:4 gaps "
        f"within {hier_rel:.2e} relative of phase 4's (limit 1e-6)")
    if hier_rel > 1e-6:
        fail(f"hier:4 gaps {hier_rel:.2e} from phase 4's")
    cfg = dataclasses.replace(cfg4, topology="hier:4", compress="topk",
                              compress_k=WIRE_K, gather=True)
    rt = _wire_solve(f"rcv1 topk {WIRE_K} gather hier:4", cfg, sh, yp, mk,
                     rounds, "sparse_sdca_pipelined", falling=False)
    loss, reg = get_loss(cfg.loss), cfg.regularizer()
    st = rt.state
    _, _, g_v = duality.gap_at_v(st.w, st.alpha, sh, yp, mk, loss, cfg.lam,
                                 reg)
    _, _, g_a = duality.gap_decomposed(st.alpha, sh, yp, mk, loss, cfg.lam,
                                       reg)
    last = rt.history["gap"][-1]
    log(f"  certificate: history {last:.6e}; gap_at_v at the carried v "
        f"{float(g_v):.6e}; gap_decomposed at v(alpha) {float(g_a):.6e} "
        f"(the point compression does not hold)")
    if abs(float(g_v) / last - 1) > 1e-6:
        fail(f"the top-k run's gap {last} is not gap_at_v's {float(g_v)}")
    topo = comm.Topology.simulated(K, "hier:4")
    comp = cfg.compressor()
    tracer = comm.CommTracer.for_run(K=K, d_local=sh.d, compressor=comp,
                                     topo=topo, gather=True)
    out["rcv1_inter"] = _measured_inter("rcv1 topk gather", rt.history,
                                        tracer)
    # the gather form against the dense top-k form on the next round's du
    solver = cocoa.resolve_solver(cfg.solver, True)
    order = cocoa.draw_visit_orders(solver, K, nk, cfg.H, SEED, st.rounds)
    p = cfg.agg_params(K)
    n = float(duality.effective_n(mk))
    du = solver.fn(sh, yp, st.alpha, mk, st.w, order, loss, cfg.lam, n,
                   p.sigma_prime, cfg.H, reg=reg).du
    g_sum, g_ef = comm.exchange(topo, du, st.ef, p, comp, gather=True,
                                stats={})
    d_sum, d_ef = comm.exchange(topo, du, st.ef, p, comp)
    err = float((g_sum - d_sum).abs().max() / d_sum.abs().max())
    same_ef = torch.equal(g_ef, d_ef)
    log(f"  gathered sum vs dense top-k sum on the next round's du: max "
        f"|diff| / max |dense| {err:.2e} (limit 1e-6); EF residuals equal "
        f"bit for bit: {same_ef}")
    if err > 1e-6 or not same_ef:
        fail("the gather form differs from the dense top-k form")
    flat = comm.Topology.simulated(K)
    plain_comp = comm.NoCompression()
    ms = {}
    for key, fn in (
            ("gather", lambda: comm.exchange(topo, du, st.ef, p, comp,
                                             gather=True, stats={})),
            ("dense_topk", lambda: comm.exchange(topo, du, st.ef, p, comp)),
            ("flat_none", lambda: comm.exchange(flat, du, st.ef, p,
                                                plain_comp))):
        ms[key], _ = _time_ms(fn, reps=20)
    w, scale, perm = _round_inputs(cfg, sh, yp, mk, st)
    args = (sh.cols, sh.vals, yp, st.alpha, mk, w, scale, perm)
    ms["kernel"], _ = _time_ms(lambda: _at_depth(depth)(
        *args, loss=loss), reps=2)
    steady = rt.history["execute_s"][1:]
    ex_s = sum(steady) / len(steady)
    log(f"  ms a round (CUDA events): exchange topk {WIRE_K} gathered over "
        f"hier:4 {ms['gather']:.3f}, dense top-k {ms['dense_topk']:.3f}, "
        f"flat uncompressed {ms['flat_none']:.3f}; the sparse kernel "
        f"{ms['kernel']:.3f}; execute_s a round after round 1 "
        f"{1e3 * ex_s:.3f} ms, the gathered exchange "
        f"{ms['gather'] / (1e3 * ex_s):.3f} of it")
    out["rcv1_ms"] = ms
    # --- epsilon, K = 8: int8 and QSGD, sigma, gd and deadline
    Xp, yp, mk, r5, cfg5, _ = dense
    K, nk, d = Xp.shape
    log(f"[14 wire] epsilon shape, K={K}: int8 and qsgd, 3 rounds each")
    for scheme in ("int8", "qsgd"):
        _wire_solve(f"epsilon {scheme}",
                    dataclasses.replace(cfg5, compress=scheme), Xp, yp, mk,
                    3, "local_sdca")
    synchronize(dev)
    t0 = time.perf_counter()
    sk_ = sigma.sigma_k(Xp, mk)
    ratio = float(sigma.table1_ratio(Xp, mk))
    synchronize(dev)
    log(f"  sigma_k at ({K}, {nk}, {d}): {[round(float(v), 3) for v in sk_]}"
        f"; Table-1 ratio (n^2/K)/sigma {ratio:.4f} (both in "
        f"{time.perf_counter() - t0:.2f} s, 50 power iterations each)")
    if not (math.isfinite(ratio) and ratio >= 1.0):
        fail(f"Table-1 ratio {ratio} is not finite and >= 1")
    out["ratio"] = ratio
    H = 2048
    cut = 3
    budgets = torch.full((K,), H, dtype=torch.long)
    budgets[cut] = H // 10
    log(f"[14 wire] epsilon, K={K}: gd and sdca_deadline, 2 rounds at "
        f"H={H}, worker {cut}'s budget {H // 10}")
    for name in ("gd", "sdca_deadline"):
        rs = _wire_solve(f"epsilon {name}",
                         dataclasses.replace(cfg5, solver=name, H=H), Xp,
                         yp, mk, 2, None, falling=False,
                         budget_fn=lambda t: budgets)
    ls = cocoa.resolve_solver("sdca_deadline", False)
    order = cocoa.draw_visit_orders(ls, K, nk, H, SEED, rs.state.rounds)
    n = float(duality.effective_n(mk))
    sp = cfg5.agg_params(K).sigma_prime
    sq = torch.sum(Xp * Xp, dim=-1) * mk
    run = lambda b: ls.fn(Xp, yp, rs.state.alpha, mk, rs.state.w, order,
                          get_loss(cfg5.loss), cfg5.lam, n, sp, H,
                          budget=b, sqnorms=sq)
    per_worker, static = run(budgets), run(H // 10)
    steps = per_worker.steps.tolist()
    honored = (steps == budgets.tolist()
               and torch.equal(per_worker.dalpha[cut], static.dalpha[cut])
               and int(torch.count_nonzero(per_worker.dalpha[cut]))
               <= H // 10)
    log(f"  deadline steps per worker {steps}; worker {cut}'s dalpha "
        f"equals a static {H // 10}-step run bit for bit, "
        f"{int(torch.count_nonzero(per_worker.dalpha[cut]))} rows moved: "
        f"{honored}")
    if not honored:
        fail("the deadline worker's step budget was not honored")
    # --- the 4 x 2 mesh: top-k split over M = 2, gathered over hier:2
    fs, yp, mk, cfg12 = (mesh[k] for k in ("fs", "yp", "mk", "cfg"))
    K, M = fs.cols.shape[:2]
    cfg = dataclasses.replace(cfg12, topology="hier:2", compress="topk",
                              compress_k=WIRE_K, gather=True)
    comp = cfg.compressor(M)
    log(f"[14 wire] rcv1 {K} x {M} mesh, top-k {WIRE_K} split "
        f"{[int(comp.live_budget(m)) for m in range(M)]} over the model "
        f"shards ({comp.slots} slots each), gathered over hier:2, 3 rounds")
    mesh_dev = make_test_mesh((K, M), device=dev)
    rm = _wire_solve("rcv1 4x2 topk gather hier:2", cfg, fs, yp, mk, 3,
                     "sparse_sdca_zx", mesh=mesh_dev, falling=False)
    topo = comm.Topology.from_mesh(mesh_dev, "data", "model", "hier:2")
    solver = cocoa.resolve_solver(cfg.solver, True, feature_sharded=True)
    tracer = comm.CommTracer.for_run(
        K=K, d_local=fs.d_local, compressor=comp, topo=topo, gather=True,
        extra_hops=solver.model_hop(fs, cfg.H, cfg.regularizer()))
    out["mesh_inter"] = _measured_inter("rcv1 4x2 topk gather", rm.history,
                                        tracer)
    return out


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
    t_start = time.perf_counter()
    phase_build()
    cut_errs = phase_kernels(dev)
    sparse = phase_sparse(dev)
    dense = phase_dense(dev)
    rows, sparse_plain = phase_times(dense, sparse, cut_errs)
    gc.collect()
    torch.cuda.empty_cache()
    lm_cut_errs = phase_lm_kernels(dev)
    serve = phase_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    mamba = phase_mamba(dev)
    gc.collect()
    torch.cuda.empty_cache()
    rows += phase_lm_times(serve, mamba, lm_cut_errs)
    del serve, mamba
    gc.collect()
    torch.cuda.empty_cache()
    pipe = phase_depth_one(sparse)
    mesh = phase_mesh2d(dev, sparse[7])
    rows += phase_new_times(pipe, sparse_plain, mesh, cut_errs)
    phase_wire(dev, sparse, dense, mesh)
    rows.sort(key=lambda row: TABLE_ORDER.index(row["name"]))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
