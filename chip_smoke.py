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
 15. mesh-dense  epsilon's tensors (K = 4, phase 5's rows) on
               `make_test_mesh((4, 2))` through `solve` with the eager
               `sdca`, H = 2,048, 3 rounds: the dense feature-sharded
               round, held each round within 1e-5 relative to the one-card
               K = 4 vmap run on the same visit orders, no kernel launched
 16. dist      the multi-process backend: 4 ranks spawned (spawn start
               method) on cuda:0, joined over gloo, each given only its
               worker's block (written by this process), the kernels
               already built by phase 2: rcv1 K = 4 (the ring kernel at
               its default depth, lambda = 1e-6), epsilon K = 4 (the dense
               kernel), and a 2 x 2 dense mesh at d = 2,000 cut to 4,096
               rows a worker and H = 512 (the eager sdca, one scalar
               all_reduce a step over the model column), 3 rounds each.
               Each rank's per-round gaps equal every other rank's and
               match the one-process run on the card (1e-6 relative; 5e-6
               for epsilon, whose first run read 1.19e-6); each rank
               launches its kernel once a round (none on the 2 x 2 mesh,
               which sums over the model column at least rounds x H
               times); s a round, each rank's kernel ms and exchange ms.
               A rank that fails, or the spawn not done in 240 s, fails
               the run: the rest are killed first
 17. accel     `tests/test_accel.py`'s pinned problem on the card (eager
               sdca, K = 8, squared, lambda = 5e-4, H = 128) to gap 1e-4
               under none, nesterov:16 and catalyst:20, both accelerated
               runs at least 1.3x fewer rounds; epsilon K = 8 through the
               dense kernel under nesterov:16, 3 rounds, its first round's
               state equal to the plain first round's bit for bit
 18. obs       phase 4's rcv1 path (K = 8, ring depth 4, 5 rounds) under
               the full `obs` bus: the aggregator, a JSONL file, round
               profiles on `default_hardware()` (h100_sxm), the dashboard
               into a buffer and the torch.profiler sink. Its 5 records
               valid with phase 4's gaps to their printed digits, the
               files through `repro_torch.obs.validate`, the profiles'
               bound phase 6's within 1% and their bw_frac and
               model_vs_measured at most 1.05, the trace with 5 ranges of
               each of cocoa/local_solve, cocoa/exchange and
               cocoa/certificate and the 5 ring launches inside
               cocoa/local_solve ranges, the sink not disabled (a trace
               that lost a device record of the rounds or certificates,
               or holds one that starts before its launch, is taken
               again, at most 5 times); printed:
               execute_s without the bus, with it, and with the profiler,
               each round's device-busy ms over its host ms (the idle
               share) and the certificate's busy share. Then the CLI on
               the card: rcv1_sparse with --metrics-out --profile
               --dashboard, its files through `python -m
               repro_torch.obs.validate`, and epsilon_like through
               sdca_deadline with --simulate-straggler 1 (every record K
               budgets and K rates, worker 1's the lowest)
 19. runtime   the tenth slice on the main path's tensors: phase 4's rcv1
               path (K = 8, ring depth 4) 2 rounds, saved through an async
               `CheckpointManager`, every tensor of the run dropped, the
               checkpoint restored onto the card and 3 more rounds: the
               state equal to phase 4's 5-round run bit for bit and the
               gaps to their printed digits (the save's host ms, the
               restore's ms and the file's MB printed); epsilon (K = 8,
               the dense kernel) 2 rounds, `fail_and_recover(k=0)`:
               alpha[0] zero, the certificate's gap >= -1e-6 |P|, w the
               survivors' A alpha / (lambda n) within 1e-5, then 2 rounds
               whose last gap is below the one at the drop; rcv1 re-split
               K = 8 -> 4 on the card (the ring kernel on 4 blocks, nk =
               169,350) and phase 12's 4 x 2 mesh -> 2 x 2 (the zx kernel
               at K = 2), 2 rounds before and after each: P and D across
               the re-split within 1e-6 relative, the gap falling after
               it, the re-split's ms printed; the paper's Figure 2 at
               epsilon's shape: phase 5's CoCoA+ (3 rounds) beside
               mini-batch CD and SGD (3 rounds / steps, b_local 2,048,
               the same 24 communicated vectors) and one-shot averaging
               (H = 2,048), every number finite and CD's gap falling;
               then the CLI on the card as subprocesses (rcv1_sparse,
               --solver sdca_kernel): --ckpt D --ckpt-every 2 --rounds 4,
               then --rounds 8 on D (`resumed from round 4`, its final
               gap equal to an uninterrupted --rounds 8 run's to the
               printed digits), --simulate-failure 2, --elastic-to 4@2
               and --mesh 4x2 --elastic-to 2@2, each with the reference's
               message
 20. train     the eleventh slice, the card's memory freed first:
               stablelm-1.6b at full width and depth (24 layers, d_model
               2,048, 32 x 64 heads, d_ff 5,632, vocab 100,352, bf16,
               random weights from the seed) trained by
               `launch.train.train_step` (AdamW, float32 masters) on one
               fixed TokenStream batch, B = 4, S = 2,048, the plain
               attention (no kernel has a backward) and remat "nothing":
               1 cold and 5 warm steps at lr 3e-4, each step's loss,
               grad_norm, seconds, tokens/s, peak memory, the AdamW
               update's ms (CUDA events) beside its bytes bound, and
               6 N tokens / s over 989 TFLOP/s. Checks: finite losses,
               the loss after the 6th step below the 1st's; every
               parameter a gradient, none all zeros; the last step's
               update of final_norm's gain and block 0's wq recomputed in
               float64 within 1e-6 of the masters; at 2 layers (full
               width otherwise) the loss with remat ("nothing", "dots")
               equal to the loss without bit for bit and the grads within
               relative L2 1e-3; a step under use_flash_attention raising
               the kernel's NotImplementedError. Then CoCoA-DP
               (`optim.localdp`) on the same model at full width: K = 4
               workers in turn, H = 2 SGD steps at 1e-2, B = 1, S = 1,024
               a worker (its own TokenStream batch), one round each of
               adding (gamma 1, sigma' 4, prox0 0.5), averaging, and
               adding under int8 compression: the round's seconds,
               |sum_k delta_k|, the mean worker loss before and after,
               peak memory; everything finite
 21. windows   the twelfth slice, the card's memory freed first:
               sliding-window attention, ring-buffer caches and the
               RG-LRU (random bf16 weights from the seed,
               use_flash_attention on). (a) gemma3-27b at full width and
               depth (62 layers, 52 of them windowed at 1,024, d_model
               5,376, 32 x 128 heads, kv 16, vocab 262,144, 27.0 B
               weights): `ServingEngine(slots=4, s_max=4096)`, 6 requests
               of 512-3,000 prompt tokens (multiples of 128; one below
               the window, two above) and 32 new tokens, timed after the
               same prompts warmed a throwaway engine; every request 32
               in-range tokens, flash launched 10 times a prefill (the
               global layers only), the longest prefill's logits with the
               kernel within LOGITS_REL_RMS of the plain path's; then the
               ring check: a 1,500-token prompt into one slot of 4,096,
               16 teacher-forced decode steps, the last one's logits
               against a cache-free forward over the 1,516 tokens (bf16,
               LOGITS_REL_RMS), and at 8 layers in float32 the logits and
               each windowed layer's output at that position within 1e-3
               relative RMS, the same check with the ring write planted
               one slot off failing. (b) recurrentgemma-9b at full width
               and depth (38 layers: 26 RG-LRU, 12 windowed MQA at 2,048,
               9.40 B weights): the same engine on prompts of 1,024-3,000
               (two above the window), flash launched 0 times; the
               scoring forward at B 1 x S 4,096, cold and warm; the ring
               checks with a 2,500-token prompt, float32 at 4 layers.
               (c) gemma2-27b at full width and 4 layers (softcaps 50 and
               30, sandwich norms): a 4,500-token prompt past the 4,096
               window, flash (2 launches) against the plain prefill, the
               ring checks at 4 layers. Printed: prefill ms per request
               and decode ms per engine step (host clock after a
               synchronize), decode tokens/s, the idle share of one
               decode step and one prefill, peak GB
 22. moe       the thirteenth slice, the card's memory freed first: the
               MoE (llama4) and M-RoPE with embedding inputs (qwen2-vl),
               random bf16 weights from the seed, use_flash_attention on.
               (a) llama4-scout at full width and 12 of 48 layers
               (d_model 5,120, 40 x 128 heads, kv 8, 16 experts top-1
               and the shared expert, d_ff 8,192, vocab 202,048, 28.5 B
               weights): `ServingEngine(slots=4, s_max=4096)`, 6 requests
               of 512-2,944 prompt tokens (multiples of 128) and 32 new
               tokens, timed after a warm-up engine; every request 32
               in-range tokens, flash launched 12 times a prefill and no
               other kernel; the longest prefill with the kernel and
               through the plain path, each on its own routes: the share
               of tokens whose expert differs, per layer, from the routes
               `layers.moe_route` gave, and the logits' relative RMS,
               printed (a bf16 rounding that flips a near tie changes a
               token wholesale, and the flips compound up the layers),
               and the same for the plain path against itself with its
               attention in float32, the witness that rounding alone
               flips routes; then the plain path on the kernel prefill's
               routes, its logits within LOGITS_REL_RMS of the kernel's;
               the engine again with each decode step's dropped tokens
               counted (all 4 slots, dead ones included, are one dispatch
               group: C = 1);
               the scoring forward at B 1 x S 4,096, cold and warm, loss
               = xent + 0.01 aux; then the dispatch check: one MoE layer
               at scout's width in float32 against float64 on the card at
               T = 1,024 (capacity 1.25 and 1.0) and T = 4, expert ids and
               keep masks equal, outputs within 1e-5 relative RMS, and
               capacity C + 1 planted where tokens drop failing it.
               (b) llama4-maverick at full width and 3 layers (dense
               16,384, MoE of 128 experts, dense; 19.0 B weights): the
               same engine, flash 3 times a prefill, the init's peak
               apart from the serving peak. (c) qwen2-vl-7b at full width
               and depth (28 layers, d_model 3,584, 28 x 128 heads, kv 4,
               d_ff 18,944, qkv bias, M-RoPE (16, 24, 24), 7.62 B
               weights) through `launch.serve`: a 2,048-embedding prefill
               whose positions are 256 text positions, a 42 x 42 patch
               grid (temporal constant, height and width along the grid)
               and text, 32 greedy tokens through `serve_step`, flash
               launched 0 times (3-D positions); the cache check: 16
               teacher-forced decode steps against a cache-free prefill
               over the 2,064 embeddings (the decoded tokens' table rows,
               their positions on all three streams), in bf16 within
               LOGITS_REL_RMS and at 4 layers in float32 within 1e-3; the
               scoring forward at S 4,096 from embeddings. Printed as in
               phase 21, with the init peaks and each part's seconds
 23. whisper   the fourteenth slice, the card's memory freed first: the
               encoder-decoder, whisper-large-v3 at full width and depth
               (32 + 32 layers, d_model 1,280, 20 x 64 heads, d_ff 5,120,
               vocab 51,866, 1.535 B random bf16 weights from the seed,
               use_flash_attention on, which whisper ignores as the
               reference does) through `launch.serve`: 4 streams of 1,500
               random frame embeddings (a 30-second window) prefilled
               (zero logits; encoder and cross K/V), 4 forced prompt
               tokens and greedy `serve_step`s to position 447, a step at
               448 refused with ValueError, no kernel launched; the cache
               check: the served decode's logits at 16 positions against
               `logits_encdec`, the cache-free teacher-forced forward over
               the 448 tokens fed, in bf16 within LOGITS_REL_RMS, and at
               4 + 4 layers in float32 within 1e-5, the same check with
               stream b's cross K/V served to stream b + 1 failing it; 3
               `train_step`s (AdamW, lr 1e-5) of the served model under
               remat at B 2 x 1,500 frames x 448 tokens on one batch, the
               last step's loss and a forward after it below the first
               step's. Printed: prefill and decode ms beside their bounds
               (`_whisper_bounds`), tokens/s, one prefill's and one
               decode step's device kernels and idle share, the warm
               training step's s and tokens/s, peak GB
 24. sharded   the sixteenth slice, the card's memory freed first: the
               sharded LM steps on a (data 2, model 2) process mesh of 4
               ranks spawned on cuda:0 over gloo (`launch.sharding`'s
               specs, DTensors, the model's hooks): stablelm-1.6b at
               full width and depth, one prefill of B 4 x S 1,024
               (`make_jitted_serve_fns`, flash on each rank's 16 heads
               and 2 rows), 8 decode steps teacher-forced with the
               one-process tokens, 2 train steps at B 4 x S 1,024
               (`make_jitted_train_step`, AdamW on the shards);
               falcon-mamba-7b at full width and 4 of 64 layers, a
               scoring forward (the fused scan on each rank's 4,096 of
               8,192 d_inner channels) and a prefill. Each result held
               to the one-process run of the same seed on the card (run
               and freed before the spawn): logits and falcon-mamba's
               layer-0 scan output rel RMS within LOGITS_REL_RMS,
               losses within 5e-4, grad norms within 2e-2, the update of every master over the steps
               (master minus init, each rank's slices) within 0.2 rel
               RMS in its worst leaf; every rank must launch flash and
               the scan. Printed beside the card's name
               and power limit: each rank's launches, every step's s
               sharded and in one process, the gloo bytes a step (what
               each rank hands to DTensor's collectives), peak GB

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
import functools
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
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


def _hw(bf16=False):
    """The card's peaks (`repro_torch.obs.prof`'s H100 SXM specs: float32
    outside the tensor cores, or bf16 on them)."""
    from repro_torch.obs import prof
    return prof.H100_SXM_BF16 if bf16 else prof.H100_SXM


def phase_times(dense, sparse, cut_errs):
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import local_sdca as dk, ops, sparse_sdca as sk
    from repro_torch.obs import cost
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
                cut_errs["local_sdca"], ms, cost.round_stats(cfg, Xp, mk),
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
                cost.round_stats(cfg, sh, mk),
                f"K={K} nk={nk} r_max={r_max} d={sh.d} nnz={nnz} "
                f"depth={depth}",
                _host_split(cfg, sh, yp, mk, r.state),
                dict(us_per_step=1e3 * ms / steps)))
    rows = []
    for (name, src, repl, launches, r, (abs_err, rel_err, plain), cut, ms,
         stats, shape, split, extra) in out:
        rounds = len(r.history["round"])
        rows.append(_row(name, src, repl, launches, launches / rounds,
                         "per round", (abs_err, rel_err), cut, ms, plain,
                         None, stats, _hw(), shape, rounds=rounds,
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
         lib_ms, stats, hw, shape, **extra):
    """One kernel's entry of the summary line, logged as it is made. `errs`
    and `cut` are (max abs, max rel) errors against the plain version on
    the path's inputs and at the cut shapes; `stats` the call's bytes and
    flops (`hbm_bytes`, `flops`: `obs.cost`'s keys), its bound the larger
    of their times on `hw` (a `repro_torch.obs.prof.HardwareSpec`);
    `extra` adds keys."""
    nbytes, flops = stats["hbm_bytes"], stats["flops"]
    roof = hw.roofline(flops, nbytes, 0.0)
    bound_ms = 1e3 * max(roof["t_memory_s"], roof["t_compute_s"])
    bound_by = ("bytes" if roof["t_memory_s"] >= roof["t_compute_s"]
                else "operations")
    lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
    log(f"  {name}: {ms:.3f} ms a call at {shape}; bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes:.0f} B at {hw.hbm_bw / 1e12:g} TB/s, "
        f"{flops:.0f} flop at {hw.peak_flops / 1e12:g} TFLOP/s, {hw.name}) "
        f"-> {ms / bound_ms:.1f}x the bound; launches "
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
    (args, kwargs) in `seen`: layer 0's own kernel inputs, detached (a
    weight among them is a trainable parameter, and the kernels refuse
    inputs that require grad)."""
    def around(real, *args, **kw):
        if not seen:
            seen.append((tuple(a.detach() if hasattr(a, "detach") else a
                               for a in args), kw))
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
        lib_ms, {"hbm_bytes": nbytes, "flops": flops}, _hw(bf16=True),
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
        f"{nbytes / _hw().hbm_bw * 1e3:.4f} ms)")
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
        cut_errs["ssm_scan"], ms, plain_ms, None,
        {"hbm_bytes": nbytes, "flops": flops}, _hw(),
        f"B={Bb} S={S} di={di} N={N} f32",
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
    from repro_torch.obs import cost
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
            "ms": ms, "nnz": nnz, "stats": cost.round_stats(cfg, sh, mk)}


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
    from repro_torch import comm
    from repro_torch.core.losses import get_loss
    from repro_torch.data.sparse import row_sqnorms
    from repro_torch.kernels import sparse_sdca as sk
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.obs import cost
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
        pipe["stats"], _hw(), f"K={K} nk={nk} r_max={r_max} d={d} nnz={nnz} "
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
    # the zx round's bytes and flops (`obs.cost.zx_round`): every nonzero
    # once a pass, every step's z vectors, the vectors once a round
    topo = comm.Topology.from_mesh(make_test_mesh((K, M), device=fs.device),
                                   "data", "model")
    stats = cost.round_stats(cfg, fs, mk, topo)
    rounds = len(r.history["round"])
    rows.append(_row(
        "sparse_sdca_zx", "src/repro_torch/kernels/csrc/sparse_sdca_zx.cu",
        "src/repro/kernels/sparse_sdca.py:394", mesh["launches"],
        mesh["launches"] / rounds, "per round", errs[:2],
        cut_errs["sparse_sdca_zx"], ms, errs[2], None, stats, _hw(),
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


# ----------------------------------------------------------------------------
# the eighth slice: dense feature sharding (phase 15), the multi-process
# backend on one card (16) and accelerated rounds (17)
# ----------------------------------------------------------------------------

MESH_DENSE_RTOL = 1e-5         # phase 15: 4 x 2 mesh vs the K = 4 run
DIST_RANKS = 4                 # phase 16's ranks, all on cuda:0
DIST_TIMEOUT = 240             # s for phase 16's spawn: start, data, runs
# phase 16: ranks vs the one-process runs, relative per round: 1e-6, but
# epsilon's, whose first card run read 1.19e-6 at round 3 (gap 2.09e-3):
# gloo sums the 4 workers' du in its own order, and the float32 rounding
# of w that leaves is carried through the next round's walk
DIST_RTOL = {"rcv1 K=4": 1e-6, "epsilon K=4": 5e-6, "epsilon-cut 2x2": 1e-6}
MESH_CUT_NK, MESH_CUT_H = 4_096, 512  # phase 16's 2 x 2 dense mesh
ACCEL_PIN = dict(loss="squared", lam=5e-4, H=128, solver="sdca",
                 aggregator="add")   # tests/test_accel.py's pinned problem


def _rel(got, want):
    return max(abs(a / b - 1) for a, b in zip(got, want))


def phase_mesh_dense(dev, dense):
    """Phase 15: epsilon's tensors on a (4, 2) one-card mesh through the
    eager `sdca`, against the one-card K = 4 vmap run on the same orders."""
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.launch.mesh import make_test_mesh
    Xp, yp, mk = dense[:3]
    K, M, H, rounds = 4, 2, 2_048, 3
    X, y, mask = (Xp.view(K, -1, Xp.shape[-1]), yp.view(K, -1),
                  mk.view(K, -1))
    kw = dict(loss="hinge", lam=DENSE_LAM, H=H, solver="sdca")
    counts = _counts_zero()
    r = solve(CoCoAConfig.adding(K, backend="shard_map", model_axis="model",
                                 **kw), X, y, mask, rounds=rounds,
              seed=SEED, mesh=make_test_mesh((K, M), device=dev))
    launches = counts()
    one = solve(CoCoAConfig.adding(K, **kw), X, y, mask, rounds=rounds,
                seed=SEED)
    rel = _rel(r.history["gap"], one.history["gap"])
    per_round = K * Xp.shape[-1] // M + K * M * H
    log(f"[15 mesh-dense] epsilon (K={K}, nk={y.shape[1]}, d=2000) on a "
        f"{K} x {M} mesh, eager sdca, H={H}: s a round "
        + ", ".join(f"{e:.3f}" for e in r.history["execute_s"])
        + f" (the K={K} vmap run: "
        + ", ".join(f"{e:.3f}" for e in one.history["execute_s"])
        + f"); gaps max rel diff {rel:.3e} (limit {MESH_DENSE_RTOL}); "
        f"comm_floats per round {r.history['comm_floats'][0]} "
        f"(K d_local + K M H = {per_round})")
    _check_gaps("epsilon 4x2 sdca", r.history, rounds)
    if rel > MESH_DENSE_RTOL:
        fail(f"phase 15 gaps {r.history['gap']} differ from the K={K} "
             f"run's {one.history['gap']}")
    if any(launches.values()):
        fail(f"phase 15 launched kernels {launches}: the feature-sharded "
             f"dense round is the eager sdca's")
    if r.history["comm_floats"][0] != per_round:
        fail(f"phase 15 priced {r.history['comm_floats'][0]} floats a "
             f"round, not {per_round}")


def _dist_rank(rank, world, jobs):
    """Phase 16's rank on cuda:0: each job's `solve` on a process mesh,
    from this rank's worker's block (numpy files the parent wrote), with
    its own launch counts, kernel ms (CUDA events) and exchange ms (host
    clock, synchronized: the staging through the host included)."""
    import numpy as np
    import torch
    from repro_torch import comm
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.data import SparseShards
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_process_mesh
    out = []
    for job in jobs:
        dev = torch.device(job["device"])
        mesh = make_process_mesh(job["shape"], job["axes"], device=dev)
        cfg = CoCoAConfig(**job["cfg"])
        k = comm.Topology.from_mesh(mesh, "data", cfg.model_axis).worker
        arr = {n: torch.from_numpy(np.load(f"{job['blocks']}-{k}-{n}.npy"))
               for n in job["arrays"]}
        X = (SparseShards(arr["cols"], arr["vals"], arr["nnz"],
                          d=job["d"]) if "cols" in arr else arr["X"])
        kernel_ms, exchange_ms, model_sums = [], [], [0]

        def kernel(real, *a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = real(*a, **kw)
            end.record()
            end.synchronize()
            kernel_ms.append(start.elapsed_time(end))
            return res

        def exchange(real, *a, **kw):
            synchronize(dev)
            t0 = time.perf_counter()
            res = real(*a, **kw)
            synchronize(dev)
            exchange_ms.append(1e3 * (time.perf_counter() - t0))
            return res

        def model_sum(real, *a, **kw):
            model_sums[0] += 1
            return real(*a, **kw)

        counts = _counts_zero()
        ops.LAST_SPARSE_CONFIG = None
        with _wrapped(ops, job["kernel"], kernel), \
                _wrapped(comm, "exchange", exchange), \
                _wrapped(comm.Topology, "model_sum", model_sum):
            r = solve(cfg, X, arr["y"], arr["mask"], rounds=job["rounds"],
                      seed=SEED, mesh=mesh)
        out.append({"gap": r.history["gap"],
                    "execute_s": r.history["execute_s"],
                    "certificate_s": r.history["certificate_s"],
                    "kernel_ms": kernel_ms, "exchange_ms": exchange_ms,
                    "launches": counts(), "model_sums": model_sums[0],
                    "depth": (ops.LAST_SPARSE_CONFIG or {}).get(
                        "buffer_depth"),
                    "coords": mesh.coords()})
    return out


def _save_blocks(path, K, **arrays):
    """Worker k's rows of every (K, ...) array, as `{path}-{k}-{name}.npy`."""
    import numpy as np
    for k in range(K):
        for name, a in arrays.items():
            np.save(f"{path}-{k}-{name}.npy", a[k:k + 1].cpu().numpy())


def _blocks_vs_plain(runs, one, data, depth):
    """Rows 3 and 1 at the shapes a rank of phase 16 launches them: worker
    0's block (K = 1, the rank's nk) on the next round's inputs of the
    one-process K = 4 run (its alpha row, w, sigma'/(tau n) of the global
    n, and row 0 of the round's visit order, as every rank draws it), each
    held to its plain version with `_against_plain`'s tolerance. The ranks'
    gaps are held to those one-process runs, so the ranks' longer walks are
    held to plain on one side and to the K = 4 launches on the other."""
    from repro_torch.core import CoCoAConfig
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import local_sdca as dk, sparse_sdca as sk
    hinge = {"loss": get_loss("hinge")}
    for name, kernel, plain in (
            ("rcv1 K=4", _at_depth(depth), sk.sparse_local_sdca_plain),
            ("epsilon K=4", dk.local_sdca, dk.local_sdca_plain)):
        X, y, mask = data[name]
        cfg = CoCoAConfig(**{**runs[name]["cfg"], "backend": "vmap"})
        state = one[name].state
        w, scale, perm = _round_inputs(cfg, X, y, mask, state)
        block = (X.cols[:1], X.vals[:1]) if name.startswith("rcv1") else (
            X[:1],)
        args = (*block, y[:1], state.alpha[:1], mask[:1], w, scale, perm[:1])
        t0 = time.perf_counter()
        abs_err, rel_err, plain_ms, _ = _against_plain(
            f"{runs[name]['expect']} at a rank's block (K=1, "
            f"nk={y.shape[1]})", kernel, plain, args, hinge)
        log(f"  {name}: worker 0's block held to plain, max_abs "
            f"{abs_err:.3e}; the plain walk {plain_ms:.1f} ms (the check "
            f"{time.perf_counter() - t0:.1f} s)")


def phase_dist(dev, sparse, dense):
    """Phase 16: the multi-process backend, 4 ranks spawned on cuda:0 over
    gloo, each with its worker's block only: rcv1 K = 4 (the ring kernel,
    one launch a round per rank), epsilon K = 4 (the dense kernel) and a
    2 x 2 dense mesh at d = 2,000 (the eager sdca, a scalar all_reduce a
    step over the model column), each against the one-process run on the
    card on the same orders; first worker 0's blocks of the two kernel
    runs are held to the plain versions (`_blocks_vs_plain`)."""
    import tempfile
    import torch
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.data import SparseShards, partition_sparse
    from repro_torch.launch.mesh import make_test_mesh, spawn_ranks
    t0 = time.perf_counter()
    csr, y = sparse[7]
    sh, ys, ms = partition_sparse(csr, y, DIST_RANKS, device="cpu")
    Xp, yp, mk = dense[:3]
    K = DIST_RANKS
    Xe, ye, me = (Xp.view(K, -1, Xp.shape[-1]), yp.view(K, -1),
                  mk.view(K, -1))
    cut = slice(0, MESH_CUT_NK)
    Xc, yc, mc = Xe[:2, cut], ye[:2, cut], me[:2, cut]
    rounds = 3
    base = dict(loss="hinge", backend="shard_map")
    where = dict(device=str(dev), rounds=rounds)
    runs = {
        "rcv1 K=4": dict(
            shape=(K,), axes=("data",), kernel="sparse_local_sdca_block",
            expect="sparse_sdca_pipelined", d=sh.d, **where,
            cfg=dict(base, lam=SPARSE_LAM, H=ys.shape[1],
                     solver="sdca_sparse_kernel", gamma=1.0, sigma_p=K)),
        "epsilon K=4": dict(
            shape=(K,), axes=("data",), kernel="local_sdca_block",
            expect="local_sdca", d=Xe.shape[-1], **where,
            cfg=dict(base, lam=DENSE_LAM, H=ye.shape[1],
                     solver="sdca_kernel", gamma=1.0, sigma_p=K)),
        "epsilon-cut 2x2": dict(
            shape=(2, 2), axes=("data", "model"), kernel="local_sdca_block",
            expect=None, d=Xe.shape[-1], **where,
            cfg=dict(base, lam=DENSE_LAM, H=MESH_CUT_H, solver="sdca",
                     model_axis="model", gamma=1.0, sigma_p=2)),
    }
    sd = SparseShards(sh.cols.to(dev), sh.vals.to(dev), sh.nnz.to(dev),
                      d=sh.d)
    data = {"rcv1 K=4": (sd, ys.to(dev), ms.to(dev)),
            "epsilon K=4": (Xe, ye, me)}
    t0 = time.perf_counter()
    one = {
        name: solve(CoCoAConfig(**{**runs[name]["cfg"], "backend": "vmap"}),
                    *data[name], rounds=rounds, seed=SEED)
        for name in data}
    one["epsilon-cut 2x2"] = solve(
        CoCoAConfig(**runs["epsilon-cut 2x2"]["cfg"]), Xc, yc, mc,
        rounds=rounds, seed=SEED, mesh=make_test_mesh((2, 2), device=dev))
    log(f"[16 dist] the one-process runs took "
        f"{time.perf_counter() - t0:.1f} s")
    depth = sparse[8]
    _blocks_vs_plain(runs, one, data, depth)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        blocks = {"rcv1 K=4": dict(cols=sh.cols, vals=sh.vals, nnz=sh.nnz,
                                   y=ys, mask=ms),
                  "epsilon K=4": dict(X=Xe, y=ye, mask=me),
                  "epsilon-cut 2x2": dict(X=Xc, y=yc, mask=mc)}
        for i, (name, arrays) in enumerate(blocks.items()):
            runs[name]["blocks"] = f"{tmp}/job{i}"
            runs[name]["arrays"] = tuple(arrays)
            _save_blocks(runs[name]["blocks"], len(arrays["y"]), **arrays)
        log(f"  {K} ranks on {dev} over gloo; blocks written in "
            f"{time.perf_counter() - t0:.1f} s (rcv1 K={K} nk={ys.shape[1]}"
            f", epsilon K={K} nk={ye.shape[1]}, and the 2 x 2 dense mesh "
            f"cut to epsilon's first {MESH_CUT_NK} rows of workers 0 and 1, "
            f"H {MESH_CUT_H}, d = 2,000); limit {DIST_TIMEOUT} s")
        t0 = time.perf_counter()
        try:
            ranks = spawn_ranks(_dist_rank, K, (list(runs.values()),),
                                timeout=DIST_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 16: {e}")
        spawn_s = time.perf_counter() - t0
    log(f"  the spawn took {spawn_s:.1f} s (start, load, 3 runs)")
    for j, (name, run) in enumerate(runs.items()):
        got = [rk[j] for rk in ranks]
        want = one[name].history
        rel = _rel(got[0]["gap"], want["gap"])
        log(f"  {name}: gaps " + " ".join(f"{g:.6e}" for g in got[0]["gap"])
            + f"; max rel diff {rel:.3e} from the one-process run (limit "
            f"{DIST_RTOL[name]}); s a round across the ranks "
            + ", ".join(f"{e:.3f}" for e in got[0]["execute_s"])
            + " against " + ", ".join(f"{e:.3f}" for e in want["execute_s"])
            + " in one process")
        for rk in got:
            log(f"    rank {rk['coords']}: kernel ms "
                + ", ".join(f"{t:.3f}" for t in rk["kernel_ms"])
                + "; exchange ms " + ", ".join(
                    f"{t:.3f}" for t in rk["exchange_ms"])
                + f"; certificate s " + ", ".join(
                    f"{t:.3f}" for t in rk["certificate_s"])
                + f"; launches {rk['launches']}; model sums "
                f"{rk['model_sums']}; ring depth {rk['depth']}")
            if rk["gap"] != got[0]["gap"]:
                fail(f"phase 16 {name}: ranks disagree: {rk['gap']} vs "
                     f"{got[0]['gap']}")
            if run["expect"] == "sparse_sdca_pipelined" and \
                    rk["depth"] != depth:
                fail(f"phase 16 {name}: rank {rk['coords']} ran ring depth "
                     f"{rk['depth']}, not the {depth} held to plain")
            if run["expect"] is not None:
                ran = {key: v for key, v in rk["launches"].items() if v}
                if ran != {run["expect"]: rounds}:
                    fail(f"phase 16 {name}: rank {rk['coords']} launched "
                         f"{rk['launches']}, expected {rounds} of "
                         f"{run['expect']}")
            elif any(rk["launches"].values()) or \
                    rk["model_sums"] < rounds * MESH_CUT_H:
                fail(f"phase 16 {name}: rank {rk['coords']} launched "
                     f"{rk['launches']} and summed over the model column "
                     f"{rk['model_sums']} times (at least "
                     f"{rounds * MESH_CUT_H})")
        _check_gaps(f"{name} across {K} ranks", {
            "round": list(range(1, rounds + 1)), "gap": got[0]["gap"],
            "execute_s": got[0]["execute_s"],
            "certificate_s": got[0]["certificate_s"]}, rounds)
        if rel > DIST_RTOL[name]:
            fail(f"phase 16 {name}: gaps {got[0]['gap']} differ from the "
                 f"one-process run's {want['gap']}")


def phase_accel(dev, dense):
    """Phase 17: the pinned ill-conditioned problem to gap 1e-4 under
    none, nesterov:16 and catalyst:20 (eager sdca), and epsilon K = 8
    through the dense kernel under nesterov:16 (its first round equal to
    the plain first round bit for bit)."""
    import torch
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.data import make_classification, partition
    X, y = make_classification(2048, 128, seed=0, cond=100.0)
    data = partition(X, y, 8, seed=0, device=dev)
    took = {}
    for accel in ("none", "nesterov:16", "catalyst:20"):
        t0 = time.perf_counter()
        r = solve(CoCoAConfig(accel=accel, **ACCEL_PIN), *data, rounds=300,
                  eps_gap=1e-4, seed=SEED)
        took[accel] = r.history["round"][-1]
        head = "[17 accel]" if accel == "none" else " "
        log(f"{head} illcond K=8 {accel}: {took[accel]} rounds to gap "
            f"{r.history['gap'][-1]:.4e} in {time.perf_counter() - t0:.2f} s")
        if r.history["gap"][-1] > 1e-4:
            fail(f"phase 17 {accel} did not reach gap 1e-4 in 300 rounds")
    for accel in ("nesterov:16", "catalyst:20"):
        if took[accel] * 1.3 > took["none"]:
            fail(f"phase 17: {accel} took {took[accel]} rounds, none "
                 f"{took['none']}: not 1.3x fewer")
    Xp, yp, mk = dense[:3]
    kw = dict(loss="hinge", lam=DENSE_LAM, H=yp.shape[1],
              solver="sdca_kernel")
    plain = solve(CoCoAConfig.adding(8, **kw), Xp, yp, mk, rounds=1,
                  seed=SEED)
    cfg = CoCoAConfig.adding(8, accel="nesterov:16", **kw)
    counts = _counts_zero()
    first = solve(cfg, Xp, yp, mk, rounds=1, seed=SEED)
    rest = solve(cfg, Xp, yp, mk, rounds=2, seed=SEED, state=first.state)
    launches = counts()
    same = (torch.equal(plain.state.w, first.state.w)
            and torch.equal(plain.state.alpha, first.state.alpha))
    gaps = first.history["gap"] + rest.history["gap"]
    log(f"  epsilon K=8 sdca_kernel nesterov:16: gaps "
        + " ".join(f"{g:.6e}" for g in gaps) + f" (plain round 1: "
        f"{plain.history['gap'][0]:.6e}); round 1's state "
        f"{'equal' if same else 'NOT equal'} to the plain round's bit for "
        f"bit; launches {launches}")
    if not same:
        fail("phase 17: the first accelerated round is not the plain round")
    if launches["local_sdca"] != 3:
        fail(f"phase 17: local_sdca launched {launches['local_sdca']} "
             f"times in 3 rounds")
    _check_gaps("epsilon K=8 nesterov:16", {
        "round": [1, 2, 3], "gap": gaps,
        "execute_s": first.history["execute_s"] + rest.history["execute_s"],
        "certificate_s": first.history["certificate_s"]
        + rest.history["certificate_s"]}, 3)


# ----------------------------------------------------------------------------
# the ninth slice (phase 18): the observability stack on phase 4's path
# ----------------------------------------------------------------------------

OBS_REGIONS = ("cocoa/local_solve", "cocoa/exchange", "cocoa/certificate")
RING_KERNEL = "sparse_sdca_pipelined_kernel"   # row 3's __global__ name
OBS_TRACES = 5                 # traces phase 18 takes before it gives up
CLI_TIMEOUT = 120              # s for each of phase 18's CLI runs


def _busy_in(gpu_events, rng):
    """Device ms of the events that start inside the range `rng`."""
    t0, t1 = rng["ts"], rng["ts"] + rng["dur"]
    return sum(e["dur"] for e in gpu_events if t0 <= e["ts"] < t1) / 1e3


def _cli(args, cwd):
    """Start `python -m <args>` with the checkout's port, on the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(name, proc, phase=18):
    """Wait for a CLI run of a phase; fail the run when it fails."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"phase {phase}: {name} not done in {CLI_TIMEOUT} s")
    if proc.returncode != 0:
        fail(f"phase {phase}: {name} exited {proc.returncode}:\n"
             f"{err[-3000:]}")
    return out


def phase_obs(dev, sparse, rows):
    """Phase 4's rcv1 path (K = 8, ring depth 4, 5 rounds) under the full
    bus -- the aggregator, a JSONL file, round profiles on the card's
    spec, the dashboard and the torch.profiler sink -- with its records,
    profiles and trace checked, the profiler's cost and the rounds' idle
    share printed; then the CLI's telemetry flags on the card."""
    import io
    import statistics
    import tempfile
    from repro_torch.core import solve
    from repro_torch.obs import (Aggregator, Dashboard, EventBus, JsonlSink,
                                 ProfilerSink, RoundProfileSink, cost,
                                 default_hardware, validate_record)
    from repro_torch.obs import validate
    from repro_torch.obs.events import (inside, lost_device_records,
                                        trace_events)
    t_start = time.perf_counter()
    sh, yp, mk, r4, cfg, _, _, _, _ = sparse
    rounds = len(r4.history["round"])
    bound_ms = next(r["bound_ms"] for r in rows
                    if r["name"] == "sparse_sdca_pipelined")
    hw = default_hardware(dev)
    log(f"[18 obs] phase 4's rcv1 path, {rounds} rounds, under the full "
        f"bus; default_hardware() = {hw.name}")
    if hw.name != "h100_sxm":
        fail(f"phase 18: default_hardware() gave {hw.name}, not h100_sxm")
    tmp = tempfile.TemporaryDirectory()
    work = pathlib.Path(tmp.name)
    stats = cost.round_stats(cfg, sh, mk)

    def bus_run(profiled):
        bus = EventBus()
        trace = (bus.subscribe(ProfilerSink(work / "trace")) if profiled
                 else None)
        agg = bus.subscribe(Aggregator())
        bus.subscribe(JsonlSink(work / f"m{int(profiled)}.jsonl"))
        psink = bus.subscribe(RoundProfileSink(
            work / f"m{int(profiled)}.prof.jsonl", stats, hw=hw,
            device=dev, shape={"K": 8, "nk": int(yp.shape[1])}))
        screen = io.StringIO()
        bus.subscribe(Dashboard(out=screen, total_rounds=rounds,
                                prof_source=psink))
        counts = _counts_zero()
        r = solve(cfg, sh, yp, mk, rounds=rounds, gap_every=1, seed=SEED,
                  obs=bus)
        launches = counts()
        bus.close()
        return r, agg, psink, screen.getvalue(), trace, launches

    _, agg_bus, _, _, _, _ = bus_run(profiled=False)
    for attempt in range(1, OBS_TRACES + 1):
        r, agg, psink, screen, trace, launches = bus_run(profiled=True)
        if trace.disabled is not None or not trace.trace_path.exists():
            fail(f"phase 18: the ProfilerSink disabled itself: "
                 f"{trace.disabled}")
        ev = trace_events(trace.trace_path)
        lost = lost_device_records(ev)
        if trace.lost_records != len(lost):
            fail(f"phase 18: the sink counted {trace.lost_records} lost "
                 f"device records, the trace holds {len(lost)}")
        if not lost:
            break
        h0 = min(e["ts"] for e in ev["launch"].values())
        log(f"  trace {attempt}: the profiler lost (or put before their "
            f"launch) the device records of {len(lost)} of the run's "
            f"host calls ("
            + ", ".join(sorted({e['name'] for e in lost}))
            + f") at {min(e['ts'] - h0 for e in lost) / 1e3:.3f}-"
            f"{max(e['ts'] - h0 for e in lost) / 1e3:.3f} ms into the run; "
            f"the run's launch counts {launches}; tracing the run again")
    else:
        fail(f"phase 18: every one of {OBS_TRACES} traces lost device "
             f"records")
    # the CLI on the card: started once the timed runs are done (the two
    # runs share the card), it imports and makes its data while the
    # checks below read the records and the trace
    cli = {
        "rcv1_sparse": _cli(
            ["repro_torch.launch.cocoa_train", "--dataset", "rcv1_sparse",
             "--solver", "sdca_sparse_kernel", "--rounds", "6",
             "--metrics-out", str(work / "cli.jsonl"), "--profile",
             str(work / "cli_trace"), "--dashboard"], work),
        "epsilon_like": _cli(
            ["repro_torch.launch.cocoa_train", "--dataset", "epsilon_like",
             "--solver", "sdca_deadline", "--H", "512", "--rounds", "4",
             "--simulate-straggler", "1", "--metrics-out",
             str(work / "straggler.jsonl")], work)}
    log(f"  launches under the bus: {launches}; dashboard lines: "
        f"{len(screen.splitlines())}, first: {screen.splitlines()[0]}")
    if launches["sparse_sdca_pipelined"] != rounds:
        fail(f"phase 18: the ring kernel launched {launches} in {rounds} "
             f"rounds")
    recs = agg.records
    for rec in recs:
        validate_record(rec.to_dict())
    printed = [f"{rec.gap:.4e}" for rec in recs]
    if len(recs) != rounds or printed != [f"{g:.4e}"
                                          for g in r4.history["gap"]]:
        fail(f"phase 18: records' gaps {printed} differ from phase 4's "
             f"{r4.history['gap']}")
    m, pp = work / "m1.jsonl", work / "m1.prof.jsonl"
    if validate.main([str(m), "--prof", str(pp), "--require-timing"]) != 0:
        fail("phase 18: repro_torch.obs.validate rejected the run's files")
    for p in psink.profiles:
        if abs(1e3 * p.bound_s / bound_ms - 1) > 0.01:
            fail(f"phase 18: profile bound {1e3 * p.bound_s:.4f} ms is not "
                 f"phase 6's {bound_ms:.4f} within 1%")
        if p.bw_frac > 1.05 or p.model_vs_measured > 1.05:
            fail(f"phase 18: bw_frac {p.bw_frac} or model_vs_measured "
                 f"{p.model_vs_measured} above 1.05")
    log(f"  {len(recs)} records valid, gaps equal phase 4's to their "
        f"printed digits ({' '.join(printed)}); compile_s "
        f"{[rec.compile_s for rec in recs]}; profiles on {hw.name}: bound "
        f"{1e3 * psink.profiles[0].bound_s:.4f} ms (phase 6: "
        f"{bound_ms:.4f}), {psink.profiles[0].dominant}-bound, bw_frac "
        + ", ".join(f"{p.bw_frac:.5f}" for p in psink.profiles)
        + ", model_vs_measured "
        + ", ".join(f"{p.model_vs_measured:.5f}" for p in psink.profiles))
    # the trace: the rounds' ranges, and the ring kernel inside them
    counts = {name: len(ev["cpu"].get(name, ())) for name in
              ("cocoa_round",) + OBS_REGIONS}
    log(f"  trace {attempt}, {trace.trace_path.stat().st_size} bytes: ranges "
        f"{counts}, {len(ev['gpu_all'])} device events, every device record "
        f"of the rounds and certificates kept and none before its launch, "
        f"device-side ranges "
        f"{ {k: len(v) for k, v in ev['gpu'].items()} }")
    if any(counts[name] != rounds for name in OBS_REGIONS):
        fail(f"phase 18: the trace holds {counts}, not {rounds} of each of "
             f"{OBS_REGIONS}")
    ring = [e for e in ev["gpu_all"] if RING_KERNEL in e["name"]]
    solves = ev["cpu"]["cocoa/local_solve"]
    how, lag = [], []
    for k in ring:
        launch = ev["launch"].get(k.get("args", {}).get("correlation"))
        if launch is not None:
            lag.append((k["ts"] - launch["ts"]) / 1e3)
        if launch is not None and inside(launch, solves):
            how.append("launched in")
        elif inside(k, ev["gpu"].get("cocoa/local_solve", ())):
            how.append("ran in")
        else:
            how.append("outside")
    log(f"  ring kernel in the trace: {len(ring)} launches, each "
        f"{sorted(set(how))} a cocoa/local_solve range; ms "
        + ", ".join(f"{k['dur'] / 1e3:.3f}" for k in ring)
        + "; start after its launch call, ms "
        + ", ".join(f"{v:.3f}" for v in lag))
    if len(ring) != rounds or "outside" in how:
        fail(f"phase 18: {len(ring)} ring kernels in the trace ({how}), "
             f"expected {rounds} inside cocoa/local_solve ranges")
    # the profiler's cost, and the rounds' idle share
    ex = {"phase 4 (no bus)": r4.history["execute_s"],
          "bus, no profiler": [rec.execute_s for rec in agg_bus.records],
          "bus + profiler": r.history["execute_s"]}
    log("  execute_s a round (host clock, each round ended by a "
        "synchronize): " + "; ".join(
            f"{k}: " + ", ".join(f"{1e3 * v:.3f}" for v in vals)
            + f" ms (median {1e3 * statistics.median(vals):.3f})"
            for k, vals in ex.items()))
    busy = [_busy_in(ev["gpu_all"], rg) for rg in ev["cpu"]["cocoa_round"]]
    host = [rg["dur"] / 1e3 for rg in ev["cpu"]["cocoa_round"]]
    log("  device busy over cocoa_round host ms (profiled): " + ", ".join(
        f"{b:.3f}/{h:.3f} (idle {1 - b / h:.3f})" for b, h in
        zip(busy, host)) + "; against the unprofiled bus run's execute_s: "
        + ", ".join(f"idle {1 - b / (1e3 * e):.3f}" for b, e in
                    zip(busy, ex["bus, no profiler"])))
    cert = ev["cpu"]["cocoa/certificate"]
    cb = [_busy_in(ev["gpu_all"], rg) for rg in cert]
    ch = [rg["dur"] / 1e3 for rg in cert]
    log(f"  certificate: device busy {sum(cb):.3f} of {sum(ch):.3f} host ms "
        f"over {len(cert)} certificates (busy share "
        f"{sum(cb) / sum(ch):.3f}); per certificate " + ", ".join(
            f"{b:.3f}/{h:.3f}" for b, h in zip(cb, ch)))
    out = _finish("cocoa_train rcv1_sparse", cli["rcv1_sparse"])
    log("  cli rcv1_sparse --metrics-out --profile --dashboard: " + " | ".join(
        ln for ln in out.splitlines() if ln.startswith(("round ", "final",
                                                        "time:"))))
    v = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate",
         str(work / "cli.jsonl"), "--prof", str(work / "cli.prof.jsonl")],
        cwd=work, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=CLI_TIMEOUT)
    log(f"  python -m repro_torch.obs.validate: exit {v.returncode}: "
        f"{v.stdout.strip()} {v.stderr.strip()}")
    if v.returncode != 0:
        fail("phase 18: the CLI's files did not validate")
    _finish("cocoa_train epsilon_like", cli["epsilon_like"])
    srecs = [json.loads(ln) for ln in
             (work / "straggler.jsonl").read_text().splitlines()]
    K = 8
    for rec in srecs:
        rates = rec["throughput"] or []
        if len(rec["budgets"] or []) != K or len(rates) != K or min(
                range(K), key=rates.__getitem__) != 1:
            fail(f"phase 18: straggler record {rec}")
    log(f"  cli epsilon_like --simulate-straggler 1: {len(srecs)} records, "
        f"budgets {srecs[-1]['budgets']}, rates " + ", ".join(
            f"{v:.4g}" for v in srecs[-1]["throughput"])
        + " (worker 1 lowest)")
    tmp.cleanup()
    log(f"  phase 18 took {time.perf_counter() - t_start:.1f} s")


# ----------------------------------------------------------------------------
# the tenth slice (phase 19): checkpoints, worker failure, elastic
# re-partitioning and the paper's baselines on the main path's tensors
# ----------------------------------------------------------------------------

CKPT_LEAVES = ("w", "alpha", "rounds", "alpha_bar", "ef")   # the CLI's
FIG2_B = 2_048                 # phase 19's mini-batch CD / SGD b_local
FIG2_H = 2_048                 # phase 19's one-shot local steps
RESPLIT_RTOL = 1e-6            # P and D across a re-split, relative


def _sync_ms(fn):
    """(host ms of fn() ended by a synchronize of the card, its result)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _printed(gaps):
    return [f"{g:.4e}" for g in gaps]


def _pd(alpha, X, y, mask, lam):
    from repro_torch.core import duality
    from repro_torch.core.losses import get_loss
    p, d, _ = duality.gap_decomposed(alpha, X, y, mask, get_loss("hinge"),
                                     lam)
    return float(p), float(d)


def _restart(dev, sparse):
    """rcv1 (K = 8, the ring kernel at depth 4): 2 rounds, an async save,
    every tensor of the run dropped, a restore onto the card and 3 more
    rounds must equal phase 4's 5-round run bit for bit."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import solve, state_from_tree, state_to_tree
    sh, yp, mk, r4, cfg, *_ = sparse
    counts = _counts_zero()
    first = solve(cfg, sh, yp, mk, rounds=2, gap_every=1, seed=SEED)
    gaps = list(first.history["gap"])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=2, async_write=True)
        tree = state_to_tree(first.state, seed=SEED)
        save_ms, _ = _sync_ms(lambda: mgr.save(2, tree))
        wait_ms, _ = _sync_ms(mgr.wait)
        mb = (pathlib.Path(tmp) / "step_2" / "host0.npz").stat().st_size / 1e6
        del first, tree
        gc.collect()

        def restore():
            out, man = mgr.restore(dict.fromkeys(CKPT_LEAVES, 0),
                                   device="cpu")
            return state_from_tree(out, dev), man

        restore_ms, (st, man) = _sync_ms(restore)
    second = solve(cfg, sh, yp, mk, rounds=3, gap_every=1, seed=SEED,
                   state=st)
    launches = counts()
    gaps += second.history["gap"]
    same = {leaf: torch.equal(getattr(second.state, leaf),
                              getattr(r4.state, leaf))
            for leaf in ("w", "alpha", "alpha_bar", "ef")}
    log(f"  restart (rcv1, K=8, ring depth 4): 2 rounds, save {save_ms:.1f} "
        f"host ms (the snapshot copied to the host; the write's wait "
        f"{wait_ms:.1f} ms more), {mb:.1f} MB on disk, restore onto the "
        f"card {restore_ms:.1f} ms (step {man['step']}), 3 more rounds; "
        f"launches {launches['sparse_sdca_pipelined']}; state equal to "
        f"phase 4's 5-round run bit for bit: {same}; gaps "
        f"{' '.join(_printed(gaps))} (phase 4: "
        f"{' '.join(_printed(r4.history['gap']))})")
    if not all(same.values()) or second.state.rounds != 5:
        fail(f"phase 19: the restored run differs from phase 4's: {same}")
    if _printed(gaps) != _printed(r4.history["gap"]):
        fail("phase 19: the restored run's gaps differ from phase 4's")
    if launches["sparse_sdca_pipelined"] != 5:
        fail(f"phase 19: the ring kernel launched {launches} in 5 rounds")
    return {"save_ms": save_ms, "restore_ms": restore_ms, "mb": mb}


def _failure(dense):
    """epsilon (K = 8, the dense kernel): worker 0 lost after 2 rounds; the
    certificate stays valid and falls again in 2 more rounds."""
    import torch
    from repro_torch.core import duality, solve
    from repro_torch.runtime import failures
    Xp, yp, mk, _, cfg, _ = dense
    counts = _counts_zero()
    a = solve(cfg, Xp, yp, mk, rounds=2, gap_every=1, seed=SEED)
    drop_ms, st = _sync_ms(lambda: failures.fail_and_recover(
        a.state, Xp, mk, cfg.lam, k=0))
    p, d = _pd(st.alpha, Xp, yp, mk, cfg.lam)
    n = float(duality.effective_n(mk))
    survivors = torch.einsum("kid,ki->d", Xp[1:], st.alpha[1:]) / (
        cfg.lam * n)
    w_err = float(torch.max(torch.abs(st.w - survivors)) /
                  torch.max(torch.abs(survivors)))
    b = solve(cfg, Xp, yp, mk, rounds=2, gap_every=1, seed=SEED, state=st)
    launches = counts()
    log(f"  failure (epsilon, K=8, dense kernel): after 2 rounds (gaps "
        f"{' '.join(_printed(a.history['gap']))}) worker 0 dropped and v "
        f"rebuilt in {drop_ms:.1f} ms; alpha[0] zero: "
        f"{not bool(st.alpha[0].any())}; certificate P={p:.6f} D={d:.6f} "
        f"gap={p - d:.4e}; w vs the 7 survivors' A alpha/(lam n): max rel "
        f"{w_err:.2e}; 2 more rounds: gaps "
        f"{' '.join(_printed(b.history['gap']))}; launches "
        f"{launches['local_sdca']}")
    if st.alpha[0].any() or st.alpha_bar[0].any() or st.ef[0].any():
        fail("phase 19: worker 0's duals survived the drop")
    if not p - d >= -1e-6 * abs(p) or w_err > 1e-5:
        fail(f"phase 19: the certificate after the drop is invalid: P={p} "
             f"D={d}, w off by {w_err}")
    if not b.history["gap"][-1] < p - d:
        fail(f"phase 19: the gap did not fall after the drop: {p - d} -> "
             f"{b.history['gap']}")
    if launches["local_sdca"] != 4:
        fail(f"phase 19: the dense kernel launched {launches} in 4 rounds")
    return {"drop_ms": drop_ms}


def _resplit_check(name, before, after, gap_at, gaps_after):
    rel = [abs(a / b - 1) for a, b in zip(after, before)]
    log(f"    P, D before {before[0]:.9f} {before[1]:.9f}, after "
        f"{after[0]:.9f} {after[1]:.9f} (rel {rel[0]:.1e}, {rel[1]:.1e}); "
        f"gap at the re-split {gap_at:.4e}, then "
        f"{' '.join(_printed(gaps_after))}")
    if max(rel) > RESPLIT_RTOL:
        fail(f"phase 19: {name} moved P or D by {rel}")
    if not gaps_after[-1] < gap_at:
        fail(f"phase 19: {name}: the gap did not fall after the re-split")


def _elastic(dev, sparse, mesh):
    """rcv1 K = 8 -> 4 through the ring kernel, and the 4 x 2 mesh ->
    2 x 2 through the zx kernel: 2 rounds, the re-split on the card, 2
    rounds at the new K."""
    from repro_torch.core import CoCoAConfig, init_state, solve
    from repro_torch.data import SparseShards
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime import elastic
    out = {}
    sh, yp, mk, _, cfg, *_ = sparse
    counts = _counts_zero()
    a = solve(cfg, sh, yp, mk, rounds=2, gap_every=1, seed=SEED)
    before = _pd(a.state.alpha, sh, yp, mk, SPARSE_LAM)
    out["ring_ms"], (new, m4) = _sync_ms(lambda: elastic.repartition(
        {"cols": sh.cols, "vals": sh.vals, "nnz": sh.nnz, "y": yp,
         "alpha": a.state.alpha}, mk, 4))
    sh4 = SparseShards(new["cols"], new["vals"], new["nnz"], d=sh.d)
    nk4 = new["y"].shape[1]
    after = _pd(new["alpha"], sh4, new["y"], m4, SPARSE_LAM)
    cfg4 = CoCoAConfig.adding(4, loss="hinge", lam=SPARSE_LAM, H=nk4,
                              solver="sdca_sparse_kernel")
    st = init_state(sh.d, 4, nk4, device=dev)._replace(
        alpha=new["alpha"], w=a.state.w, rounds=a.state.rounds)
    b = solve(cfg4, sh4, new["y"], m4, rounds=2, gap_every=1, seed=SEED,
              state=st)
    launches = counts()
    used = dict(ops.LAST_SPARSE_CONFIG)
    log(f"  elastic rcv1 K=8 -> 4 after 2 rounds: re-split on the card in "
        f"{out['ring_ms']:.1f} ms, nk {yp.shape[1]} -> {nk4}; launches "
        f"{launches['sparse_sdca_pipelined']} (ring depth "
        f"{used['buffer_depth']})")
    _resplit_check("rcv1 K=8 -> 4", before, after, after[0] - after[1],
                   b.history["gap"])
    if nk4 != 169_350 or launches["sparse_sdca_pipelined"] != 4:
        fail(f"phase 19: rcv1 K=4 ran nk={nk4}, launches {launches}")
    del new, sh4, m4, st, a, b
    fs, yf, mf, cfg42 = mesh["fs"], mesh["yp"], mesh["mk"], mesh["cfg"]
    counts = _counts_zero()
    a = solve(cfg42, fs, yf, mf, rounds=2, gap_every=1, seed=SEED,
              mesh=make_test_mesh((4, 2), device=dev))
    before = _pd(a.state.alpha, fs, yf, mf, SPARSE_LAM)
    out["zx_ms"], (fs2, y2, a2, m2) = _sync_ms(
        lambda: elastic.repartition_features(fs, yf, a.state.alpha, mf, 2))
    after = _pd(a2, fs2, y2, m2, SPARSE_LAM)
    nk2 = y2.shape[1]
    cfg22 = CoCoAConfig.adding(2, lam=SPARSE_LAM, H=nk2, loss="hinge",
                               solver="sdca_sparse_kernel",
                               backend="shard_map", model_axis="model")
    st = init_state(fs.d_padded, 2, nk2, device=dev)._replace(
        alpha=a2, w=a.state.w, rounds=a.state.rounds)
    b = solve(cfg22, fs2, y2, m2, rounds=2, gap_every=1, seed=SEED,
              state=st, mesh=make_test_mesh((2, 2), device=dev))
    launches = counts()
    log(f"  elastic rcv1 mesh 4x2 -> 2x2 after 2 rounds: re-split on the "
        f"card in {out['zx_ms']:.1f} ms, nk {yf.shape[1]} -> {nk2}, "
        f"r_loc {fs2.r_loc}; zx launches {launches['sparse_sdca_zx']}")
    _resplit_check("rcv1 4x2 -> 2x2", before, after, after[0] - after[1],
                   b.history["gap"])
    if launches["sparse_sdca_zx"] != 4 or any(
            launches[k] for k in ("local_sdca", "sparse_sdca",
                                  "sparse_sdca_pipelined")):
        fail(f"phase 19: the 2x2 mesh launched {launches}")
    return out


def _figure2(dense):
    """The paper's Figure 2 at epsilon's shape: CoCoA+ (phase 5's 3 rounds
    of the dense kernel) against mini-batch CD and SGD at the same count
    of communicated vectors, and one-shot averaging."""
    import torch
    from repro_torch.core import baselines, duality
    from repro_torch.core.losses import get_loss
    Xp, yp, mk, r5, cfg, _ = dense
    K = Xp.shape[0]
    rounds = len(r5.history["round"])
    vectors = r5.history["comm_vectors"][-1]
    cd_ms, ((_, _), cd) = _sync_ms(lambda: baselines.run_minibatch_cd(
        Xp, yp, mk, loss_name="hinge", lam=DENSE_LAM, rounds=rounds,
        b_local=FIG2_B, seed=SEED, eval_every=1))
    sgd_ms, (_, sgd) = _sync_ms(lambda: baselines.run_minibatch_sgd(
        Xp, yp, mk, loss_name="hinge", lam=DENSE_LAM, steps=rounds,
        b_local=FIG2_B, seed=SEED, eval_every=1))
    one_ms, w1 = _sync_ms(lambda: baselines.one_shot_average(
        Xp, yp, mk, loss_name="hinge", lam=DENSE_LAM, H=FIG2_H, seed=SEED))
    p1 = float(duality.primal(w1, Xp, yp, mk, get_loss("hinge"), DENSE_LAM))
    d_cocoa = r5.history["dual"][-1]
    rows = [("CoCoA+ (dense kernel)", rounds, vectors,
             r5.history["primal"][-1], r5.history["gap"][-1]),
            (f"mini-batch CD b={FIG2_B}", rounds, cd["comm_vectors"][-1],
             cd["primal"][-1], cd["gap"][-1]),
            (f"mini-batch SGD b={FIG2_B}", rounds, sgd["comm_vectors"][-1],
             sgd["primal"][-1], None),
            (f"one-shot average H={FIG2_H}", 1, K, p1, None)]
    log(f"  Figure 2 at epsilon's shape (K={K}, hinge, lambda={DENSE_LAM}), "
        f"P - D(CoCoA+'s alpha) bounds each primal suboptimality from "
        f"above (CD {cd_ms:.0f} ms, SGD {sgd_ms:.0f} ms, one-shot "
        f"{one_ms:.0f} ms on the host clock):")
    for name, its, vec, prim, gap in rows:
        log(f"    {name:30s} rounds {its} vectors {vec:3d} P={prim:.6f} "
            f"P-D_cocoa={prim - d_cocoa:.4e}"
            + (f" own gap={gap:.4e}" if gap is not None else ""))
    log(f"    CD gap per round {' '.join(_printed(cd['gap']))}; SGD P per "
        f"step " + " ".join(f"{v:.6f}" for v in sgd["primal"]))
    numbers = [v for row in rows for v in row[3:] if v is not None]
    if not all(math.isfinite(v) for v in numbers) or not torch.isfinite(
            w1).all():
        fail(f"phase 19: Figure 2's numbers are not finite: {rows}")
    if cd["comm_vectors"][-1] != vectors or sgd["comm_vectors"][-1] != vectors:
        fail("phase 19: the baselines ran another count of vectors")
    if not cd["gap"][-1] < cd["gap"][0]:
        fail(f"phase 19: mini-batch CD's gap did not fall: {cd['gap']}")
    return {name: prim - d_cocoa for name, _, _, prim, _ in rows}


CLI_RCV1 = ("repro_torch.launch.cocoa_train", "--dataset", "rcv1_sparse",
            "--solver", "sdca_kernel")


def _cli_final(out):
    return [ln for ln in out.splitlines() if ln.startswith("final: rounds=")]


def phase_runtime(dev, sparse, dense, mesh):
    """Checkpoint/restart, the dual-safe drop, elastic re-splits and the
    paper's baselines on the main path's tensors, then the CLI's
    operational flags on the card."""
    import tempfile
    t_start = time.perf_counter()
    log("[19 runtime] checkpoints, worker failure, elastic re-partitioning "
        "and Figure 2's baselines on the main path's tensors")
    restart = _restart(dev, sparse)
    drop = _failure(dense)
    resplit = _elastic(dev, sparse, mesh)
    tmp = tempfile.TemporaryDirectory()
    work = pathlib.Path(tmp.name)
    ck = ["--ckpt", str(work / "ck"), "--ckpt-every", "2"]
    # started once the timed parts are done: the runs share the card
    cli = {"ckpt 4": _cli([*CLI_RCV1, *ck, "--rounds", "4"], work),
           "uninterrupted 8": _cli([*CLI_RCV1, "--rounds", "8"], work),
           "failure": _cli([*CLI_RCV1, "--simulate-failure", "2",
                            "--rounds", "6"], work),
           "elastic": _cli([*CLI_RCV1, "--elastic-to", "4@2", "--rounds",
                            "6"], work),
           "mesh elastic": _cli([*CLI_RCV1, "--mesh", "4x2", "--elastic-to",
                                 "2@2", "--rounds", "6"], work)}
    fig2 = _figure2(dense)
    outs = {"ckpt 4": _finish("cocoa_train ckpt 4", cli["ckpt 4"], 19)}
    cli["ckpt 8"] = _cli([*CLI_RCV1, *ck, "--rounds", "8"], work)
    want = {"failure": "simulating loss of worker 0 (dual-safe drop + "
                       "recovery)",
            "elastic": "elastic re-partition 8 -> 4 workers",
            "mesh elastic": "elastic re-partition 4 -> 2 workers",
            "ckpt 8": "resumed from round 4"}
    for name in ("uninterrupted 8", "failure", "elastic", "mesh elastic",
                 "ckpt 8"):
        outs[name] = _finish(f"cocoa_train {name}", cli[name], 19)
    for name, out in outs.items():
        log(f"  cli {name}: " + " | ".join(
            ln for ln in out.splitlines()
            if ln.startswith(("resumed", "simulating", "elastic", "round ",
                              "final: rounds"))))
        if name in want and want[name] not in out:
            fail(f"phase 19: cli {name} did not print {want[name]!r}")
    resumed, full = _cli_final(outs["ckpt 8"]), _cli_final(
        outs["uninterrupted 8"])
    gap = lambda line: line.split("gap=")[1].split()[0]
    if not resumed or not full or gap(resumed[0]) != gap(full[0]):
        fail(f"phase 19: the resumed CLI run's final gap {resumed} differs "
             f"from the uninterrupted run's {full}")
    tmp.cleanup()
    took = time.perf_counter() - t_start
    log(f"  phase 19 took {took:.1f} s")
    return {**restart, **drop, **resplit, "fig2": fig2, "s": took}


# ----------------------------------------------------------------------------
# the eleventh slice (phase 20): training stablelm-1.6b, and CoCoA-DP on it
# ----------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 2_048    # phase 20's batch: 8,192 tokens
TRAIN_STEPS = 6                # 1 cold step and 5 warm ones
TRAIN_LR = 3e-4
# AdamW's bytes a parameter: float32 master, m and v read and written,
# the bf16 grad read, the bf16 param written
ADAMW_BYTES = 28
ADAMW_CHECKED = ("final_norm.g", "blocks.0.attn.wq")
ADAMW_RTOL = 1e-6              # the masters against a float64 update
REMAT_LAYERS = 2               # the remat check's cut depth
REMAT_GRAD_REL = 1e-3          # remat vs none, grads' relative L2 (the
                               # embedding's backward lands atomics)
LDP_K, LDP_H, LDP_LR = 4, 2, 1e-2
LDP_B, LDP_S = 1, 1_024        # a worker's batch


def _adamw_f64(g, master, m, v, step, gnorm, lr, b1=0.9, b2=0.95,
               eps=1e-8, wd=0.1, clip=1.0):
    """One AdamW update of one leaf in float64: the master after step
    `step` from its grad and the state before it."""
    import torch
    g, master, m, v = (t.double() for t in (g, master, m, v))
    gs = g * min(1.0, clip / max(gnorm, 1e-12))
    m = b1 * m + (1 - b1) * gs
    v = b2 * v + (1 - b2) * gs * gs
    return master - lr * (m / (1 - b1 ** step)
                          / (torch.sqrt(v / (1 - b2 ** step)) + eps)
                          + wd * master)


def _loss_grads(model, batch, cfg):
    """(loss, {name: grad}) of one forward and backward under `cfg`."""
    import torch
    from repro_torch.models import model as M
    model.zero_grad(set_to_none=True)
    loss, _ = M.forward_train(model, batch, cfg)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def _train(dev, cfg):
    """[20 train]: 6 steps of stablelm-1.6b at full width, with every
    check of phase 20's first part but the cut-depth ones."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=SEED, device=dev)
    opt = T.init_opt(model)
    batch = TokenStream(cfg.vocab, TRAIN_B, TRAIN_S,
                        seed=SEED).tensors_at(0, dev)
    n = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_B * TRAIN_S
    hw = _hw(bf16=True)
    bound_ms = n * ADAMW_BYTES / hw.hbm_bw * 1e3
    torch.cuda.synchronize()
    log(f"[20 train] stablelm-1.6b: {cfg.n_layers} layers d_model "
        f"{cfg.d_model} {cfg.n_heads} x {cfg.head_dim} heads d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab} {cfg.dtype}, {n} params (random, "
        f"made with the AdamW state in {time.perf_counter() - t0:.1f} s); "
        f"B={TRAIN_B} S={TRAIN_S}, remat {cfg.remat_policy!r}, "
        f"use_flash_attention={cfg.use_flash_attention}, lr {TRAIN_LR}; "
        f"AdamW bound {n} x {ADAMW_BYTES} B = {n * ADAMW_BYTES / 1e9:.1f} "
        f"GB at {hw.hbm_bw / 1e12:.2f} TB/s = {bound_ms:.1f} ms")
    adamw_events = []

    def timed(real, *args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real(*args, **kw)
        ev[1].record()
        adamw_events.append(ev)
        return out

    losses, steps = [], []
    counts = _counts_zero()
    torch.cuda.reset_peak_memory_stats()
    with _wrapped(T, "adamw_update", timed):
        for step in range(1, TRAIN_STEPS + 1):
            if step == TRAIN_STEPS:
                before = {k: tuple(getattr(opt, leaf)[k].clone()
                                   for leaf in ("master", "m", "v"))
                          for k in ADAMW_CHECKED}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, m = T.train_step(model, opt, batch, cfg=cfg,
                                         lr=TRAIN_LR)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            adamw_ms = adamw_events[-1][0].elapsed_time(adamw_events[-1][1])
            peak = torch.cuda.max_memory_allocated() / 1e9
            losses.append(loss)
            steps.append({"s": sec, "adamw_ms": adamw_ms, "peak_gb": peak})
            log(f"  step {step} ({'cold' if step == 1 else 'warm'}): loss "
                f"{loss:.4f} grad_norm {gnorm:.4f}, {sec:.3f} s, "
                f"{tokens / sec:.0f} tokens/s, peak {peak:.2f} GB, AdamW "
                f"{adamw_ms:.2f} ms ({adamw_ms / bound_ms:.2f}x its "
                f"{bound_ms:.1f} ms bound), 6 N tokens / s = "
                f"{6 * n * tokens / sec / 1e12:.1f} TFLOP/s, "
                f"{6 * n * tokens / sec / hw.peak_flops:.3f} of 989 "
                f"(counting neither attention nor remat)")
    launches = counts()
    with torch.no_grad():
        after = float(M.forward_train(model, batch, cfg)[0])
    log(f"  loss after step {TRAIN_STEPS}: {after:.4f} (step 1: "
        f"{losses[0]:.4f}); kernel launches on the training path: "
        f"{launches}")
    if not all(math.isfinite(x) for x in losses + [after]):
        fail(f"phase 20: a loss is not finite: {losses}, after {after}")
    if not after < losses[0]:
        fail(f"phase 20: the loss did not fall: {losses[0]} -> {after}")
    if any(launches.values()):
        fail(f"phase 20: the training path launched a kernel: {launches}")
    named = dict(model.named_parameters())
    missing = [k for k, p in named.items() if p.grad is None]
    zero = [k for k, p in named.items()
            if p.grad is not None and not bool(p.grad.any())]
    if missing or zero:
        fail(f"phase 20: no gradient for {missing}, all-zero for {zero}")
    gnorm64 = math.sqrt(sum(float(p.grad.double().square().sum())
                            for p in named.values()))
    errs = {}
    for k in ADAMW_CHECKED:
        want = _adamw_f64(named[k].grad, *before[k], TRAIN_STEPS, gnorm64,
                          TRAIN_LR)
        errs[k] = float((opt.master[k].double() - want).abs().max()
                        / want.abs().max())
    log(f"  every one of {len(named)} parameters has a gradient, none all "
        f"zeros; grad norm in float64 {gnorm64:.6f} (AdamW's float32 "
        f"{float(m['grad_norm']):.6f}); step {TRAIN_STEPS}'s update "
        f"against float64, max |err| / max |master|: "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (limit {ADAMW_RTOL})")
    if any(e > ADAMW_RTOL for e in errs.values()):
        fail(f"phase 20: the AdamW update differs from float64: {errs}")
    return {"params": n, "losses": losses, "after": after, "steps": steps,
            "bound_ms": bound_ms, "launches": launches}


def _remat_and_refusal(dev, cfg):
    """At 2 layers, full width otherwise: remat changes neither the loss
    (bit for bit) nor the grads (relative L2); a step through the flash
    kernel raises its NotImplementedError."""
    import dataclasses
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    cut = dataclasses.replace(cfg, n_layers=REMAT_LAYERS)
    model = M.init_params(cut, seed=SEED, device=dev)
    batch = TokenStream(cfg.vocab, TRAIN_B, TRAIN_S,
                        seed=SEED).tensors_at(0, dev)
    torch.cuda.reset_peak_memory_stats()
    loss0, g0 = _loss_grads(model, batch,
                            dataclasses.replace(cut, remat=False))
    peak0 = torch.cuda.max_memory_allocated() / 1e9
    g0 = {k: g.clone() for k, g in g0.items()}
    for policy in ("nothing", "dots"):
        torch.cuda.reset_peak_memory_stats()
        loss1, g1 = _loss_grads(model, batch, dataclasses.replace(
            cut, remat=True, remat_policy=policy))
        peak1 = torch.cuda.max_memory_allocated() / 1e9
        rel = max(float((g1[k].float() - g0[k].float()).norm()
                        / g0[k].float().norm()) for k in g0)
        log(f"  remat {policy!r} at {REMAT_LAYERS} layers: loss "
            f"{float(loss1):.6f} vs {float(loss0):.6f} without, equal bit "
            f"for bit: {bool(torch.equal(loss1, loss0))}; grads' largest "
            f"relative L2 {rel:.2e} (limit {REMAT_GRAD_REL}); peak "
            f"{peak1:.2f} GB vs {peak0:.2f} without")
        if not torch.equal(loss1, loss0) or not rel <= REMAT_GRAD_REL:
            fail(f"phase 20: remat {policy!r} changed the loss or grads")
    flash = dataclasses.replace(cut, use_flash_attention=True)
    try:
        T.train_step(model, T.init_opt(model), batch, cfg=flash)
    except NotImplementedError as e:
        if "use_flash_attention=False" not in str(e):
            fail(f"phase 20: the flash refusal does not name its flag: {e}")
        log(f"  a train_step under use_flash_attention raised: {e}")
    else:
        fail("phase 20: a train_step through the flash kernel ran")


def _localdp(dev, cfg):
    """[20 localdp]: one CoCoA-DP round each of adding, averaging and
    adding under int8, K = 4 workers at full width."""
    import numpy as np
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.models import model as M
    from repro_torch.optim import localdp as LDP
    model = M.init_params(cfg, seed=SEED, device=dev)
    loss_fn = LDP.decoder_loss_fn(model)
    shards = [TokenStream(cfg.vocab, LDP_B * LDP_K, LDP_S, seed=SEED,
                          shard=k, shards=LDP_K).batch_at(0)
              for k in range(LDP_K)]
    batches = {key: torch.from_numpy(np.stack(
        [b[key] for b in shards]).astype(np.int64)).to(dev)
        for key in ("tokens", "labels")}
    theta = {n: p.detach() for n, p in model.named_parameters()}

    def mean_loss(params):
        with torch.no_grad():
            return sum(float(loss_fn(params, {k: v[w] for k, v in
                                              batches.items()}))
                       for w in range(LDP_K)) / LDP_K

    l0 = mean_loss(theta)
    kw = dict(H=LDP_H, inner_lr=LDP_LR)
    log(f"[20 localdp] stablelm-1.6b at full width, K={LDP_K} workers in "
        f"turn, H={LDP_H} SGD steps at {LDP_LR}, B={LDP_B} S={LDP_S} a "
        f"worker; mean worker loss at theta {l0:.4f}")
    out = {}
    for name, rule in (("adding", LDP.LocalDPConfig.adding(LDP_K, **kw)),
                       ("averaging", LDP.LocalDPConfig.averaging(LDP_K,
                                                                  **kw)),
                       ("adding int8", LDP.LocalDPConfig.adding(
                           LDP_K, compress="int8", **kw))):
        summed = {}

        def keep_sum(real, *args, **kw):
            d = real(*args, **kw)
            for n, x in d.items():
                if n in summed:
                    summed[n] += x
                else:
                    summed[n] = x.clone()
            return d

        torch.cuda.reset_peak_memory_stats()
        round_fn = LDP.make_round_fn(loss_fn, rule)
        with _wrapped(LDP, "_local_delta", keep_sum):
            ms, st = _sync_ms(lambda: round_fn(LDP.init_state(theta, rule),
                                               batches))
        peak = torch.cuda.max_memory_allocated() / 1e9
        norm = math.sqrt(sum(float(x.float().square().sum())
                             for x in summed.values()))
        moved = math.sqrt(sum(float((st.params[n].float()
                                     - theta[n].float()).square().sum())
                              for n in theta))
        l1 = mean_loss(st.params)
        del summed, st
        log(f"  {name} (gamma {rule.gamma:g}, sigma' "
            f"{rule.resolved_sigma():g}, prox0 {rule.prox0:g}, compress "
            f"{rule.compress}): {ms / 1e3:.3f} s, |sum_k delta_k| "
            f"{norm:.4e}, |theta' - theta| {moved:.4e}, mean worker loss "
            f"{l0:.4f} -> {l1:.4f}, peak {peak:.2f} GB")
        if not all(math.isfinite(x) for x in (norm, moved, l1)):
            fail(f"phase 20: CoCoA-DP {name} gave a value that is not "
                 f"finite")
        out[name] = {"s": ms / 1e3, "norm": norm, "loss": (l0, l1),
                     "peak_gb": peak}
    return out


def phase_train(dev):
    """Phase 20: stablelm-1.6b trained at full width, the cut-depth remat
    and refusal checks, then CoCoA-DP rounds on it."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              use_flash_attention=False, remat=True,
                              remat_policy="nothing")
    train = _train(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    _remat_and_refusal(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    ldp = _localdp(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_start
    log(f"  phase 20 took {took:.1f} s")
    return {"train": train, "localdp": ldp, "s": took}


# ----------------------------------------------------------------------------
# the twelfth slice (phase 21): sliding windows, ring caches and the RG-LRU
# ----------------------------------------------------------------------------

WIN_SLOTS, WIN_S_MAX, WIN_NEW = 4, 4_096, 32    # phase 21's engines
WIN_REQUESTS = 6
WIN_DECODE = 16                # teacher-forced decode steps of a ring check
# float32 ring check: the last decode's logits, and every windowed
# attention layer's output at that position, against a cache-free forward
# over the same tokens, relative RMS. Both sides are float32 without TF32
# and part by sums in another order (~1e-6); a ring write one slot off
# swaps one key of the window. The layers' outputs are checked beside the
# logits because one key of a 2,048-key window moves recurrentgemma's
# single windowed layer at 4 layers by a few percent, but its logits
# perhaps by less than the limit.
RING_F32_REL_RMS = 1e-3
PROMPT_STEP = 128              # prompt lengths are multiples of this: a
                               # prime length makes pick_chunk's query
                               # chunks one token long


def _prompt_lens(rng, lo, hi, window):
    """WIN_REQUESTS prompt lengths in [lo, hi], multiples of PROMPT_STEP:
    the first below `window` when lo < window, the next two above it, the
    last the longest of the range (the prefill the bound is read at), the
    rest anywhere."""
    grid = list(range(lo + (-lo) % PROMPT_STEP, hi + 1, PROMPT_STEP))
    lens = [int(x) for x in rng.choice(grid, size=WIN_REQUESTS)]
    below = [g for g in grid if g < window]
    first = 0
    if below:
        lens[0] = int(rng.choice(below))
        first = 1
    lens[first:first + 2] = [int(x) for x in rng.choice(
        [g for g in grid if g > window], size=2)]
    lens[-1] = grid[-1]
    return lens


def _win_model(dev, cfg, what):
    import torch
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    kinds = [b.mixer if b.window is None else f"{b.mixer}/{b.window}"
             for b in cfg.blocks()]
    log(f"  {what}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}x{cfg.head_dim} heads kv {cfg.n_kv} d_ff {cfg.d_ff} "
        f"vocab {cfg.vocab} {cfg.dtype}, {n} params (random, made in "
        f"{time.perf_counter() - t0:.1f} s); blocks "
        + ", ".join(f"{k} x{kinds.count(k)}" for k in dict.fromkeys(kinds)))
    return model, n


def _win_serve(dev, cfg, model, lens, flash_per_prefill, phase=21):
    """A warm-up engine on the prompts, then the timed engine: every
    request WIN_NEW in-range tokens, flash launched flash_per_prefill
    times a prefill. Returns what was measured."""
    import numpy as np
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.launch.serving_runtime import ServingEngine
    from repro_torch.models import model as M
    stream = TokenStream(cfg.vocab, 1, max(lens), seed=SEED)
    prompts = [stream.batch_at(i)["tokens"][0, :n]
               for i, n in enumerate(lens)]
    log(f"  ServingEngine(slots={WIN_SLOTS}, s_max={WIN_S_MAX}): prompts "
        f"{lens}, {WIN_NEW} new tokens each")
    t0 = time.perf_counter()
    warm = ServingEngine(cfg, model, slots=WIN_SLOTS, s_max=WIN_S_MAX,
                         device=dev)
    for p in prompts:
        warm.submit(p, max_new=2)
    warm.run_until_drained()
    torch.cuda.synchronize()
    log(f"  warm-up engine: {len(prompts)} requests x 2 tokens in "
        f"{time.perf_counter() - t0:.3f} s")
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, model, slots=WIN_SLOTS, s_max=WIN_S_MAX,
                        device=dev)
    reqs = [eng.submit(p, max_new=WIN_NEW) for p in prompts]
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
    if launches["flash_attention"] != flash_per_prefill * len(reqs):
        fail(f"phase {phase}: flash_attention launched "
             f"{launches['flash_attention']} times for {len(reqs)} "
             f"prefills, not {flash_per_prefill} a prefill")
    if any(v for k, v in launches.items() if k != "flash_attention"):
        fail(f"phase {phase}: the serving path launched another kernel: "
             f"{launches}")
    for r, p in zip(reqs, prompts):
        if not (r.done and len(r.out) == WIN_NEW
                and all(0 <= t < cfg.vocab for t in r.out)):
            fail(f"phase {phase}: request {r.rid} (prompt {len(p)}): done="
                 f"{r.done} {len(r.out)} tokens {r.out[:8]}...")
    generated = sum(len(r.out) for r in reqs)
    decode_ms = [ms for n, _, ms in steps if n == 0]
    decode_tok = sum(live for n, live, _ in steps if n == 0)
    log(f"  {len(reqs)} requests done, {generated} tokens in {len(steps)} "
        f"engine steps, {run_s:.3f} s: {generated / run_s:.1f} generated "
        f"tokens/s over the run (prefills included); live per step "
        f"{[live for _, live, _ in steps]}")
    log(f"  decode ms per engine step (steps without a prefill, "
        f"{len(decode_ms)}): mean {sum(decode_ms) / len(decode_ms):.3f} "
        f"min {min(decode_ms):.3f} max {max(decode_ms):.3f}; "
        f"{1e3 * decode_tok / sum(decode_ms):.1f} tokens/s over those "
        f"steps")
    prefill_ms = []
    for p in prompts:
        cache = M.init_cache(cfg, 1, WIN_S_MAX, dev)
        tok = torch.from_numpy(p[None].astype(np.int64)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(model, {"tokens": tok}, cache)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    log("  prefill ms per request (one slot, host clock): " + ", ".join(
        f"S={len(p)}: {ms:.3f}" for p, ms in zip(prompts, prefill_ms)))
    longest = int(np.argmax(lens))
    tok = torch.from_numpy(prompts[longest][None].astype(np.int64)).to(dev)
    busy_prefill = _device_busy_ms(lambda: M.prefill(
        model, {"tokens": tok}, M.init_cache(cfg, 1, WIN_S_MAX, dev)))
    log(_busy_line(f"prefill S={lens[longest]}", busy_prefill,
                   prefill_ms[longest]))
    toks = torch.ones((WIN_SLOTS, 1), dtype=torch.int64, device=dev)
    pos = max(lens) + WIN_NEW // 2
    busy_decode = _device_busy_ms(lambda: M.decode_step(model, eng.cache,
                                                        toks, pos))
    log(_busy_line(f"decode step ({WIN_SLOTS} slots, pos {pos})",
                   busy_decode, sum(decode_ms) / len(decode_ms)))
    del eng
    return {"launches": launches["flash_attention"], "prefills": len(reqs),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_tokens_s": 1e3 * decode_tok / sum(decode_ms),
            "busy_prefill": busy_prefill, "busy_decode": busy_decode,
            "tok": tok, "prompts": prompts}


def _flash_vs_plain(dev, cfg, model, tok, s_max, flash_per_prefill):
    """One prefill through the flash kernel and the same through the
    plain chunked_attention: the logits' relative RMS, within
    LOGITS_REL_RMS; the kernel launched flash_per_prefill times."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    logits = {}
    for flag in (True, False):
        counts = _counts_zero()
        logits[flag], _ = M.prefill(
            model, {"tokens": tok}, M.init_cache(cfg, 1, s_max, dev),
            dataclasses.replace(cfg, use_flash_attention=flag))
        n = counts()["flash_attention"]
        if n != (flash_per_prefill if flag else 0):
            fail(f"phase 21: a prefill with use_flash_attention={flag} "
                 f"launched flash {n} times")
    rel = _rel_rms(logits[True], logits[False])
    log(f"  prefill logits (S={tok.shape[1]}) flash ({flash_per_prefill} "
        f"launches, the global layers) vs chunked_attention: rel RMS "
        f"{rel:.3e} (limit {LOGITS_REL_RMS}), max |logit| "
        f"{float(logits[False].abs().max()):.3e}")
    if not (torch.isfinite(logits[True]).all() and rel <= LOGITS_REL_RMS):
        fail(f"phase 21: flash prefill logits differ from the plain path: "
             f"{rel}")
    return rel


def _ring_check(dev, cfg, model, seq, P, s_max):
    """Prefill seq[:P] into a 1-slot cache of s_max, decode seq[P:] one
    token a step (teacher-forced), and hold the last decode against a
    cache-free forward over all of seq: (the logits' relative RMS, the
    largest relative RMS of a windowed attention layer's output at the
    last position)."""
    import torch
    from repro_torch.models import model as M
    tok = torch.from_numpy(seq[None].astype("int64")).to(dev)
    outs = []

    def keep(real, blk, h, c, ctx, cache):
        o, cache = real(blk, h, c, ctx, cache)
        if blk.spec.window is not None:
            outs.append(o[:, -1].float())
        return o, cache

    cache = M.init_cache(cfg, 1, s_max, dev)
    M.prefill(model, {"tokens": tok[:, :P]}, cache, cfg)
    with _wrapped(M.AttnBlock, "mix", keep):
        for i in range(P, len(seq)):
            outs.clear()
            last, _ = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        stepped = list(outs)
        outs.clear()
        full, _ = M.prefill(model, {"tokens": tok}, None, cfg)
    del cache
    if not (torch.isfinite(last).all() and torch.isfinite(full).all()):
        fail("phase 21: a ring check's logits are not finite")
    return (_rel_rms(last[:, -1], full[:, -1]),
            max(_rel_rms(a, b) for a, b in zip(stepped, outs)))


def _ring_seq(stream, P):
    return stream.batch_at(99)["tokens"][0, :P + WIN_DECODE]


def _ring_bf16(dev, cfg, model, seq, P, s_max):
    """Phase 21's ring check at full depth in the model's bf16: the logits
    within LOGITS_REL_RMS."""
    W = min(b.window for b in cfg.blocks() if b.window)
    got = _ring_check(dev, cfg, model, seq, P, s_max)
    log(f"  ring check, {cfg.n_layers} layers {cfg.dtype}: prompt {P} "
        f"(window {W}: the ring wrapped), {WIN_DECODE} decode steps, the "
        f"last one's logits vs a cache-free forward over {len(seq)} "
        f"tokens: rel RMS {got[0]:.3e} (limit {LOGITS_REL_RMS}); windowed "
        f"layers' outputs, largest rel RMS {got[1]:.3e}")
    if not got[0] <= LOGITS_REL_RMS:
        fail(f"phase 21: ring decode differs from the cache-free forward: "
             f"{got}")
    return got


def _ring_f32(dev, cfg, seq, P, s_max, layers):
    """Phase 21's ring check at `layers` layers in float32 (full width):
    the ring write right (within RING_F32_REL_RMS) and planted one slot
    off, (pos + 1) mod W, which must fail. Call with the card's memory
    free of the bf16 model."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    c32 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    model, _ = _win_model(dev, c32, f"float32 at {layers} layers")
    right = _ring_check(dev, c32, model, seq, P, s_max)
    with _wrapped(M, "ring_slot", lambda real, pos, w: real(pos + 1, w)):
        planted = _ring_check(dev, c32, model, seq, P, s_max)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  ring check, {layers} layers float32: logits rel RMS "
        f"{right[0]:.3e}, windowed layers' outputs largest {right[1]:.3e} "
        f"(limit {RING_F32_REL_RMS} each); the ring write planted one slot "
        f"off, (pos + 1) mod W: logits {planted[0]:.3e}, layers' outputs "
        f"{planted[1]:.3e}")
    if not max(right) <= RING_F32_REL_RMS:
        fail(f"phase 21: float32 ring decode differs from the cache-free "
             f"forward: {right}")
    if not max(planted) > RING_F32_REL_RMS:
        fail(f"phase 21: the ring check does not see a write one slot off: "
             f"{planted}")
    return {"f32": right, "planted": planted}


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _windows_gemma3(dev):
    """[21a] gemma3-27b at full width and depth: the engine, flash on its
    10 global layers only, the ring checks (bf16 full depth, float32 at 8
    layers)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    cfg = dataclasses.replace(get_config("gemma3-27b"),
                              use_flash_attention=True)
    n_global = sum(1 for b in cfg.blocks() if b.window is None)
    log("[21a windows] gemma3-27b at full width and depth")
    model, n = _win_model(dev, cfg, "gemma3-27b")
    torch.cuda.reset_peak_memory_stats()
    lens = _prompt_lens(np.random.default_rng(SEED), 512, 3_000, 1_024)
    out = _win_serve(dev, cfg, model, lens, n_global)
    out["rel_flash"] = _flash_vs_plain(dev, cfg, model, out.pop("tok"),
                                       WIN_S_MAX, n_global)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak {out['peak_gb']:.2f} GB after the weights were made ({n} "
        f"params)")
    seq = _ring_seq(TokenStream(cfg.vocab, 1, 1_500 + WIN_DECODE,
                                seed=SEED), 1_500)
    out["ring_bf16"] = _ring_bf16(dev, cfg, model, seq, 1_500, WIN_S_MAX)
    del model
    _free()
    out.update(_ring_f32(dev, cfg, seq, 1_500, WIN_S_MAX, 8))
    return out


def _windows_recurrentgemma(dev):
    """[21b] recurrentgemma-9b at full width and depth: the engine (flash
    never launched: every attention block is windowed), the scoring
    forward at B 1 x S 4,096, the ring checks (bf16 full depth, float32
    at 4 layers)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              use_flash_attention=True)
    log("[21b windows] recurrentgemma-9b at full width and depth")
    model, n = _win_model(dev, cfg, "recurrentgemma-9b")
    torch.cuda.reset_peak_memory_stats()
    lens = _prompt_lens(np.random.default_rng(SEED + 1), 1_024, 3_000,
                        2_048)
    out = _win_serve(dev, cfg, model, lens, 0)
    del out["tok"]
    batch = TokenStream(cfg.vocab, 1, WIN_S_MAX, seed=SEED).tensors_at(0, dev)
    with torch.no_grad():
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(M.forward_train(model, batch, cfg)[0])
            secs.append(time.perf_counter() - t0)
    out["score_s"] = secs
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  scoring forward (forward_train, no grad) B=1 S={WIN_S_MAX}: "
        f"loss {loss:.4f} (ln vocab {math.log(cfg.vocab):.4f}), cold "
        f"{secs[0]:.3f} s, warm {secs[1]:.3f} s; peak {out['peak_gb']:.2f} "
        f"GB ({n} params)")
    if not math.isfinite(loss):
        fail(f"phase 21: recurrentgemma's scoring loss is {loss}")
    seq = _ring_seq(TokenStream(cfg.vocab, 1, 2_500 + WIN_DECODE,
                                seed=SEED), 2_500)
    out["ring_bf16"] = _ring_bf16(dev, cfg, model, seq, 2_500, WIN_S_MAX)
    del model, batch
    _free()
    out.update(_ring_f32(dev, cfg, seq, 2_500, WIN_S_MAX, 4))
    return out


GEMMA2_LAYERS = 4              # phase 21c's cut depth: two periods
GEMMA2_PROMPT = 4_500          # past gemma2's 4,096 window


def _windows_gemma2(dev):
    """[21c] gemma2-27b at full width, 4 layers: a 4,500-token prompt
    past the 4,096 window (the rolled prefill at the real window), flash
    on the 2 global layers against the plain path, the ring checks."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    cfg = dataclasses.replace(get_config("gemma2-27b"),
                              n_layers=GEMMA2_LAYERS,
                              use_flash_attention=True)
    s_max = GEMMA2_PROMPT + WIN_DECODE + 92      # 4,608
    log(f"[21c windows] gemma2-27b at full width, {GEMMA2_LAYERS} layers")
    model, _ = _win_model(dev, cfg, "gemma2-27b")
    stream = TokenStream(cfg.vocab, 1, GEMMA2_PROMPT + WIN_DECODE,
                         seed=SEED)
    tok = torch.from_numpy(stream.batch_at(0)["tokens"][:, :GEMMA2_PROMPT]
                           .astype("int64")).to(dev)
    out = {"rel_flash": _flash_vs_plain(dev, cfg, model, tok, s_max, 2),
           "launches": 2}
    seq = _ring_seq(stream, GEMMA2_PROMPT)
    out["ring_bf16"] = _ring_bf16(dev, cfg, model, seq, GEMMA2_PROMPT, s_max)
    del model
    _free()
    out.update(_ring_f32(dev, cfg, seq, GEMMA2_PROMPT, s_max,
                         GEMMA2_LAYERS))
    return out


def phase_windows(dev, rows):
    """Phase 21: gemma3-27b and recurrentgemma-9b served at full width and
    depth, gemma2-27b at full width and 4 layers, each with its ring
    checks; the flash row's launches take in the serving paths'."""
    t_start = time.perf_counter()
    _free()
    out = {}
    for arch, part in (("gemma3-27b", _windows_gemma3),
                       ("recurrentgemma-9b", _windows_recurrentgemma),
                       ("gemma2-27b", _windows_gemma2)):
        out[arch] = part(dev)
        _free()
    launches = {k: v["launches"] for k, v in out.items()}
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches"] += sum(launches.values())
            row["launches_phase21"] = launches
    took = time.perf_counter() - t_start
    log(f"  flash launches on phase 21's paths: {launches}; phase 21 took "
        f"{took:.1f} s")
    return out


# ----------------------------------------------------------------------------
# the thirteenth slice (phase 22): MoE (llama4) and M-RoPE with embedding
# inputs (qwen2-vl)
# ----------------------------------------------------------------------------

SCOUT_LAYERS = 12              # of 48: 28.5 B bf16 weights, 57.0 GB
MAVERICK_LAYERS = 3            # dense, MoE, dense: one period + the rest
SCORE_S = 4_096                # the scoring forwards' sequence
# the dispatch check: one scout MoE layer at full width in float32 (no
# TF32) against the same layer in float64, both on the card, at
# (tokens, capacity_factor); 4 tokens is a 4-slot decode step, C = 1
DISPATCH_CASES = ((1_024, 1.25), (1_024, 1.0), (4, 1.25))
DISPATCH_REL_RMS = 1e-5
VL_PROMPT = 2_048              # qwen2-vl's prefill: 256 text positions,
VL_TEXT, VL_GRID = 256, 42     # a 42 x 42 patch grid, then text
VL_NEW = 32                    # greedy tokens decoded through serve_step
VL_F32_LAYERS = 4
VL_F32_REL_RMS = 1e-3          # float32 cache check, logits' relative RMS


def _moe_routes(seen):
    """An `around` for `layers.moe_route` that keeps each call's routes."""
    def around(real, p, xt, cfg):
        out = real(p, xt, cfg)
        seen.append(out)
        return out
    return around


def _moe_prefill(dev, cfg, model, tok, s_max, flash, n_flash, around):
    """One prefill's last logits, use_flash_attention=`flash`, its
    `layers.moe_route` calls going through `around`; flash launched
    n_flash times (0 without it)."""
    import dataclasses
    from repro_torch.models import layers as L, model as M
    counts = _counts_zero()
    with _wrapped(L, "moe_route", around):
        logits, _ = M.prefill(
            model, {"tokens": tok}, M.init_cache(cfg, 1, s_max, dev),
            dataclasses.replace(cfg, use_flash_attention=flash))
    n = counts()["flash_attention"]
    if n != (n_flash if flash else 0):
        fail(f"phase 22: a prefill with use_flash_attention={flash} "
             f"launched flash {n} times")
    return logits


def _f32_attention(real, q, k, v, positions, **kw):
    """An `around` for `layers.chunked_attention`: the same attention with
    q, k, v and the probabilities in float32, its output rounded to bf16
    once. It differs from the bf16 plain path by rounding alone."""
    return real(q.float(), k.float(), v.float(), positions,
                **kw).to(v.dtype)


def _route_flips(ra, rb):
    """Per MoE layer: (share of tokens whose expert differs, whether the
    last position's does)."""
    return [(float((a[0] != b[0]).float().mean()), bool(a[0][-1] != b[0][-1]))
            for a, b in zip(ra, rb)]


def _moe_flash_vs_plain(dev, cfg, model, tok, s_max, n_flash):
    """The longest prefill through the flash kernel and through the plain
    chunked_attention, each routing by its own router logits: the share
    of tokens whose expert differs, per MoE layer, and the logits'
    relative RMS, printed. A top-1 route is a step function of the
    logits, so a bf16 rounding that flips a near tie changes that token's
    output wholesale, and the change reaches later tokens through the
    attention. The witness that rounding alone does this: the plain
    prefill again with its attention in float32 (`_f32_attention`),
    printed the same way against the bf16 plain prefill. The check is
    the plain prefill given the flash prefill's routes (expert, gate,
    slot, keep) layer by layer: its logits within LOGITS_REL_RMS of the
    flash prefill's."""
    import torch
    from repro_torch.models import layers as L
    routes_f, routes_p, routes_32 = [], [], []
    flash = _moe_prefill(dev, cfg, model, tok, s_max, True, n_flash,
                         _moe_routes(routes_f))
    plain = _moe_prefill(dev, cfg, model, tok, s_max, False, n_flash,
                         _moe_routes(routes_p))
    with _wrapped(L, "chunked_attention", _f32_attention):
        plain32 = _moe_prefill(dev, cfg, model, tok, s_max, False, n_flash,
                               _moe_routes(routes_32))
    pairs = {"flash vs plain": (routes_f, routes_p, flash, plain),
             "plain vs plain with float32 attention": (
                 routes_p, routes_32, plain, plain32),
             "flash vs plain with float32 attention": (
                 routes_f, routes_32, flash, plain32)}
    free = {}
    for what, (ra, rb, la, lb) in pairs.items():
        flips = _route_flips(ra, rb)
        free[what] = {"flips": flips, "rel": _rel_rms(la, lb)}
        log(f"  routes, {what} prefill (S={tok.shape[1]}): share of tokens "
            f"whose expert differs, per MoE layer (* where the last "
            f"position's differs): " + ", ".join(
                f"{f:.4f}{'*' if last else ''}" for f, last in flips)
            + f"; logits rel RMS {free[what]['rel']:.3e}")
    given = iter(routes_f)
    pinned = _moe_prefill(dev, cfg, model, tok, s_max, False, n_flash,
                          lambda real, p, xt, c: next(given))
    rel = _rel_rms(flash, pinned)
    log(f"  prefill logits (S={tok.shape[1]}) flash ({n_flash} launches) "
        f"vs chunked_attention on the flash prefill's routes: rel RMS "
        f"{rel:.3e} (limit {LOGITS_REL_RMS}), max |logit| "
        f"{float(pinned.abs().max()):.3e}")
    if not (torch.isfinite(flash).all() and rel <= LOGITS_REL_RMS):
        fail(f"phase 22: flash prefill logits differ from the plain path "
             f"on the same routes: {rel}")
    return {"rel": rel, "free": free}


def _decode_drops(dev, cfg, model, prompts):
    """The engine again on the same prompts, each MoE call's dropped
    tokens counted in the decode steps (all WIN_SLOTS slots, dead ones
    included, in one dispatch group): drops per decode step over the MoE
    layers, summed, and the steps' live counts."""
    import torch
    from repro_torch.launch.serving_runtime import ServingEngine
    from repro_torch.models import layers as L
    eng = ServingEngine(cfg, model, slots=WIN_SLOTS, s_max=WIN_S_MAX,
                        device=dev)
    for p in prompts:
        eng.submit(p, max_new=WIN_NEW)
    step = []

    def around(real, p, xt, c):
        out = real(p, xt, c)
        if xt.shape[0] == WIN_SLOTS:
            step.append(torch.sum(~out[3]))
        return out
    drops, lives = [], []
    with _wrapped(L, "moe_route", around):
        while True:
            step.clear()
            live = eng.step()
            if live == 0 and not eng.queue:
                break
            drops.append(int(sum(step)) if step else 0)
            lives.append(live)
    C = L.moe_capacity(WIN_SLOTS, cfg)
    log(f"  decode drops per engine step ({WIN_SLOTS} slots, dead ones "
        f"included, C = {C} a step, summed over the MoE layers): {drops} "
        f"(live {lives})")
    del eng
    return drops


def _moe_score(dev, cfg, model, batch, what):
    """The scoring forward under no_grad, cold and warm: loss, xent and
    aux finite, loss = xent + 0.01 aux to float32's rounding."""
    import torch
    from repro_torch.models import model as M
    secs = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, m = M.forward_train(model, batch, cfg)
            loss, xent, aux = float(loss), float(m["xent"]), float(
                m["moe_aux"])
            secs.append(time.perf_counter() - t0)
    log(f"  scoring forward {what} B=1 S={SCORE_S}: loss {loss:.6f} = xent "
        f"{xent:.6f} + 0.01 aux {aux:.6f} (ln vocab "
        f"{math.log(cfg.vocab):.4f}); cold {secs[0]:.3f} s, warm "
        f"{secs[1]:.3f} s")
    if not all(math.isfinite(v) for v in (loss, xent, aux)):
        fail(f"phase 22: {what} scoring gives loss {loss} xent {xent} aux "
             f"{aux}")
    if not math.isclose(loss, xent + 0.01 * aux, rel_tol=1e-6):
        fail(f"phase 22: {what} loss {loss} is not xent + 0.01 aux "
             f"{xent + 0.01 * aux}")
    return {"loss": loss, "xent": xent, "aux": aux, "score_s": secs}


def _params_as(p, dtype):
    """A copy of a `layers.Params` group with every weight in `dtype`."""
    from repro_torch.models import layers as L
    return L.Params(**{**{n: w.detach().to(dtype)
                          for n, w in p._parameters.items()},
                       **{n: _params_as(m, dtype)
                          for n, m in p._modules.items()}})


def _dispatch_once(cfg, p32, p64, x, planted):
    """One MoE layer in float32 and float64 on x: (expert ids equal, keep
    masks equal, output rel RMS, drops in float64, smallest top-1/top-2
    logit gap). `planted` gives the float32 run capacity C + 1."""
    import torch
    from repro_torch.models import layers as L
    seen = []
    with _wrapped(L, "moe_route", _moe_routes(seen)):
        if planted:
            with _wrapped(L, "moe_capacity",
                          lambda real, Tg, c: real(Tg, c) + 1):
                out32, aux32 = L.moe_forward(p32, x, cfg, cfg.d_ff)
        else:
            out32, aux32 = L.moe_forward(p32, x, cfg, cfg.d_ff)
        out64, aux64 = L.moe_forward(p64, x.double(), cfg, cfg.d_ff)
    (e32, _, _, k32, _), (e64, _, _, k64, prob) = seen
    top2 = torch.topk(torch.log(prob), 2, dim=-1).values
    return (bool(torch.equal(e32, e64)), bool(torch.equal(k32, k64)),
            _rel_rms(out32.double(), out64),
            int((~k64).sum()), float((top2[..., 0] - top2[..., 1]).min()),
            abs(float(aux32) - float(aux64)) / float(aux64))


def _dispatch_check(dev):
    """[22a] The dispatch check: scout's MoE layer at full width (16
    experts, d 5,120, d_ff 8,192, the shared expert) in float32 against
    float64 on the card, routes equal and outputs within
    DISPATCH_REL_RMS at each DISPATCH_CASES; capacity C + 1 planted where
    tokens drop must fail it."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("llama4-scout-17b-a16e")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.no_grad():
        p32 = L.init_moe(gen, cfg, cfg.d_ff, torch.float32)
        p64 = _params_as(p32, torch.float64)
        rng = np.random.default_rng(SEED)
        out = []
        for T, cf in DISPATCH_CASES:
            c = dataclasses.replace(cfg, capacity_factor=cf)
            x = _rand(rng, (1, T, cfg.d_model), dev)
            right = _dispatch_once(c, p32, p64, x, planted=False)
            C = L.moe_capacity(T, c)
            log(f"  dispatch T={T} cf={cf} (C={C}): ids equal {right[0]}, "
                f"keep equal {right[1]}, out rel RMS {right[2]:.3e} (limit "
                f"{DISPATCH_REL_RMS}), aux rel {right[5]:.3e}, {right[3]} of "
                f"{T} dropped, smallest top-1/top-2 log-prob gap "
                f"{right[4]:.3e}")
            if not (right[0] and right[1] and right[2] <= DISPATCH_REL_RMS):
                fail(f"phase 22: float32 dispatch differs from float64 at "
                     f"T={T} cf={cf}: {right}")
            planted = None
            if right[3]:
                planted = _dispatch_once(c, p32, p64, x, planted=True)
                log(f"    planted C + 1 = {C + 1}: ids equal {planted[0]}, "
                    f"keep equal {planted[1]}, out rel RMS "
                    f"{planted[2]:.3e}")
                if planted[1] and planted[2] <= DISPATCH_REL_RMS:
                    fail(f"phase 22: the dispatch check does not see "
                         f"capacity C + 1 at T={T} cf={cf}: {planted}")
            out.append({"T": T, "cf": cf, "C": C, "right": right,
                        "planted": planted})
    if not any(o["planted"] for o in out):
        fail("phase 22: no dispatch case dropped a token; the planted "
             "capacity fault was never tried")
    del p32, p64
    _free()
    log(f"  dispatch check took {time.perf_counter() - t0:.1f} s")
    return out


def _moe_serve(dev, arch, layers, seed_off):
    """[22a/b] llama4 at full width and `layers` layers: the engine with
    flash on every layer, the longest prefill flash vs plain with the
    routes, the decode's drops; the init's peak and the serving peak."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              use_flash_attention=True)
    torch.cuda.reset_peak_memory_stats()
    model, n = _win_model(dev, cfg, arch)
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    resident = torch.cuda.memory_allocated() / 1e9
    log(f"  init peak {init_gb:.2f} GB for {resident:.2f} GB resident "
        f"({n} params, experts drawn one at a time)")
    torch.cuda.reset_peak_memory_stats()
    # multiples of 128 in [512, 2,944], the last the longest (1,024 only
    # spreads the draws: no block is windowed)
    lens = _prompt_lens(np.random.default_rng(SEED + seed_off), 512, 2_944,
                        1_024)
    out = _win_serve(dev, cfg, model, lens, layers, phase=22)
    out["flash_vs_plain"] = _moe_flash_vs_plain(
        dev, cfg, model, out.pop("tok"), WIN_S_MAX, layers)
    out["drops"] = _decode_drops(dev, cfg, model, out.pop("prompts"))
    out["init_gb"], out["n"] = init_gb, n
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  serving peak {out['peak_gb']:.2f} GB")
    return cfg, model, out


def _moe_scout(dev):
    """[22a] llama4-scout at full width, SCOUT_LAYERS layers: the engine,
    the scoring forward at B 1 x S 4,096, then the dispatch check."""
    from repro_torch.data import TokenStream
    log(f"[22a moe] llama4-scout-17b-a16e at full width, {SCOUT_LAYERS} "
        f"of 48 layers")
    cfg, model, out = _moe_serve(dev, "llama4-scout-17b-a16e",
                                 SCOUT_LAYERS, 2)
    batch = TokenStream(cfg.vocab, 1, SCORE_S, seed=SEED).tensors_at(0, dev)
    out.update(_moe_score(dev, cfg, model, batch, "scout"))
    del model, batch
    _free()
    out["dispatch"] = _dispatch_check(dev)
    return out


def _moe_maverick(dev):
    """[22b] llama4-maverick at full width, MAVERICK_LAYERS layers (dense
    16,384, MoE of 128 experts, dense): the engine."""
    log(f"[22b moe] llama4-maverick-400b-a17b at full width, "
        f"{MAVERICK_LAYERS} of 48 layers")
    _, model, out = _moe_serve(dev, "llama4-maverick-400b-a17b",
                               MAVERICK_LAYERS, 3)
    del model
    return out


def _vl_positions(S, dev):
    """qwen2-vl's (3, 1, S) streams: VL_TEXT text positions (all three
    equal), a VL_GRID x VL_GRID patch grid (temporal constant, height and
    width along the grid), then text from the largest position + 1."""
    import torch
    t = torch.arange(VL_TEXT)
    cell = torch.arange(VL_GRID ** 2)
    row, col = cell // VL_GRID, cell % VL_GRID
    after = VL_TEXT + VL_GRID + torch.arange(S - VL_TEXT - VL_GRID ** 2)
    streams = torch.stack([
        torch.cat([t, torch.full_like(cell, VL_TEXT), after]),
        torch.cat([t, VL_TEXT + row, after]),
        torch.cat([t, VL_TEXT + col, after])])
    return streams[:, None].to(torch.int32).to(dev)


def _vl_cache_check(dev, cfg, model, emb, pos, toks):
    """Prefill the embeddings, decode `toks` one a step (teacher-forced),
    and hold the last step's logits against a cache-free prefill over the
    prompt's embeddings and the token table's rows of `toks`, at
    positions P.. on all three streams: the logits' relative RMS."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    P, n = emb.shape[1], toks.shape[1]
    cache = M.init_cache(cfg, 1, P + n, dev)
    serve.prefill_step(model, {"embeds": emb, "positions": pos}, cache,
                       cfg=cfg)
    for i in range(n):
        last, _ = M.decode_step(model, cache, toks[:, i:i + 1], P + i, cfg)
    del cache
    with torch.no_grad():
        tail = model.embed.tok[toks[0]][None].to(emb.dtype)
    full_pos = torch.cat(
        [pos, torch.arange(P, P + n, dtype=pos.dtype, device=dev)
         .expand(3, 1, n)], dim=-1)
    full, _ = M.prefill(model, {"embeds": torch.cat([emb, tail], dim=1),
                                "positions": full_pos}, None, cfg)
    if not (torch.isfinite(last).all() and torch.isfinite(full).all()):
        fail("phase 22: qwen2-vl's cache check logits are not finite")
    return _rel_rms(last[:, -1], full[:, -1])


def _vl(dev):
    """[22c] qwen2-vl-7b at full width and depth from random embeddings
    with M-RoPE streams: prefill and greedy decode through `launch.serve`
    (flash never launched: 3-D positions), the cache checks (bf16 at full
    depth, float32 at VL_F32_LAYERS), the scoring forward at S 4,096."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("qwen2-vl-7b"),
                              use_flash_attention=True)
    log("[22c vlm] qwen2-vl-7b at full width and depth, embeddings with "
        f"M-RoPE {cfg.mrope_sections}")
    torch.cuda.reset_peak_memory_stats()
    model, n = _win_model(dev, cfg, "qwen2-vl-7b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb32 = torch.randn((1, VL_PROMPT + WIN_DECODE, cfg.d_model),
                        generator=gen, device=dev)
    emb = emb32[:, :VL_PROMPT].to(torch.bfloat16)
    pos = _vl_positions(VL_PROMPT, dev)
    batch = {"embeds": emb, "positions": pos}
    s_max = VL_PROMPT + VL_NEW
    counts = _counts_zero()
    prefill_ms = []
    for _ in range(2):                       # cold, then warm
        cache = M.init_cache(cfg, 1, s_max, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = serve.prefill_step(model, batch, cache)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out_toks, decode_ms = [int(nxt)], []
    for i in range(VL_NEW - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = serve.serve_step(model, cache, nxt, VL_PROMPT + i)
        out_toks.append(int(nxt))
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    launches = counts()
    log(f"  launches on the path: {launches}")
    if any(launches.values()):
        fail(f"phase 22: qwen2-vl's path launched a kernel: {launches}")
    if not all(0 <= t < cfg.vocab for t in out_toks):
        fail(f"phase 22: qwen2-vl decoded {out_toks}")
    warm = decode_ms[1:]
    log(f"  prefill S={VL_PROMPT} (text {VL_TEXT}, grid {VL_GRID}x{VL_GRID}"
        f", text {VL_PROMPT - VL_TEXT - VL_GRID ** 2}): cold "
        f"{prefill_ms[0]:.3f} ms, warm {prefill_ms[1]:.3f} ms; {VL_NEW} "
        f"greedy tokens {out_toks[:8]}...; decode ms a step (B=1, warm "
        f"{len(warm)}): mean {sum(warm) / len(warm):.3f} min "
        f"{min(warm):.3f} max {max(warm):.3f}, "
        f"{1e3 * len(warm) / sum(warm):.1f} tokens/s")
    busy_prefill = _device_busy_ms(lambda: serve.prefill_step(
        model, batch, M.init_cache(cfg, 1, s_max, dev)))
    log(_busy_line(f"prefill S={VL_PROMPT}", busy_prefill, prefill_ms[1]))
    busy_decode = _device_busy_ms(lambda: M.decode_step(
        model, cache, nxt, VL_PROMPT + VL_NEW - 1))
    log(_busy_line("decode step (B=1)", busy_decode,
                   sum(warm) / len(warm)))
    del cache
    toks = torch.from_numpy(TokenStream(cfg.vocab, 1, WIN_DECODE, seed=SEED)
                            .batch_at(5)["tokens"].astype("int64")).to(dev)
    bf16 = _vl_cache_check(dev, cfg, model, emb, pos, toks)
    log(f"  cache check, {cfg.n_layers} layers bf16: prefill {VL_PROMPT}, "
        f"{WIN_DECODE} teacher-forced decode steps, the last one's logits "
        f"vs a cache-free prefill over {VL_PROMPT + WIN_DECODE} embeddings: "
        f"rel RMS {bf16:.3e} (limit {LOGITS_REL_RMS})")
    if not bf16 <= LOGITS_REL_RMS:
        fail(f"phase 22: qwen2-vl decode differs from the cache-free "
             f"prefill: {bf16}")
    labels = TokenStream(cfg.vocab, 1, SCORE_S, seed=SEED).tensors_at(
        0, dev)["labels"]
    score_batch = {"embeds": torch.randn((1, SCORE_S, cfg.d_model),
                                         generator=gen, device=dev).to(
                                             torch.bfloat16),
                   "positions": _vl_positions(SCORE_S, dev),
                   "labels": labels}
    score = _moe_score(dev, cfg, model, score_batch, "qwen2-vl")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak {peak:.2f} GB ({n} params)")
    del model, score_batch
    _free()
    c32 = dataclasses.replace(cfg, n_layers=VL_F32_LAYERS, dtype="float32")
    model32, _ = _win_model(dev, c32, f"float32 at {VL_F32_LAYERS} layers")
    f32 = _vl_cache_check(dev, c32, model32, emb32[:, :VL_PROMPT], pos, toks)
    log(f"  cache check, {VL_F32_LAYERS} layers float32: rel RMS {f32:.3e} "
        f"(limit {VL_F32_REL_RMS})")
    if not f32 <= VL_F32_REL_RMS:
        fail(f"phase 22: float32 qwen2-vl decode differs from the "
             f"cache-free prefill: {f32}")
    del model32
    return {"launches": 0, "prefill_ms": prefill_ms, "decode_ms": warm,
            "busy_prefill": busy_prefill, "busy_decode": busy_decode,
            "cache_bf16": bf16, "cache_f32": f32, "peak_gb": peak, **score}


def phase_moe(dev, rows):
    """Phase 22: llama4-scout (12 layers) and llama4-maverick (3 layers)
    served at full width, with the dispatch check; qwen2-vl-7b at full
    width and depth from embeddings; the flash row's launches take in the
    llama4 serving paths'."""
    t_start = time.perf_counter()
    _free()
    out = {}
    for arch, part in (("llama4-scout-17b-a16e", _moe_scout),
                       ("llama4-maverick-400b-a17b", _moe_maverick),
                       ("qwen2-vl-7b", _vl)):
        t0 = time.perf_counter()
        out[arch] = part(dev)
        _free()
        log(f"  {arch} took {time.perf_counter() - t0:.1f} s")
    launches = {k: v["launches"] for k, v in out.items()}
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches"] += sum(launches.values())
            row["launches_phase22"] = launches
    took = time.perf_counter() - t_start
    log(f"  flash launches on phase 22's paths: {launches}; phase 22 took "
        f"{took:.1f} s")
    return out


# ----------------------------------------------------------------------------
# phase 23: the encoder-decoder (whisper-large-v3)
# ----------------------------------------------------------------------------

WH_STREAMS = 4                 # streams served at once
WH_FRAMES = 1_500              # a 30-second window: 10 ms hops, halved by
                               # the stride-2 conv (arXiv:2212.04356)
WH_PROMPT = 4                  # forced prompt tokens, then greedy
WH_CHECKED = 16                # positions whose logits the cache check reads
WH_F32_LAYERS = 4              # encoder and decoder layers of the float32
                               # cache check
# a cached decode against the cache-free teacher-forced forward, float32
# at full width: the two differ only in the order of float32 sums
WH_F32_REL_RMS = 1e-5
WH_TRAIN_B = 2                 # training: B 2 x 1,500 frames x 448 tokens
WH_TRAIN_STEPS = 3
# from random weights with no warm-up (whisper-large's own peak, 1.75e-4,
# comes after 2,048 warm-up updates: arXiv:2212.04356), AdamW's first
# updates move every weight by ~lr and the loss rises at step 3 at 3e-4
# and 1e-4, in float32 as in bf16 and at 4 to 32 layers a side; at 1e-5
# it falls (tools/whisper_lr_sweep.py). The reference, on the same
# weights at 4 + 4 layers, rises with the port to 2e-6
# (tests/whisper_lr_witness.py --weights port)
WH_TRAIN_LR = 1e-5
# the ValueError a decode step past the decoder's context raises
WH_PAST = "outside the decoder's context"


def _whisper_bounds(cfg, B, T, pos):
    """(prefill FLOP, its bound ms, a decode step's bytes at `pos`, its
    bound ms) for this run's shapes: the prefill's encoder matmuls,
    attention (QK and PV) and cross K/V at 989 TFLOP/s; the decode
    step's decoder weights but the cross wk / wv (the cache holds their
    product), the token table (the logits read all of it), the cross
    cache and the self cache's pos + 1 slots, at 3.35 TB/s."""
    hw = _hw(bf16=True)
    d, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                       cfg.d_ff)
    attn_w = 2 * d * H * hd + 2 * d * KV * hd
    enc = 2 * B * T * (attn_w + 2 * d * F) * cfg.enc_layers
    scores = 2 * 2 * B * H * T * T * hd * cfg.enc_layers
    cross = 2 * B * T * 2 * d * KV * hd * cfg.dec_layers
    flop = enc + scores + cross
    size = 2                                           # bf16 bytes
    norms = 3 * 2 * d
    layer = attn_w + 2 * d * H * hd + 2 * d * F + norms
    weights = (layer * cfg.dec_layers + 2 * d + d + cfg.vocab * d) * size
    caches = cfg.dec_layers * B * KV * hd * size * 2 * (T + pos + 1)
    nbytes = weights + caches
    return (flop, flop / hw.peak_flops * 1e3, nbytes,
            nbytes / hw.hbm_bw * 1e3, {"encoder": enc, "attention": scores,
                                       "cross_kv": cross})


def _whisper_decode(model, cfg, cache, feed, checked):
    """Decode positions 0..MAX_WHISPER_DEC-1 through `serve.serve_step`,
    one step a position, each timed on the host clock after a
    synchronize: the token at pos is feed[:, pos] while pos < feed's
    length, else the last step's greedy token. Returns (the tokens fed
    (B, MAX_WHISPER_DEC), {pos: float32 logits (B, V)} at `checked`,
    step ms, the last greedy tokens)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    seen = {}

    def keep(real, *args):
        logits, c = real(*args)
        if args[3] in checked:
            seen[args[3]] = logits[:, 0]
        return logits, c

    fed, step_ms = [], []
    tok = feed[:, :1]
    with _wrapped(M, "decode_step", keep):
        for pos in range(M.MAX_WHISPER_DEC):
            fed.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt, cache = serve.serve_step(model, cache, tok, pos, cfg=cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tok = feed[:, pos + 1:pos + 2] if pos + 1 < feed.shape[1] else nxt
    return torch.cat(fed, dim=1), seen, step_ms, tok


def _host_speed(dev):
    """What the host's speed at launching work depends on: the objects
    the garbage collector tracks, one full collection's ms, and the host
    µs of one small in-place add (the median of 5 rounds of 1,000, each
    round ended by a synchronize)."""
    import torch
    n = len(gc.get_objects())
    t0 = time.perf_counter()
    gc.collect()
    gc_ms = (time.perf_counter() - t0) * 1e3
    x = torch.zeros(1, device=dev)
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1_000):
            x.add_(1)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
    return n, gc_ms, 1e3 * sorted(rounds)[2]


def _whisper_check(model, cfg, frames, fed, seen):
    """The relative RMS of the cached decode's logits at the checked
    positions against `logits_encdec`, the cache-free teacher-forced
    forward over the same frames and tokens."""
    import torch
    from repro_torch.models import model as M
    at = sorted(seen)
    with torch.no_grad():
        full = M.logits_encdec(model, {"frames": frames, "tokens": fed}, cfg)
    got = torch.stack([seen[p] for p in at], dim=1)
    want = full[:, at]
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("phase 23: a cache check's logits are not finite")
    return _rel_rms(got, want)


def _whisper_f32(dev, cfg, frames32, fed, checked):
    """Phase 23's cache check at WH_F32_LAYERS + WH_F32_LAYERS layers in
    float32, full width: the tokens `fed` teacher-forced, right (within
    WH_F32_REL_RMS) and with stream b's cross K/V served to stream b + 1
    (rolled on the batch axis after the prefill), which must fail."""
    import dataclasses
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    c32 = dataclasses.replace(cfg, enc_layers=WH_F32_LAYERS,
                              dec_layers=WH_F32_LAYERS, dtype="float32")
    model = M.init_params(c32, seed=SEED, device=dev)
    out = {}
    for planted in (False, True):
        cache = M.init_cache(c32, WH_STREAMS, WH_FRAMES, dev)
        _, cache = serve.prefill_step(model, {"frames": frames32}, cache,
                                      cfg=c32)
        if planted:
            cache["cross"] = {k: torch.roll(v, 1, dims=1)
                              for k, v in cache["cross"].items()}
        _, seen, _, _ = _whisper_decode(model, c32, cache, fed, checked)
        del cache
        out[planted] = _whisper_check(model, c32, frames32, fed, seen)
    del model
    _free()
    log(f"  cache check, {WH_F32_LAYERS} + {WH_F32_LAYERS} layers float32 "
        f"at full width: {len(checked)} positions' logits rel RMS "
        f"{out[False]:.3e} (limit {WH_F32_REL_RMS}); stream b's cross K/V "
        f"planted in stream b + 1: {out[True]:.3e}")
    if not out[False] <= WH_F32_REL_RMS:
        fail(f"phase 23: float32 decode differs from the cache-free "
             f"forward: {out[False]}")
    if not out[True] > WH_F32_REL_RMS:
        fail(f"phase 23: the cache check does not see another stream's "
             f"cross K/V: {out[True]}")
    return out


def _whisper_train(dev, cfg, model):
    """[23 train]: WH_TRAIN_STEPS `train_step`s (AdamW, float32 masters)
    of the served model under remat on one repeated batch, B WH_TRAIN_B
    x WH_FRAMES frames x MAX_WHISPER_DEC tokens: the loss must fall."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = TokenStream(cfg.vocab, WH_TRAIN_B, M.MAX_WHISPER_DEC,
                       seed=SEED).tensors_at(0, dev)
    batch = {"frames": torch.randn((WH_TRAIN_B, WH_FRAMES, cfg.d_model),
                                   generator=gen, device=dev).to(
                                       torch.bfloat16), **toks}
    torch.cuda.reset_peak_memory_stats()
    opt = T.init_opt(model)
    counts = _counts_zero()
    losses, secs = [], []
    for step in range(1, WH_TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = T.train_step(model, opt, batch, cfg=cfg,
                                     lr=WH_TRAIN_LR)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        log(f"  train step {step} ({'cold' if step == 1 else 'warm'}): "
            f"loss {losses[-1]:.4f} grad_norm {float(m['grad_norm']):.4f},"
            f" {secs[-1]:.3f} s, {WH_TRAIN_B * M.MAX_WHISPER_DEC / secs[-1]:.0f}"
            f" decoder tokens/s ({WH_TRAIN_B * WH_FRAMES / secs[-1]:.0f} "
            f"frames/s)")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    del opt
    with torch.no_grad():
        after = float(M.forward_train(model, batch, cfg)[0])
    del batch
    log(f"  training: B {WH_TRAIN_B} x {WH_FRAMES} frames x "
        f"{M.MAX_WHISPER_DEC} tokens, remat {cfg.remat}, lr {WH_TRAIN_LR}: "
        f"warm step {min(secs[1:]):.3f}-{max(secs[1:]):.3f} s, peak "
        f"{peak:.2f} GB (AdamW state included); loss after step "
        f"{WH_TRAIN_STEPS} {after:.4f}; launches {launches}")
    if not all(math.isfinite(x) for x in losses + [after]):
        fail(f"phase 23: a training loss is not finite: {losses}, {after}")
    if not (losses[-1] < losses[0] and after < losses[0]):
        fail(f"phase 23: the training loss did not fall: {losses}, after "
             f"{after}")
    if any(launches.values()):
        fail(f"phase 23: the training path launched a kernel: {launches}")
    return {"losses": losses, "after": after, "s": secs, "peak_gb": peak}


def phase_whisper(dev, rows):
    """Phase 23: whisper-large-v3 at full width and depth (random bf16
    weights from the seed, use_flash_attention on, which whisper
    ignores as the reference does): WH_STREAMS streams of WH_FRAMES
    frames through `launch.serve` to the last decoder position, a step
    past it refused; the cache checks (bf16 at full depth, float32 at
    WH_F32_LAYERS + WH_F32_LAYERS layers with a planted fault); training
    steps on the served model. Flash's row records its 0 launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    t_start = time.perf_counter()
    _free()
    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              use_flash_attention=True)
    last = M.MAX_WHISPER_DEC - 1
    flop, pre_bound, nbytes, dec_bound, parts = _whisper_bounds(
        cfg, WH_STREAMS, WH_FRAMES, last)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"[23 whisper] whisper-large-v3: {cfg.enc_layers} + "
        f"{cfg.dec_layers} layers d_model {cfg.d_model} {cfg.n_heads} x "
        f"{cfg.head_dim} heads kv {cfg.n_kv} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab} {cfg.dtype}, {n} params (random, made in "
        f"{time.perf_counter() - t0:.1f} s), remat {cfg.remat}; "
        f"{WH_STREAMS} streams x {WH_FRAMES} frames, {WH_PROMPT} forced "
        f"tokens, greedy to position {last}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames32 = torch.randn((WH_STREAMS, WH_FRAMES, cfg.d_model),
                           generator=gen, device=dev)
    frames = frames32.to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab, (WH_STREAMS, WH_PROMPT),
                           generator=gen, device=dev).to(torch.int32)
    checked = {round(i * last / (WH_CHECKED - 1)) for i in range(WH_CHECKED)}
    counts = _counts_zero()
    prefill_ms = []
    for _ in range(2):                       # cold, then warm
        cache = M.init_cache(cfg, WH_STREAMS, WH_FRAMES, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = serve.prefill_step(model, {"frames": frames}, cache)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if logits.shape != (WH_STREAMS, 1, cfg.vocab) or logits.any():
        fail(f"phase 23: the prefill's logits are not zeros (B, 1, V): "
             f"{tuple(logits.shape)}")
    objects, gc_ms, add_us = _host_speed(dev)
    gc_before = [g["collections"] for g in gc.get_stats()]
    fed, seen, step_ms, tok = _whisper_decode(model, cfg, cache, prompt,
                                              checked)
    gc_runs = [g["collections"] - c
               for g, c in zip(gc.get_stats(), gc_before)]
    try:
        serve.serve_step(model, cache, tok, M.MAX_WHISPER_DEC)
    except ValueError as e:
        refused = str(e)
    else:
        fail(f"phase 23: a decode step at position {M.MAX_WHISPER_DEC} "
             f"ran")
    if WH_PAST not in refused:
        fail(f"phase 23: the step past the context said {refused!r}")
    launches = counts()
    log(f"  launches on the path: {launches}")
    if any(launches.values()):
        fail(f"phase 23: whisper's path launched a kernel: {launches}")
    greedy = fed[:, WH_PROMPT:]
    if not bool(((greedy >= 0) & (greedy < cfg.vocab)).all()):
        fail("phase 23: a greedy token is out of range")
    warm = sorted(step_ms[1:])
    med = warm[len(warm) // 2]
    log(f"  prefill {WH_STREAMS} x {WH_FRAMES} frames (encoder + cross K/V "
        f"of {cfg.dec_layers} layers): cold {prefill_ms[0]:.3f} ms, warm "
        f"{prefill_ms[1]:.3f} ms; bound {flop:.3e} FLOP (encoder "
        f"{parts['encoder']:.3e}, attention {parts['attention']:.3e}, "
        f"cross K/V {parts['cross_kv']:.3e}) at 989 TFLOP/s = "
        f"{pre_bound:.2f} ms")
    log(f"  decode: {len(step_ms)} steps (positions 0..{last}, "
        f"{WH_STREAMS} streams), warm ms a step median {med:.3f} min "
        f"{warm[0]:.3f} max {warm[-1]:.3f}, "
        f"{1e3 * WH_STREAMS * len(warm) / sum(warm):.1f} tokens/s; bound at "
        f"position {last}: {nbytes / 1e9:.3f} GB at 3.35 TB/s = "
        f"{dec_bound:.3f} ms; greedy tokens {greedy[0, :8].tolist()}...; "
        f"position {M.MAX_WHISPER_DEC} refused: {refused}")
    log(f"  host before the decode: {objects} objects tracked by gc, a "
        f"full collection {gc_ms:.1f} ms, a small add {add_us:.2f} us; "
        f"collections during the decode by generation {gc_runs}")
    busy_prefill = _device_busy_ms(lambda: serve.prefill_step(
        model, {"frames": frames},
        M.init_cache(cfg, WH_STREAMS, WH_FRAMES, dev)))
    log(_busy_line(f"prefill {WH_STREAMS} x {WH_FRAMES}", busy_prefill,
                   prefill_ms[1]))
    busy_decode = _device_busy_ms(lambda: M.decode_step(model, cache, tok,
                                                        last))
    log(_busy_line(f"decode step at {last} ({WH_STREAMS} streams)",
                   busy_decode, med))
    bf16 = _whisper_check(model, cfg, frames, fed, seen)
    log(f"  cache check, {cfg.enc_layers} + {cfg.dec_layers} layers bf16: "
        f"the served decode's logits at {len(checked)} positions "
        f"{sorted(checked)[:3]}...{last} vs the cache-free teacher-forced "
        f"forward over the {M.MAX_WHISPER_DEC} tokens fed: rel RMS "
        f"{bf16:.3e} (limit {LOGITS_REL_RMS})")
    if not bf16 <= LOGITS_REL_RMS:
        fail(f"phase 23: whisper's decode differs from the cache-free "
             f"forward: {bf16}")
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  serving peak {serve_peak:.2f} GB ({n} params)")
    del cache, seen, logits
    _free()
    train = _whisper_train(dev, cfg, model)
    del model
    _free()
    f32 = _whisper_f32(dev, cfg, frames32, fed, checked)
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches_phase23"] = {"whisper-large-v3":
                                       launches["flash_attention"]}
    took = time.perf_counter() - t_start
    log(f"  phase 23 took {took:.1f} s")
    return {"prefill_ms": prefill_ms, "decode_ms": warm,
            "busy_prefill": busy_prefill, "busy_decode": busy_decode,
            "cache_bf16": bf16, "cache_f32": f32, "serve_peak_gb": serve_peak,
            "train": train, "s": took}


# ----------------------------------------------------------------------------
# the sixteenth slice (phase 24): the sharded LM steps on a (data 2, model 2)
# process mesh of 4 ranks on cuda:0
# ----------------------------------------------------------------------------

SHARD_MESH = (2, 2)            # (data, model): 4 ranks, all on cuda:0
SHARD_B, SHARD_S = 4, 1_024    # the prefill's, the scoring's and the train
                               # steps' batch
SHARD_DECODE = 8               # teacher-forced decode steps
SHARD_TRAIN_STEPS = 2
SHARD_MAMBA_LAYERS = 4         # falcon-mamba-7b at full width, 4 of 64
SHARD_TIMEOUT = 480            # s for the spawn: start, init, every part
SHARD_LOGITS_REL_RMS = LOGITS_REL_RMS   # bf16: sharded vs one process
SHARD_LOSS_RTOL = 5e-4         # bf16 losses: read 3.8e-5 at most
SHARD_GNORM_RTOL = 2e-2        # bf16 grads summed in another order
SHARD_UPDATE_REL_RMS = 0.2     # every master's update over the steps:
                               # read 8.4e-2; planted faults 0.31-1.4


@contextlib.contextmanager
def _gloo_bytes():
    """Count the bytes this rank hands to DTensor's collectives inside the
    block (`comm.collectives.dtensor_bytes_sent`: every routed
    all-gather, all-reduce and reduce-scatter, a Shard -> Shard
    redistribution's included); yields a one-item list that holds the
    count on the way out."""
    from repro_torch.comm.collectives import dtensor_bytes_sent
    sent, start = [0], dtensor_bytes_sent()
    try:
        yield sent
    finally:
        sent[0] = dtensor_bytes_sent() - start


def _local(t):
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _timed_s(fn):
    """(fn(), its seconds on the host clock, the card synchronized)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _shard_cfgs():
    import dataclasses
    from repro_torch.configs import get_config
    lm = get_config("stablelm-1.6b")
    mamba = dataclasses.replace(get_config("falcon-mamba-7b"),
                                n_layers=SHARD_MAMBA_LAYERS,
                                use_fused_ssm=True)
    return (dataclasses.replace(lm, use_flash_attention=True), lm, mamba)


def _shard_parts(dev, mesh, fed, ref_dir=None):
    """Phase 24's work in one process (`mesh` None) or on this rank of the
    process mesh: stablelm-1.6b prefill (flash) and SHARD_DECODE decode
    steps teacher-forced with `fed` (None: greedy, the tokens returned),
    SHARD_TRAIN_STEPS train steps, falcon-mamba-7b's scoring forward (the
    fused scan; layer 0's scan output kept) and prefill. Each part's
    results, seconds, launches and (on a mesh) gloo bytes; whole tensors
    on the host. Every master's update over the train steps: whole in one
    process; on a mesh, held here to this rank's slices of the
    one-process update in `ref_dir` (`<leaf>.npy`), as the sums of
    squares (difference, one-process) a leaf."""
    import numpy as np
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.launch import serve as SV
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.models import ssm as ssm_mod
    serve_cfg, train_cfg, mamba_cfg = _shard_cfgs()
    batch = TokenStream(serve_cfg.vocab, SHARD_B, SHARD_S,
                        seed=SEED).tensors_at(0, dev)
    out = {}
    nothing = contextlib.nullcontext([0])

    def meter():
        return _gloo_bytes() if mesh is not None else nothing

    # stablelm-1.6b: prefill + decode
    model = M.init_params(serve_cfg, seed=SEED, device=dev)
    cache = M.init_cache(serve_cfg, SHARD_B, SHARD_S + SHARD_DECODE, dev)
    prompt = {"tokens": batch["tokens"]}
    if mesh is None:
        prefill = functools.partial(SV.prefill_step, cfg=serve_cfg)
        decode = functools.partial(SV.serve_step, cfg=serve_cfg)
    else:
        pre, dec = SV.make_jitted_serve_fns(serve_cfg, mesh, "serve")
        prefill, decode = pre(cache, prompt), dec(cache)
    counts = _counts_zero()
    with meter() as sent:
        (logits, cache), s = _timed_s(lambda: prefill(model, prompt, cache))
    out["prefill"] = dict(logits=logits[:, -1].float().cpu(), s=s,
                          flash=counts()["flash_attention"], bytes=sent[0])
    tok = (torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
           if fed is None else fed[:, :1].to(dev))
    seen, steps, fed_now = [], [], [tok.cpu()]

    def capture(real, *a, **kw):
        lg, c = real(*a, **kw)
        seen.append(Sh.full(lg)[:, -1].float().cpu())
        return lg, c

    with meter() as sent, _wrapped(M, "decode_step", capture):
        for i in range(SHARD_DECODE):
            (nxt, cache), s = _timed_s(
                lambda: decode(model, cache, tok, SHARD_S + i))
            steps.append(s)
            tok = nxt if fed is None else fed[:, i + 1:i + 2].to(dev)
            fed_now.append(tok.cpu())
    out["decode"] = dict(logits=torch.stack(seen), s=steps, bytes=sent[0],
                         fed=torch.cat(fed_now[:SHARD_DECODE], 1))
    del model, cache, logits
    _free()
    # stablelm-1.6b: train steps
    model = M.init_params(train_cfg, seed=SEED, device=dev)
    if mesh is None:
        step = functools.partial(T.train_step, cfg=train_cfg, lr=TRAIN_LR)
    else:
        pspecs = Sh.param_specs(model, train_cfg, mesh)
        Sh.place_model(model, pspecs, mesh,
                       layout=Sh.layout_for(mesh, "train"))
        step = T.make_jitted_train_step(train_cfg, mesh, lr=TRAIN_LR)
    init = {k: _local(p).detach().clone()
            for k, p in model.named_parameters()}
    opt = T.init_opt(model)
    losses, gnorms, steps, sent_steps = [], [], [], []
    for t in range(SHARD_TRAIN_STEPS):
        with meter() as sent:
            (model, opt, m), s = _timed_s(lambda: step(model, opt, batch))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        steps.append(s)
        sent_steps.append(sent[0])
    updates = {}
    for k, w in opt.master.items():     # the masters start as the params
        upd = _local(w) - init.pop(k).float()
        if mesh is None:
            updates[k] = upd.cpu()
            continue
        sl = Sh.local_slices(w.shape, pspecs[k], mesh, mesh.coords())
        ref = np.load(os.path.join(ref_dir, f"{k}.npy"), mmap_mode="r")
        ref = torch.from_numpy(np.ascontiguousarray(ref[sl])).to(dev)
        if ref.shape != upd.shape:
            raise ValueError(f"the update of {k} is {tuple(upd.shape)} on "
                             f"this rank, its slice {tuple(ref.shape)}")
        ref, upd = ref.double(), upd.double()
        updates[k] = (float((upd - ref).pow(2).sum()),
                      float(ref.pow(2).sum()))
        del ref, upd
    out["train"] = dict(loss=losses, grad_norm=gnorms, s=steps,
                        bytes=sent_steps, updates=updates)
    del model, opt, m, updates
    _free()
    # falcon-mamba-7b at 4 layers: scoring forward (fused scan) + prefill
    model = M.init_params(mamba_cfg, seed=SEED, device=dev)
    score_batch = TokenStream(mamba_cfg.vocab, SHARD_B, SHARD_S,
                              seed=SEED).tensors_at(0, dev)
    prompt = {"tokens": score_batch["tokens"]}
    if mesh is not None:
        Sh.place_model(model, Sh.param_specs(model, mamba_cfg, mesh), mesh,
                       layout=Sh.layout_for(mesh, "train"))
        score_batch = Sh.place_tree(score_batch, Sh.batch_specs(
            score_batch, mamba_cfg, mesh), mesh, Sh.layout_for(mesh, "train"))
    hooks = (Sh.installed(mamba_cfg, mesh, "train", gather=True)
             if mesh is not None else contextlib.nullcontext())
    scans = []

    def first_scan(real, *a, **kw):     # layer 0's scan output, kept
        y = real(*a, **kw)
        scans.append(y if not scans else None)
        return y

    counts = _counts_zero()
    with meter() as sent, hooks, torch.no_grad(), \
            _wrapped(ssm_mod, "local_kernel", first_scan):
        (loss, _), s = _timed_s(lambda: M.forward_train(model, score_batch,
                                                        mamba_cfg))
    out["score"] = dict(loss=float(Sh.full(loss)), s=s,
                        scan=counts()["ssm_scan"], bytes=sent[0],
                        scan_y=Sh.full(scans[0]).float().cpu())
    del scans
    cache = M.init_cache(mamba_cfg, SHARD_B, SHARD_S, dev)
    if mesh is None:
        prefill = functools.partial(SV.prefill_step, cfg=mamba_cfg)
    else:
        prefill = SV.make_jitted_serve_fns(mamba_cfg, mesh, "serve")[0](
            cache, prompt)
    with meter() as sent:
        (logits, cache), s = _timed_s(lambda: prefill(model, prompt, cache))
    out["mamba_prefill"] = dict(logits=logits[:, -1].float().cpu(), s=s,
                                bytes=sent[0])
    del model, cache, logits
    _free()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _shard_rank(rank, world, fed, ref_dir):
    """Phase 24's rank: `_shard_parts` on its position of the (data 2,
    model 2) process mesh on cuda:0, the one-process updates in
    `ref_dir`; rank 0 returns the logits, every rank its updates' sums
    of squares, counts, seconds, bytes and peak."""
    import faulthandler
    import torch
    from repro_torch.launch.mesh import device_mesh, make_process_mesh
    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    mesh = make_process_mesh(SHARD_MESH, ("data", "model"), device=dev)
    device_mesh(mesh)     # built (a collective) before any part is timed
    t0 = time.perf_counter()
    out = _shard_parts(dev, mesh, torch.from_numpy(fed), ref_dir)
    out["parts_s"] = time.perf_counter() - t0
    out["coords"] = mesh.coords()
    if rank:
        for part in ("prefill", "decode", "mamba_prefill"):
            out[part].pop("logits")
        out["score"].pop("scan_y")
    # numpy across the queue: a tensor would need the rank alive
    return _as_numpy(out)


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return tree.numpy() if hasattr(tree, "numpy") else tree


def _rel_rms(a, b) -> float:
    import torch
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(((a - b).pow(2).mean() / b.pow(2).mean()).sqrt())


def _worst_update(ranks):
    """(leaf, rel RMS) of the leaf whose master's update over the train
    steps is furthest from the one-process run's: the ranks' sums of
    squares added (a replicated slice counts once a rank, in both sums
    alike)."""
    worst = ("", 0.0)
    for k in ranks[0]["train"]["updates"]:
        d2 = sum(rk["train"]["updates"][k][0] for rk in ranks)
        r2 = sum(rk["train"]["updates"][k][1] for rk in ranks)
        err = math.sqrt(d2 / r2) if r2 else math.sqrt(d2)
        if not err <= worst[1]:
            worst = (k, err)
    return worst


def phase_sharded(dev, rows, card):
    """Phase 24: the sharded LM steps (`launch.serve.make_jitted_serve_fns`,
    `launch.train.make_jitted_train_step`) on a (data 2, model 2) process
    mesh of 4 ranks spawned on cuda:0 over gloo, each result held to the
    one-process run of the same seed on the card (run and freed first);
    rows 5 and 6 launched on every rank's local shard."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_start = time.perf_counter()
    _free()
    torch.cuda.reset_peak_memory_stats()
    serve_cfg, train_cfg, mamba_cfg = _shard_cfgs()
    log(f"[24 sharded] {card}: stablelm-1.6b at full width and depth "
        f"({train_cfg.n_layers} layers, d {train_cfg.d_model}, "
        f"{train_cfg.n_heads} heads, vocab {train_cfg.vocab}, "
        f"{train_cfg.dtype}) and falcon-mamba-7b at full width, "
        f"{SHARD_MAMBA_LAYERS} of 64 layers; B {SHARD_B} x S {SHARD_S}; "
        f"mesh (data, model) = {SHARD_MESH}, 4 ranks on {dev} over gloo")
    one = _shard_parts(dev, None, None)
    if one["prefill"]["flash"] <= 0 or one["score"]["scan"] <= 0:
        fail(f"phase 24: the one-process run launched flash "
             f"{one['prefill']['flash']} and scan {one['score']['scan']} "
             f"times")
    one = _as_numpy(one)
    fed = one["decode"]["fed"]
    updates = one["train"].pop("updates")
    log(f"  one process: prefill {one['prefill']['s']:.3f} s, decode s "
        + ", ".join(f"{t:.3f}" for t in one["decode"]["s"])
        + ", train step s " + ", ".join(f"{t:.3f}" for t in
                                        one["train"]["s"])
        + f", mamba score {one['score']['s']:.3f} s and prefill "
        f"{one['mamba_prefill']['s']:.3f} s; peak {one['peak_gb']:.2f} GB "
        f"[{card}]")
    _free()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ref_dir:
        for k, upd in updates.items():
            np.save(os.path.join(ref_dir, f"{k}.npy"), upd)
        del updates
        log(f"  the one-process updates written in "
            f"{time.perf_counter() - t0:.1f} s")
        try:
            ranks = spawn_ranks(_shard_rank, 4, (fed, ref_dir),
                                timeout=SHARD_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 24: {e}")
    log(f"  the spawn took {time.perf_counter() - t0:.1f} s (start, init, "
        f"every part; limit {SHARD_TIMEOUT} s)")
    got = ranks[0]
    checks = [
        ("stablelm prefill last logits, rel RMS",
         _rel_rms(got["prefill"]["logits"], one["prefill"]["logits"]),
         SHARD_LOGITS_REL_RMS),
        ("stablelm decode logits (worst step), rel RMS",
         max(_rel_rms(a, b) for a, b in zip(got["decode"]["logits"],
                                            one["decode"]["logits"])),
         SHARD_LOGITS_REL_RMS),
        ("falcon-mamba prefill last logits, rel RMS",
         _rel_rms(got["mamba_prefill"]["logits"],
                  one["mamba_prefill"]["logits"]), SHARD_LOGITS_REL_RMS),
        ("falcon-mamba scoring, layer 0's fused scan output, rel RMS",
         _rel_rms(got["score"]["scan_y"], one["score"]["scan_y"]),
         SHARD_LOGITS_REL_RMS),
        ("falcon-mamba scoring loss (fused scan), rel",
         abs(got["score"]["loss"] / one["score"]["loss"] - 1),
         SHARD_LOSS_RTOL),
    ]
    for t in range(SHARD_TRAIN_STEPS):
        checks.append((f"stablelm train step {t + 1} loss, rel",
                       abs(got["train"]["loss"][t]
                           / one["train"]["loss"][t] - 1), SHARD_LOSS_RTOL))
        checks.append((f"stablelm train step {t + 1} grad norm, rel",
                       abs(got["train"]["grad_norm"][t]
                           / one["train"]["grad_norm"][t] - 1),
                       SHARD_GNORM_RTOL))
    leaf, err = _worst_update(ranks)
    checks.append((f"every master's update over the {SHARD_TRAIN_STEPS} "
                   f"steps, rel RMS, worst leaf ({leaf} of "
                   f"{len(got['train']['updates'])})", err,
                   SHARD_UPDATE_REL_RMS))
    over = []
    for what, err, limit in checks:
        log(f"  {what}: {err:.3e} (limit {limit})")
        if not err <= limit:
            over.append(f"{what} {err} over {limit}")
    if over:
        fail("phase 24: " + "; ".join(over))
    log("  train losses sharded " + ", ".join(
        f"{v:.6f}" for v in got["train"]["loss"]) + " vs one process "
        + ", ".join(f"{v:.6f}" for v in one["train"]["loss"])
        + "; grad norms " + ", ".join(
            f"{v:.4f}" for v in got["train"]["grad_norm"]) + " vs "
        + ", ".join(f"{v:.4f}" for v in one["train"]["grad_norm"]))
    for rk in ranks:
        log(f"  rank {rk['coords']}: flash launches {rk['prefill']['flash']}"
            f", scan launches {rk['score']['scan']}; prefill "
            f"{rk['prefill']['s']:.3f} s ({rk['prefill']['bytes']} gloo B), "
            f"decode s " + ", ".join(f"{t:.3f}" for t in rk["decode"]["s"])
            + f" ({rk['decode']['bytes'] // SHARD_DECODE} gloo B a step), "
            f"train step s " + ", ".join(f"{t:.3f}" for t in
                                         rk["train"]["s"])
            + " (gloo B " + ", ".join(str(b) for b in rk["train"]["bytes"])
            + f"), mamba score {rk['score']['s']:.3f} s "
            f"({rk['score']['bytes']} gloo B) and prefill "
            f"{rk['mamba_prefill']['s']:.3f} s "
            f"({rk['mamba_prefill']['bytes']} gloo B); all its parts "
            f"{rk['parts_s']:.1f} s; peak {rk['peak_gb']:.2f} GB [{card}]")
        if rk["prefill"]["flash"] <= 0 or rk["score"]["scan"] <= 0:
            fail(f"phase 24: rank {rk['coords']} launched flash "
                 f"{rk['prefill']['flash']} and scan {rk['score']['scan']} "
                 f"times; each must run on the rank's shard")
    launches = {"flash_attention": [rk["prefill"]["flash"] for rk in ranks],
                "ssm_scan": [rk["score"]["scan"] for rk in ranks]}
    for row in rows:
        if row["name"] in launches:
            row["launches"] += sum(launches[row["name"]])
            row["launches_phase24"] = launches[row["name"]]
    took = time.perf_counter() - t_start
    log(f"  launches on phase 24's paths, rank by rank: {launches}; phase "
        f"24 took {took:.1f} s")
    return {"one": one, "ranks": ranks, "s": took}


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
    gc.collect()
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    phase_mesh_dense(dev, dense)
    phase_dist(dev, sparse, dense)
    phase_accel(dev, dense)
    log(f"  phases 15-17 took {time.perf_counter() - t_new:.1f} s")
    phase_obs(dev, sparse, rows)
    phase_runtime(dev, sparse, dense, mesh)
    del mesh, sparse, dense, pipe, sparse_plain
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(dev)
    phase_windows(dev, rows)
    phase_moe(dev, rows)
    phase_whisper(dev, rows)
    phase_sharded(dev, rows, smi_line)
    rows.sort(key=lambda row: TABLE_ORDER.index(row["name"]))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
