#!/usr/bin/env python3
"""Where a step of the port's LocalSDCA walks goes, on the card.

    python3 tools/sdca_step_ablation.py [--out build/sdca_step_ablation.json]
                                        [--only sparse,wide,zx,zxc,dense]
                                        [--workers 1,2,4] [--depth 4]
                                        [--stress N] [--src PATH]

Needs one NVIDIA card and nvcc; run from the root of a checkout. Builds
variants of the two walk kernels (csrc/sparse_sdca_pipelined.cu and
csrc/local_sdca.cu) and of the zx round's grid and cluster forms (csrc/
sparse_sdca_zx.cu), each with one part of the step taken out or replaced
by a cheaper one, and times every variant beside the unchanged kernel, in
turns, on round-1 inputs at the shapes `chip_smoke.py` runs: rcv1's
677,399 x 47,236 at density 0.0016 (sparse, K = 8, ring depth `--depth`,
4 by default, the card's; the walk warp's step, the fetch warp off its
chain; zx, the same rows as
phase 28's 4 x 32 FeatureShards, B = 16, one cooperative launch a round,
at each of `--workers` workers a block: W = 1 as the card holds it, W > 1
with the grid's residency read as ceil(4 / W) 32 blocks, so the plan
takes the lockstep instance; zxc, the same rows as phase 12's 4 x 2
FeatureShards, B = 16, the cluster form),
phase 28's news20-shaped synthetic (wide: 19,996 x 1,355,191 at density
3.36e-4, K = 4, ring depth 4, u in device memory) and
epsilon's 400,000 x 2,000 and the paper cell's rank block (dense, K = 8
and 1, the default window, the cluster the plan picks), hinge. A
variant computes something else than the walk; only its time is read. The
difference to the unchanged kernel is what the part costs on the chain.

Variants (the text each one replaces is named in VARIANTS), by group:
  sparse  cas_scatter the compare-and-swap scatter on every row (the
                      prep warp's `plain` mark ignored)
          no_scatter  no scatter at all
          seq_rows    rows fetched in storage order, not through perm
                      (the prep and the write-back still read perm)
          no_reduce   no warp butterfly of z (each lane's own partial)
          no_gather   no u[c] gather (the value itself stands in)
          no_dalpha   no dalpha left in the stage by the walk
          relaxed     the walk's arrival on a stage's `empty` relaxed, not
                      a release
          no_update   cd_update replaced by a multiply-add
          fast_div    cd_update's divisions by __fdividef
          no_init_fence the ring's barriers initialised without
                      fence.mbarrier_init before the bulk copies use them
          no_lookahead the next row loaded after the release, not in the
                      shadow of this row's sums
          cp_async_rows a row's cols and vals by 16-byte cp.asyncs of
                      the fetch warp's lanes, not by two bulk copies
          stamped     the stamped build (SDCA_STEP_STAMPS): the step split
                      positively. Every thread of the walk, fetch and prep
                      warps reads clock64 at each phase boundary the source
                      names (`sparse_sdca_stamp_names`) and adds the cycles
                      to that phase's total, every step, without a branch;
                      printed as us a step a phase (clock64 turned into
                      time by %globaltimer over the whole walk), the walk's
                      sum beside the unstamped step, the walk's wait for
                      its row and the fetch warp's time a row
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
  zxc     stamped     the stamped build (SDCA_ZX_STAMPS, csrc/
                      sdca_zx_stamps.cuh): the step split positively,
                      clock64 at each phase boundary the source names
                      (`sparse_sdca_zx_stamp_names`) summed in registers
                      without a branch, every step, for the walk's warp 0
                      and the fetch warp; printed as us a step a phase
                      (as the sparse group's), each role's sum beside the
                      unstamped step
          no_exchange no wait for the peers' partials, no sends and no
                      re-arming of the exchange's barriers (z from the
                      stale buffer)
          no_update   as the zx group's
          no_scatter  no scatter into u (neither the swaps nor atomicAdd)
          atomic_scatter the held slots off: every slot scattered by
                      atomicAdd, as the first design of the walk did
          no_gather   no u[c] gather in the next block's dots (v stands
                      in; the swaps then expect v and go round again)
  dense   no_exchange each block pushes its window's partials into its own
                      buffer only and waits for those (the peers' slots
                      stale): the exchange across the cluster taken out,
                      its protocol kept
          no_gram     no FMAs of the partials (G, the dots, H) over the
                      block's columns (the reductions and the exchange
                      kept)
          no_scalar   no scalar loop (the window's B updates)
          no_fill     no row slices copied by the fetch warp (stale stages;
                      the row ids and the barriers kept)
          no_update   no u += X_B^T c
          fast_div    as above
          stamped     the stamped build (SDCA_ZX_STAMPS, csrc/
                      sdca_zx_stamps.cuh): the window split positively for
                      warp 0 and column warp 1 (`dense_split`)
          each at epsilon's shape and at the paper cell's rank block (K = 1,
          nk = d = 16,384), in the cluster the plan picks; "us a step" there
          is us a window
Each variant's replacements must each match the sources of its group's
kernel (the .cu and the headers it includes) once (or the count given as
a third element), or the run fails: an edit of a kernel that moves the
text shows here (tests/test_torch_zx_cluster.py checks them on the CPU).

--src PATH (with --only zxc): ablate another checkout's cluster form (its
src/, imported and built instead of this one's), a parent whose cluster
form shared the grid form's kernel: its stamped build gets this
checkout's csrc/sdca_zx_stamps.cuh and the boundaries of `PARENT_ZXC`
(warp 0, "update", holds the 16 threads that exchange and update at
B = 16; warp 1, "idle", waits for them at the barrier before the
scatter), beside its prefetch and its exchange taken out.

--stress N (with the sparse group): N fresh processes for the unchanged
kernel and N for no_init_fence, 8 at a time, each loading its library and
launching it STRESS_LAUNCHES times at a cut shape (K = 8, nk = 512, rcv1's
r_max 118 and d, rows that repeat no id, ring --depth): the launches that
fail and the results that differ from the process's first, so a fault
that shows on a module's first launch only is sampled N times.
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
                "zxc": "sparse_sdca_zx", "dense": "local_sdca"}
# the fetch loops of both kernels (u in shared and in device memory)
SEQ_ROWS = [("const int i = __shfl_sync(FULL, cur, "
             "static_cast<int>(p & 31));",
             "const int i = static_cast<int>(p % nk);", 2)]
RELAXED = [("mbarrier.arrive.shared::cta.b64 %0, [%1];",
            "mbarrier.arrive.relaxed.cta.shared::cta.b64 %0, [%1];")]
NO_UPDATE = [("sdca::cd_update(loss_id, g, sc[1] + dai, tot.x,\n"
              "                                          scale * "
              "tot.y, sc[0]) * sc[2];",
              "(tot.x + tot.y + dai) * 1e-30f;")]
# the grid form's update
ZX_NO_UPDATE = [("sdca::cd_update(loss_id, g, sc[B + t] + dai, z,\n"
                 "                                          scale * "
                 "sc[3 * B + t], sc[t]) *\n"
                 "                          sc[2 * B + t];",
                 "(z + dai) * 1e-30f;")]
# The parent's cluster form (one kernel with the grid form, before its own
# function), for --src: its stamped build, the boundaries of
# sdca_zx_stamps.cuh put in by hand ("update" is warp 0, whose 16 threads
# exchange and update at B = 16; "idle" warp 1, which waits for them at the
# barrier before the scatter), and its prefetch and exchange taken out.
PARENT_PHASES = ("cluster_wait,exchange,update,bar_scatter,scatter,copy_wait,"
                 "bar_prefetch,prefetch,dots")
PARENT_ZXC = {
    "stamped": [
        ('#include "sdca_common.cuh"\n',
         '#include "sdca_common.cuh"\n\n#define ZX_STAMP_NAMES "update:'
         + PARENT_PHASES + ';idle:' + PARENT_PHASES + '"\n'
         '#define SDCA_ZX_STAMPS 1\n#include "sdca_zx_stamps.cuh"\n'),
        ("  for (int step = 0; step < total; ++step) {\n"
         "    const int n = w0.rows_of(step);",
         "  ZX_STAMP_BEGIN(9);\n  ZX_STAMP_CLOCK(0);\n"
         "  for (int step = 0; step < total; ++step) {\n    ZX_STAMP(8);\n"
         "    const int n = w0.rows_of(step);"),
        ("      cluster.sync();                // every peer's zb[step % 2] "
         "is written\n",
         "      cluster.sync();                // every peer's zb[step % 2] "
         "is written\n      ZX_STAMP(0);\n"),
        ("          z += cluster.map_shared_rank(zb, mm)[zin + t];\n"
         "        update(0, t, z);\n",
         "          z += cluster.map_shared_rank(zb, mm)[zin + t];\n"
         "        ZX_STAMP(1);\n        update(0, t, z);\n"
         "        ZX_STAMP(2);\n"),
        ("    __syncthreads();\n\n    // the scatter into each worker's u "
         "slice",
         "    __syncthreads();\n    ZX_STAMP(3);\n\n    // the scatter into "
         "each worker's u slice"),
        ("    cp_async_wait_all();\n    __syncthreads();\n"
         "    fetch_rows<W>(walk, nw, step + 2);\n"
         "    fetch_ids<W>(walk, nw, step + 3);\n    cp_async_commit();\n",
         "    ZX_STAMP(4);\n    cp_async_wait_all();\n    ZX_STAMP(5);\n"
         "    __syncthreads();\n    ZX_STAMP(6);\n"
         "    fetch_rows<W>(walk, nw, step + 2);\n"
         "    fetch_ids<W>(walk, nw, step + 3);\n    cp_async_commit();\n"
         "    ZX_STAMP(7);\n"),
        ("  cp_async_wait_all();\n  if constexpr (!GRID) {\n"
         "    cg::this_cluster().sync();",
         "  ZX_STAMP_CLOCK(1);\n  if constexpr (!GRID) {\n"
         "    if (tid < 32) ZX_STAMP_FLUSH(0, 9, 0, total);\n"
         "    if (tid >= 32 && tid < 64) ZX_STAMP_FLUSH(9, 9, 1, total);\n"
         "  }\n"
         "  cp_async_wait_all();\n  if constexpr (!GRID) {\n"
         "    cg::this_cluster().sync();"),
    ],
    "no_exchange": [
        ("      cluster.sync();                // every peer's zb[step % 2] "
         "is written\n", ""),
        ("z += cluster.map_shared_rank(zb, mm)[zin + t];",
         "z += zb[zin + t];")],
    "no_prefetch": [("    fetch_rows<W>(walk, nw, step + 2);\n", "")],
}
# the stamps' header, given to a checkout that lacks it
STAMP_HEADER = "sdca_zx_stamps.cuh"
VARIANTS = {
    "wide": {
        "same_row": [("const int i = __shfl_sync(FULL, cur, "
                      "static_cast<int>(p & 31));", "const int i = 0;", 2)],
        "seq_rows": SEQ_ROWS,
        "no_gather": [("us[i] = base + STRIDE * i < r_max ? __ldcg(u + "
                       "cs[i]) : 0.0f;", "us[i] = vs[i];")],
        "no_scatter": [("if (vs[i] != 0.0f) atomicAdd(u + cs[i], "
                        "__fmul_rn(coef, vs[i]));", "")],
        "no_reduce": [("sdca::warp_sum2(z, sq);", "make_float2(z, sq);")],
        "no_update": NO_UPDATE,
        "no_step_sync": [("      if constexpr (NWALK > 1) {\n"
                          "        walk_sync<NWALK>();\n      } else {\n"
                          "        __syncwarp();\n      }\n", "")],
        "relaxed": RELAXED,
    },
    "sparse": {
        "cas_scatter": [("if (row.flags & FLAG_PLAIN) {", "if (false) {")],
        "no_scatter": [("if (coef != 0.0f) {", "if (coef != coef) {", 2)],
        "seq_rows": SEQ_ROWS,
        "no_reduce": [("      z = warp_sum1(z);\n", "")],
        "no_gather": [("us[i] = lane + WARP * i < r_max ? u[row.cs[i]] : "
                       "0.0f;", "us[i] = row.vs[i];")],
        "no_dalpha": [("if (lane == 0) st[2 * rw + SC_DALPHA] = row.dai + "
                       "delta;", "")],
        "relaxed": [("if (lane == 0) mbar_arrive(empty + slot);",
                     "if (lane == 0) {\n        unsigned long long s_;\n"
                     "        asm volatile(\"mbarrier.arrive.relaxed.cta."
                     "shared::cta.b64 %0, [%1];\" : \"=l\"(s_) : \"r\"("
                     "smem_addr(empty + slot)) : \"memory\");\n      }")],
        "no_update": [("sdca::cd_update(loss_id, g, row.sc.y, z,\n"
                       "                                          row.sc.w, "
                       "row.sc.x) * row.sc.z;",
                       "(z + row.dai) * 1e-30f;")],
        "fast_div": [DIV],
        "no_lookahead": [("const bool ahead = DEPTH > 1 && j + 1 < total;",
                          "const bool ahead = false;")],
        "cp_async_rows": [(
            "        if (lane == 0) {\n"
            "          mbar_arrive_expect_tx(full + slot, 2 * bytes);\n"
            "          bulk_copy(st, cols + a0, bytes, full + slot);\n"
            "          bulk_copy(st + rw, vals + a0, bytes, full + slot);\n"
            "        }\n",
            "        if (lane == 0) mbar_arrive_expect_tx(full + slot, 0);\n"
            "        for (int q = lane; q < static_cast<int>(bytes / 16); "
            "q += WARP) {\n"
            "          cp_async16(st + 4 * q, cols + a0 + 4 * q);\n"
            "          cp_async16(st + rw + 4 * q, vals + a0 + 4 * q);\n"
            "        }\n")],
        "no_mark": [("        plain &= (v1 == 0.0f) | ((v != 0.0f) & "
                     "(c < c1));\n", "        (void)v1;\n        (void)c1;"
                     "\n")],
        "no_prep_slots": [("for (int s = lane; s < r_max; s += WARP) {\n"
                           "        const float v = vi[s];",
                           "for (int s = lane; s < 0; s += WARP) {\n"
                           "        const float v = vi[s];")],
        "no_prep_reduce": [("      sq = warp_sum1(sq);\n", "")],
        "no_write_back": [("          dalpha[row0 + iq] = sc[SC_DALPHA];\n"
                           "          __threadfence_block();\n", "")],
        "no_scalars": [("        cp_async4(sc + (lane == 0 ? SC_Y : lane == "
                        "1 ? SC_ABAR\n", "        if (0) cp_async4(sc + ("
                        "lane == 0 ? SC_Y : lane == 1 ? SC_ABAR\n")],
        "no_init_fence": [('    asm volatile("fence.mbarrier_init.release.'
                           'cluster;\\n" ::: "memory");\n', "")],
        "wait_sleep": [("for (unsigned n = 1; !mbar_try(bar, parity); ++n)",
                        "for (unsigned n = 1; !mbar_try(bar, parity); "
                        "++n, __nanosleep(40))")],
        "wait_hint": [(" mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                       "%2;\\n", " mbarrier.try_wait.parity.shared::cta.b64 "
                       "p, [%1], %2, 100000;\\n")],
        "stamped": [("#define SDCA_STEP_STAMPS 0",
                     "#define SDCA_STEP_STAMPS 1")],
    },
    "zx": {
        "no_poll": [("if (__all_sync(0xffffffffu, ready)) break;",
                     "break;")],
        "no_exchange": [("exchange_rows<ZR>(words, live, M, step, zr);",
                         "for (int r = 0; r < ZR; ++r) zr[r] = 0.0f;"),
                        ("const float z = exchange_staged<ZR>(\n"
                         "            words, live, M, step,\n"
                         "            smem + W * slab + warp * (ZR * "
                         "XS_STRIDE));", "const float z = 0.0f;")],
        "no_update": ZX_NO_UPDATE,
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
    "zxc": {
        "stamped": [("#define SDCA_ZX_STAMPS 0", "#define SDCA_ZX_STAMPS 1")],
        "no_exchange": [
            ("      if (step > 0 && lane < rows)\n        mbar_wait(xbar + "
             "(step & 1), ((step - 1) >> 1) & 1);\n", ""),
            ("      if (tid == 0 && step > 0 && step + 2 < total)\n"
             "        mbar_expect(xbar + (step & 1), 4u * M * rows_of(step "
             "+ 2));\n", ""),
            ("            send_partial(to + 4u * t0 * M, za, bar);\n"
             "            if (two) send_partial(to + 4u * t1 * M, zb, bar);"
             "\n", "")],
        "no_update": [("sdca::cd_update(loss_id, g, sc[B + t] + dai, z,\n"
                       "                                            scale * "
                       "sc[3 * B + t], sc[t]) *\n"
                       "                            sc[2 * B + t];",
                       "(z + dai) * 1e-30f;")],
        "no_scatter": [("          if (v != 0.0f) atomicAdd(uu + ci[s], "
                        "c * v);", "          if (v != v) atomicAdd(uu + "
                        "ci[s], c * v);"),
                       ("          pa[j] = in && c0 != 0.0f && va[j] != 0.0f;"
                        "\n          pb[j] = in && c1 != 0.0f && vb[j] != "
                        "0.0f;\n", "          pa[j] = false;\n"
                        "          pb[j] = false;\n")],
        "atomic_scatter": [("    const bool held = U_SMEM && B <= 2 * NWARPS;",
                            "    const bool held = false;")],
        "no_gather": [("            ua[j] = load_u<U_SMEM>(uu + ca[j]);\n"
                       "            ub[j] = load_u<U_SMEM>(uu + cb[j]);\n",
                       "            ua[j] = va[j];\n            ub[j] = "
                       "vb[j];\n")],
    },
    "dense": {
        "no_exchange": [
            ("      for (int j = 0; j < x.C; ++j)\n"
             "        send_partial(",
             "      for (int j = x.rank; j <= x.rank; ++j)\n"
             "        send_partial("),
            ("  const unsigned xbytes = 4u * P * C;",
             "  const unsigned xbytes = 4u * P;")],
        "no_gram": [("  for (int cl = tt; cl < w; cl += 32 * NW) {",
                     "  for (int cl = tt; cl < w * 0; cl += 32 * NW) {")],
        "no_scalar": [("    if (l < nb) {\n      const float dl",
                       "    if (l < 0) {\n      const float dl")],
        "no_fill": [("        if (lane < nb && wd > 0) {\n"
                     "          bulk_copy(",
                     "        if (lane < 0) {\n          bulk_copy(")],
        "no_update": [("            if (j < nb) v = fmaf(cj[j], "
                       "st[j * dt + c], v);", "")],
        "fast_div": [DIV],
        "stamped": [("#define SDCA_ZX_STAMPS 0", "#define SDCA_ZX_STAMPS 1")],
    },
}


def log(msg):
    print(msg, flush=True)


def group_variants(group, parent=False):
    """The variants of `group`: this checkout's, or with `parent` (--src)
    those of the parent's source (`PARENT_ZXC`; only the zxc group has
    them)."""
    if not parent:
        return VARIANTS[group]
    if group != "zxc":
        raise SystemExit(f"--src ablates the zxc group only, not {group}")
    return PARENT_ZXC


def kernel_sources(d: pathlib.Path, kernel: str):
    """The texts of `d/<kernel>.cu` and the headers of `d` it includes,
    directly or through another header."""
    import re
    seen, todo = [], [d / f"{kernel}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo += [d / inc for inc in re.findall(
            r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)]
    return [p.read_text() for p in seen]


def variant_dirs(base: pathlib.Path, groups=None, parent=False):
    """{(group, variant): csrc dir}: a copy of csrc/ (with the stamps'
    header where it lacks one) per variant of each of `groups` (None: all)
    with its replacements applied ("full": unchanged). Each replacement
    must match the group kernel's sources the given number of times (1 by
    default), or the run fails."""
    from repro_torch.kernels import build
    dirs = {}
    for group in VARIANTS:
        if groups is not None and group not in groups:
            continue
        variants = group_variants(group, parent)
        for name, edits in {"full": [], **variants}.items():
            d = base / f"{group}-{name}"
            if d.exists():
                shutil.rmtree(d)
            shutil.copytree(build.CSRC, d)
            if not (d / STAMP_HEADER).exists():
                shutil.copy(ROOT / "src/repro_torch/kernels/csrc" /
                            STAMP_HEADER, d)
            texts = kernel_sources(d, GROUP_KERNEL[group])
            for old, _, *count in edits:
                hits = sum(t.count(old) for t in texts)
                if hits != (count[0] if count else 1):
                    raise SystemExit(f"{group} {name}: {old!r} found "
                                     f"{hits} times in the sources of "
                                     f"{GROUP_KERNEL[group]}.cu")
            for path in d.iterdir():
                text = path.read_text()
                for old, new, *_ in edits:
                    text = text.replace(old, new)
                path.write_text(text)
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
    """ms a call of every variant of `group` built in `libs`, in turns
    (forward, then backward); returns {variant: ms}."""
    from repro_torch.kernels import build
    kernel = GROUP_KERNEL[group]
    name = name or group
    names = [n for g, n in libs if g == group]
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
    ap.add_argument("--depth", type=int, default=4,
                    help="the sparse group's ring depth (4: the card's "
                         "default)")
    ap.add_argument("--workers", default="1",
                    help="comma-separated workers a block of the zx grid "
                         "form to ablate (1, 2, 4 at rcv1's 4 x 32)")
    ap.add_argument("--stress", type=int, default=0,
                    help="fresh processes a sparse variant for the launch "
                         "stress (0: none)")
    ap.add_argument("--src", default=None,
                    help="another checkout's src/ to ablate (its zxc "
                         "group: the parent's cluster form, `PARENT_ZXC`)")
    ap.add_argument("--stress-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.stress_child:
        return stress_child(args.stress_child, args.depth)
    workers = tuple(int(w) for w in args.workers.split(","))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sdca_step_ablation: needs a CUDA card")
    sys.path.insert(0, str(pathlib.Path(args.src or ROOT / "src").resolve()))
    from repro_torch.core.losses import get_loss
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"[ablation] {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    groups = args.only.split(",") if args.only else list(VARIANTS)
    if set(groups) - set(VARIANTS):
        raise SystemExit(f"unknown groups {set(groups) - set(VARIANTS)}")
    dirs = variant_dirs(ROOT / "build" / "ablation", groups,
                        parent=args.src is not None)
    libs = build_variants(dirs)
    log(f"  {len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda:0")
    hinge = get_loss("hinge")
    rng = np.random.default_rng(SEED)
    result = {"device": smi, "src": args.src or str(ROOT / "src")}

    walks = {"sparse": lambda *a: sparse_walk(*a, depth=args.depth),
             "wide": wide_walk, "dense": dense_walk,
             "zx": lambda *a: zx_grid(*a, workers=workers),
             "zxc": zx_cluster}
    for group in groups:
        result[group] = walks[group](libs, dev, rng, hinge)
    if args.stress and "sparse" in groups:
        result["stress"] = {
            name: stress(dirs[("sparse", name)], args.stress, args.depth)
            for name in ("full", "no_init_fence")}
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    log(json.dumps(result))


STRESS_LAUNCHES = 50


def stress(d, n, depth):
    """n fresh processes launching the sparse library built in `d`; returns
    the processes, launches that failed and results that differed."""
    import concurrent.futures
    lib = d / f"{GROUP_KERNEL['sparse']}.so"
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
           "--stress-child", str(lib), "--depth", str(depth)]

    def one(_):
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        try:
            return json.loads(run.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            return {"failed": 1, "differ": 0, "launches": 0,
                    "error": (run.stderr or run.stdout)[-300:]}

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(one, range(n)))
    out = {"processes": n,
           "launches": sum(g["launches"] for g in got),
           "failed": sum(g["failed"] for g in got),
           "differ": sum(g["differ"] for g in got),
           "failed_first": sum(g.get("failed_first", 0) for g in got),
           "errors": sorted({g["error"] for g in got if g.get("error")})[:3]}
    log(f"  stress {d.name}: {out}")
    return out


def stress_child(lib_path, depth):
    """One process of `stress`: load the library, launch it
    STRESS_LAUNCHES times, print the failures as one JSON line."""
    import ctypes
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels import build
    from repro_torch.kernels import sparse_sdca as sk
    kernel = GROUP_KERNEL["sparse"]
    lib = ctypes.CDLL(lib_path)
    build._bind(kernel, lib)
    build._LIBS[kernel] = lib
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    K, nk, r, d = 8, 512, 118, 47_236
    nnz = rng.integers(1, r + 1, size=(K, nk))
    cols = np.zeros((K, nk, r), np.int32)
    vals = np.zeros((K, nk, r), np.float32)
    for k in range(K):
        for i in range(nk):
            n = int(nnz[k, i])
            cols[k, i, :n] = np.sort(rng.choice(d, n, replace=False))
            vals[k, i, :n] = rng.standard_normal(n) / np.sqrt(n)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (
        cols, vals, y, np.zeros((K, nk), np.float32),
        np.ones((K, nk), np.float32), np.zeros(d, np.float32),
        np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32))]
    failed = differ = first_failed = 0
    first, err = None, None
    for i in range(STRESS_LAUNCHES):
        try:
            got = sk.sparse_local_sdca(*t[:6], 0.5, t[6],
                                       loss=get_loss("hinge"), n_passes=2,
                                       buffer_depth=depth)
            torch.cuda.synchronize()
        except RuntimeError as e:          # a failed launch poisons the rest
            failed, first_failed, err = failed + 1, int(i == 0), str(e)[:200]
            break
        if first is None:
            first = got
        elif not all(torch.equal(a, b) for a, b in zip(got, first)):
            differ += 1
    print(json.dumps({"launches": i + 1, "failed": failed, "differ": differ,
                      "failed_first": first_failed, "error": err}))


def sparse_walk(libs, dev, rng, hinge, depth=4):
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
    log(f"[sparse] rcv1 shape K={K} nk={nk} r_max={sh.r_max}, depth "
        f"{depth}")

    def call():
        return sk.sparse_local_sdca(*sargs, loss=hinge, buffer_depth=depth)

    ms = in_turns("sparse", libs, call, nk)
    return {"ms": ms, "split": step_split(libs[("sparse", "stamped")], call,
                                          K, nk, ms)}


def read_stamps(lib, group, prefix, call, blocks_run):
    """One launch (`call`) of the stamped build `lib` of `group`'s kernel:
    us a step of each phase of each role the source names, each phase's
    cycles over all steps of the first `blocks_run` blocks turned into
    time at the SM clock the loop ran at (clock64 over %globaltimer across
    the loop). The source names its roles' phases in word order
    ("role:a,b;role:c,...") through `<prefix>_stamp_names`; the roles'
    step counts are the buffer's last words, in that order. Returns
    ({role: {phase: us}}, GHz)."""
    import ctypes
    import numpy as np
    from repro_torch.kernels import build
    kernel = GROUP_KERNEL[group]
    shape = (ctypes.c_int * 2)()
    getattr(lib, f"{prefix}_stamp_shape")(shape)
    blocks, words = shape
    names_of = getattr(lib, f"{prefix}_stamp_names")
    names_of.restype = ctypes.c_char_p
    roles = [part.split(":") for part in names_of().decode().split(";")]
    stamps = np.zeros((blocks, words), np.int64)
    clocks = np.zeros((blocks, 4), np.int64)
    build._LIBS[kernel] = lib
    try:
        build.check(lib, kernel, getattr(lib, f"{prefix}_stamps_reset")())
        call()
        build.check(lib, kernel, getattr(lib, f"{prefix}_stamps_read")(
            stamps.ctypes.data_as(ctypes.c_void_p),
            clocks.ctypes.data_as(ctypes.c_void_p)))
    finally:
        build._LIBS.pop(kernel, None)
    n = min(blocks_run, blocks)
    st, clk = stamps[:n].astype(np.float64), clocks[:n].astype(np.float64)
    ghz = float(np.mean((clk[:, 1] - clk[:, 0])
                        / np.maximum(clk[:, 3] - clk[:, 2], 1)))
    split, w0 = {}, 0
    for r, (role, names) in enumerate(roles):
        names = names.split(",")
        steps = st[:, words - len(roles) + r].sum()
        split[role] = {p: float(st[:, w0 + i].sum() / steps / ghz / 1e3)
                       for i, p in enumerate(names)}
        w0 += len(names)
    return split, ghz


def step_split(lib, call, K, nk, ms):
    """The shared-memory walk's split (`read_stamps` of the sparse
    group's stamped build): us a phase of each role (the walk warp, the
    fetch warp, and any other the source names) against the unstamped
    step (`ms["full"]` over nk) and the stamped one."""
    split, ghz = read_stamps(lib, "sparse", "sparse_sdca", call, K)
    walk, fetch = split["walk"], split["fetch"]
    step = 1e3 * ms["full"] / nk
    stamped = 1e3 * ms["stamped"] / nk
    total = sum(walk.values())
    fwait = next(v for n, v in fetch.items() if n.startswith("wait"))
    out = dict(us=split, walk_sum_us=total, step_us=step,
               stamped_step_us=stamped, sum_over_step=total / step,
               walk_wait_us=sum(v for n, v in walk.items()
                                if n.startswith("wait")),
               fetch_row_us=sum(fetch.values()), fetch_wait_us=fwait,
               fetch_busy_us=sum(fetch.values()) - fwait, ghz=ghz)
    log(f"  sparse split (SM clock {ghz:.3f} GHz), us a step: " + "; ".join(
        f"{role} " + ", ".join(f"{n} {v:.4f}" for n, v in parts.items())
        + f" (sum {sum(parts.values()):.4f})" for role, parts in split.items())
        + f". The walk's sum {total:.4f} against the unstamped step "
        f"{step:.4f} ({total / step:.3f}x) and the stamped {stamped:.4f}; "
        f"the walk waits {out['walk_wait_us']:.4f} on its row; the fetch "
        f"warp is busy {out['fetch_busy_us']:.4f} a row")
    return out


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


def zx_cluster(libs, dev, rng, hinge):
    """The cluster form at phase 12's 4 x 2 shape: rcv1's rows dealt into
    FeatureShards, the first round's inputs (w = 0, alpha = 0), B = 16,
    one pass, every variant in turns; then the stamped build once, split
    (`cluster_split`). Returns {"ms": {variant: ms}, "split": ...}."""
    import numpy as np
    import torch
    from repro_torch.data import make_sparse_classification
    from repro_torch.data.sparse import row_sqnorms, shard_features_streaming
    from repro_torch.kernels import sparse_sdca as sk
    csr, y = make_sparse_classification(677_399, 47_236, density=0.0016,
                                        seed=SEED)
    fs, yp, mk = shard_features_streaming([(csr, y)], 4, 2,
                                          n_features=csr.shape[1],
                                          device=dev)
    del csr
    K, M, nk, r_loc = fs.cols.shape
    perm = torch.from_numpy(np.stack([np.random.default_rng(k).permutation(
        nk) for k in range(K)]).astype(np.int32)).to(dev)
    args = (fs.cols, fs.vals, yp, torch.zeros((K, nk), device=dev), mk,
            torch.zeros(M * fs.d_local, device=dev), 4.0 / (1e-6 * 677_399),
            (row_sqnorms(fs) * mk).contiguous(), perm)
    steps = -(-nk // 16)
    log(f"[zxc] rcv1 shape K={K} M={M} nk={nk} r_loc={r_loc} "
        f"d_local={fs.d_local}, B 16, {steps} steps a round, cluster form")

    def call():
        out = sk.sparse_local_sdca_zx(*args, loss=hinge, block_rows=16)
        if sk.LAST_ZX_FORM != "cluster":
            raise SystemExit(f"zxc ablation ran {sk.LAST_ZX_FORM}, not the "
                             f"cluster form")
        return out

    ms = in_turns("zxc", libs, call, steps)
    return {"ms": ms, "split": cluster_split(libs[("zxc", "stamped")], call,
                                             K * M, steps, ms)}


def cluster_split(lib, call, blocks, steps, ms):
    """The cluster form's split (`read_stamps` of the zxc group's stamped
    build, warps 0 and 1): us a step of each phase of each warp, each
    warp's sum against the unstamped step (`ms["full"]` over the steps)
    and the stamped one. In the parent's source, warp 0 ("update") holds
    the 16 threads that exchange and update and warp 1 ("idle") waits for
    them at the barrier before the scatter: both printed side by side."""
    split, ghz = read_stamps(lib, "zxc", "sparse_sdca_zx", call, blocks)
    step = 1e3 * ms["full"] / steps
    stamped = 1e3 * ms["stamped"] / steps
    sums = {role: sum(parts.values()) for role, parts in split.items()}
    out = dict(us=split, sum_us=sums, step_us=step, stamped_step_us=stamped,
               sum_over_step={r: v / step for r, v in sums.items()},
               ghz=ghz)
    if "idle" in split:
        upd = split["update"]
        out["updating_us"] = upd["exchange"] + upd["update"]
        out["idle_wait_us"] = split["idle"]["bar_scatter"]
    log(f"  zxc split (SM clock {ghz:.3f} GHz), us a step: " + "; ".join(
        f"{role} " + ", ".join(f"{n} {v:.4f}" for n, v in parts.items())
        + f" (sum {sums[role]:.4f}, {sums[role] / step:.3f}x the "
        f"unstamped step {step:.4f}; stamped {stamped:.4f})"
        for role, parts in split.items())
        + ("" if "idle" not in split else
           f". The 16 updating threads' exchange and update "
           f"{out['updating_us']:.4f} against the idle warp's wait at the "
           f"barrier {out['idle_wait_us']:.4f}"))
    return out


def dense_walk(libs, dev, rng, hinge):
    import math
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
    dk.local_sdca(*dargs, loss=hinge)
    log(f"[dense] epsilon shape K={K} nk={nk} d={d}, block_rows "
        f"{dk.DEFAULT_BLOCK_ROWS}: {dk.LAST_DENSE_CONFIG}")
    windows = -(-nk // dk.DEFAULT_BLOCK_ROWS)
    call = lambda: dk.local_sdca(*dargs, loss=hinge)   # noqa: E731
    ms = in_turns("dense", libs, call, windows,
                  name="dense epsilon (a window)")
    out = {"epsilon": {"ms": ms, "split": dense_split(
        libs[("dense", "stamped")], call, K * dk.LAST_DENSE_CONFIG["cluster"],
        windows, ms, "epsilon")}}
    del dargs, Xp
    # the paper cell's rank block (chip_smoke.py phase 25c)
    n = 16_384
    g = torch.Generator(device=dev).manual_seed(SEED)
    Xb = torch.randn((1, n, n), generator=g, device=dev) / math.sqrt(n)
    yb = torch.where(torch.rand((1, n), generator=g, device=dev) < 0.5,
                     -1.0, 1.0)
    pb = torch.randperm(n, generator=g, device=dev).to(torch.int32)[None]
    bargs = (Xb, yb, torch.zeros((1, n), device=dev),
             torch.ones((1, n), device=dev), torch.zeros(n, device=dev),
             512.0 / (1e-4 * 512 * n), pb.contiguous())
    dk.local_sdca(*bargs, loss=hinge)
    log(f"[dense] the paper block K=1 nk={n} d={n}: {dk.LAST_DENSE_CONFIG}")
    windows = -(-n // dk.DEFAULT_BLOCK_ROWS)
    call = lambda: dk.local_sdca(*bargs, loss=hinge)   # noqa: E731
    ms = in_turns("dense", libs, call, windows, name="dense paper (a window)")
    out["paper"] = {"ms": ms, "split": dense_split(
        libs[("dense", "stamped")], call, dk.LAST_DENSE_CONFIG["cluster"],
        windows, ms, "paper")}
    return out


def dense_split(lib, call, blocks, windows, ms, shape):
    """The dense walk's split (`read_stamps` of the dense group's stamped
    build): us a window of each phase of warp 0 ("scalar": the wait for the
    window's partials, their sums, the fix z = z' + H c, the loop, the
    hand-off of c) and of column warp 1 ("columns": the wait for a stage,
    the partials and their push, the wait for c, the update), each role's
    sum against the unstamped window and the stamped one."""
    split, ghz = read_stamps(lib, "dense", "sparse_sdca_zx", call, blocks)
    window = 1e3 * ms["full"] / windows
    stamped = 1e3 * ms["stamped"] / windows
    sums = {role: sum(parts.values()) for role, parts in split.items()}
    log(f"  dense {shape} split (SM clock {ghz:.3f} GHz), us a window: "
        + "; ".join(f"{role} " + ", ".join(f"{n} {v:.4f}"
                                           for n, v in parts.items())
                    + f" (sum {sums[role]:.4f})"
                    for role, parts in split.items())
        + f"; the unstamped window {window:.4f}, the stamped {stamped:.4f}")
    return dict(us=split, sum_us=sums, window_us=window,
                stamped_window_us=stamped, ghz=ghz)


if __name__ == "__main__":
    main()
