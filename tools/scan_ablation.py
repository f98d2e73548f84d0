#!/usr/bin/env python3
"""Where a launch of the port's selective-scan kernel goes, on the card.

    python3 tools/scan_ablation.py [--src PATH] [--label NAME]
                                   [--out build/scan_ablation.json]

Needs one NVIDIA card and nvcc. Imports `repro_torch` from --src (default
this checkout's src/), so a parent checkout unpacked with `git archive`
ablates its own kernel. Builds variants of that checkout's
csrc/ssm_scan.cu, each with one part of the kernel taken out or replaced
by a cheaper one, and times every variant beside the unchanged kernel, in
turns by chip_smoke.py's `_in_turns` (two rounds of: variants in order,
then reversed; CUDA events, mean of 20 launches a turn after a warm-up
launch; the median of the four turns; the card's clocks first raised by
half a second of launches), at the scoring forward's shape: B 1, S 2,048,
d_inner 8,192, N 16, float32 (falcon-mamba-7b, `chip_smoke.py` phase
9). A variant computes something
else than the scan; only its time is read. The difference to the
unchanged kernel is what the part costs.

The variant set follows the source it finds:

  lane_per_state  (one lane per (b, c, n), the first port)
      no_shfl     y's four shuffles over n taken out
      no_bcast    x and dt not read from shared memory (the 16 lanes of a
                  channel each re-read them); a value made from t instead
      no_wait     each chunk's staging loads taken out after the first
                  chunk (the block runs from a chunk already in shared
                  memory; its barriers stay)
      no_exp      expf(dt a) replaced by 1 + dt a
  state_groups    (a thread owns one channel and G states)
      no_exp      as above
      fast_exp    expf by __expf (ex2.approx of x log2 e: no range
                  reduction)
      exp2f       A scaled by log2 e once, expf(dt a) by exp2f(dt a'): the
                  same function, the MUFU and no range reduction
      ex2_ftz     as exp2f, by ex2.approx.ftz.f32 itself
      poly_exp    every exp by exp_poly, on the FMA pipe (no MUFU)
      poly_half   the odd states' exps by exp_poly, the rest by expf
      poly_quarter  one state in four by exp_poly
      no_wait     the cp.async copies taken out after the second chunk
                  (the stages then hold chunks 0 and 1)
      no_xdt      x_t and dt_t not read from shared memory (a value made
                  from t instead)
      no_out      the stores of y (a chunk's partials summed) taken out
      no_bc       B_t and C_t from registers instead of shared memory
      steps2      batches of 2 steps a thread, not 4 (not a part taken
      steps8      out: the batch length, 2 or 8)
      chunk32     chunks of 32 or 128 steps, not 64 (not a part taken
      chunk128    out: the chunk length)

For the state-group kernel it then reads the card's SM clock and power
beside a second of launches (nvidia-smi, every 100 ms), and sweeps every
G the library holds (4, 8, 16 states a thread) at each chunk length (the
chunk32 and chunk128 variants and the kernel), in turns, each held to the
plain version at chip_smoke.py's tolerance (rtol 2e-4, atol 2e-5 max(1, max
|p|)). Each variant's replacements must match the source once, or the
run fails: an edit of the kernel that moves the text shows here. Prints
the card's name and power limit, every time, and one JSON line (also
written to --out).
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
SHAPE = dict(B=1, S=2_048, di=8_192, N=16)
REPS = 20
ROUNDS = 2
A_LOAD = "a[g] = n < N && c < di ? A[static_cast<size_t>(c) * N + n] : 0.0f;"
A_LOAD_LOG2E = ("a[g] = (n < N && c < di ? A[static_cast<size_t>(c) * N + n]"
                " : 0.0f) * 1.44269504f;")
# exp(x) on the FMA pipe, for the poly_* variants: the exponent's integer
# part j rounded in the mantissa of x log2 e + 1.5 2^23, r = x - j ln 2 in
# two parts, a degree-6 Taylor polynomial of e^r on |r| <= ln 2 / 2
# (relative error ~1.2e-7), scaled by 2^j through the exponent bits; x
# clamped to [-87, 88.7].
EXP_POLY = """
__device__ __forceinline__ float exp_poly(float x) {
  x = fminf(fmaxf(x, -87.0f), 88.7f);
  const float t = fmaf(x, 1.44269504f, 12582912.0f);
  const float j = t - 12582912.0f;
  float r = fmaf(j, -0.693145752f, x);
  r = fmaf(j, -1.42860677e-06f, r);
  float p = fmaf(r, 1.0f / 720.0f, 1.0f / 120.0f);
  p = fmaf(p, r, 1.0f / 24.0f);
  p = fmaf(p, r, 1.0f / 6.0f);
  p = fmaf(p, r, 0.5f);
  p = fmaf(p, r, 1.0f);
  p = fmaf(p, r, 1.0f);
  return __int_as_float(__float_as_int(p) +
                        ((__float_as_int(t) - 0x4B400000) << 23));
}

"""
STATES_NOTE = "// G consecutive floats of a B or C row"
WITH_EXP_POLY = (STATES_NOTE, EXP_POLY + STATES_NOTE)
EX2_FTZ = ("[&] { float r; asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(r) "
           ": \"f\"(dv[u] * a[g])); return r; }()")
VARIANTS = {
    "lane_per_state": {
        "no_shfl": [("      yp += __shfl_xor_sync(0xffffffffu, yp, 8);\n"
                     "      yp += __shfl_xor_sync(0xffffffffu, yp, 4);\n"
                     "      yp += __shfl_xor_sync(0xffffffffu, yp, 2);\n"
                     "      yp += __shfl_xor_sync(0xffffffffu, yp, 1);\n",
                     "")],
        "no_bcast": [("      const float xv = xs[tt][cl];\n"
                      "      const float dv = dts[tt][cl];",
                      "      const float xv = 1e-3f * tt;\n"
                      "      const float dv = xv;")],
        "no_wait": [("      const bool in = tt < tn && c0 + cc < di;\n"
                     "      const size_t off",
                     "      if (t0 > 0) break;\n"
                     "      const bool in = tt < tn && c0 + cc < di;\n"
                     "      const size_t off"),
                    ("      const bool in = tt < tn && nn < N;",
                     "      if (t0 > 0) break;\n"
                     "      const bool in = tt < tn && nn < N;")],
        "no_exp": [("expf(dv * a)", "(1.0f + dv * a)")],
    },
    "state_groups": {
        "no_exp": [("expf(dv[u] * a[g])", "(1.0f + dv[u] * a[g])")],
        "fast_exp": [("expf(dv[u] * a[g])", "__expf(dv[u] * a[g])")],
        "exp2f": [(A_LOAD, A_LOAD_LOG2E),
                  ("expf(dv[u] * a[g])", "exp2f(dv[u] * a[g])")],
        "ex2_ftz": [(A_LOAD, A_LOAD_LOG2E),
                    ("expf(dv[u] * a[g])", EX2_FTZ)],
        "poly_exp": [WITH_EXP_POLY,
                     ("expf(dv[u] * a[g])", "exp_poly(dv[u] * a[g])")],
        "poly_half": [WITH_EXP_POLY,
                      ("expf(dv[u] * a[g])",
                       "(g % 2 ? exp_poly(dv[u] * a[g])"
                       " : expf(dv[u] * a[g]))")],
        "poly_quarter": [WITH_EXP_POLY,
                         ("expf(dv[u] * a[g])",
                          "(g % 4 == 3 ? exp_poly(dv[u] * a[g])"
                          " : expf(dv[u] * a[g]))")],
        "no_wait": [("if (k + 1 < nchunks) {",
                     "if (k + 1 < min(nchunks, 2)) {")],
        "no_xdt": [("    xv[u] = xs[(t + u) * CH + lane];\n"
                    "    dv[u] = dts[(t + u) * CH + lane];",
                    "    xv[u] = 1e-3f * (t + u);\n"
                    "    dv[u] = xv[u];")],
        "no_out": [("if (vec_y) {", "if (vec_y < 0) {"),
                   ("  } else {\n    for (int i = tid; i < tn * CH;",
                    "  } else if (vec_y < 0) {\n"
                    "    for (int i = tid; i < tn * CH;")],
        "no_bc": [("load_states<G>(Bs + o, bv[u]);",
                   "for (int g = 0; g < G; ++g) bv[u][g] = dv[u];"),
                  ("load_states<G>(Cs + o, cv[u]);",
                   "for (int g = 0; g < G; ++g) cv[u][g] = xv[u];")],
        "steps2": [("constexpr int STEPS = 4;", "constexpr int STEPS = 2;")],
        "steps8": [("constexpr int STEPS = 4;", "constexpr int STEPS = 8;")],
        "chunk32": [("constexpr int T = 64;", "constexpr int T = 32;")],
        "chunk128": [("constexpr int T = 64;", "constexpr int T = 128;")],
    },
}
# the state-group kernel's builds by chunk length, for the G sweep
CHUNKS = {"chunk32": 32, "full": 64, "chunk128": 128}
MARKERS = {"lane_per_state": "constexpr int LANES = 16;",
           "state_groups": "SSM_SCAN_GROUPS("}


def log(msg):
    print(msg, flush=True)


def variant_libs(csrc: pathlib.Path, base: pathlib.Path):
    """(set name, {variant: loaded library}): every variant of
    csrc/ssm_scan.cu, built in parallel ("full": unchanged)."""
    import ctypes
    from repro_torch.kernels import build
    text = (csrc / "ssm_scan.cu").read_text()
    found = [k for k, m in MARKERS.items() if m in text]
    if len(found) != 1:
        raise SystemExit(f"scan_ablation: cannot tell the kernel's design "
                         f"from {csrc / 'ssm_scan.cu'} ({found})")
    kind = found[0]
    procs = {}
    for name, edits in {"full": [], **VARIANTS[kind]}.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"scan_ablation {kind} {name}: {old!r} "
                                 f"found {src.count(old)} times")
            src = src.replace(old, new)
        d = base / name
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        (d / "ssm_scan.cu").write_text(src)
        out = d / "ssm_scan.so"
        procs[name] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o",
             str(out), str(d / "ssm_scan.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log_text}")
        if name == "full":
            for line in log_text.splitlines():
                if any(k in line for k in ("registers", "spill")):
                    log(f"    {line.strip()}")
        lib = ctypes.CDLL(str(out))
        build._bind("ssm_scan", lib)
        libs[name] = lib
    return kind, libs


def clocks_during(fn, seconds=1.0):
    """{"sm_mhz": [min, median, max], "watts": [...]} from nvidia-smi,
    sampled every 100 ms while `fn` is launched for `seconds`."""
    import torch
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")] for line in
            out.strip().splitlines() if line.count(",") == 1]
    spread = lambda v: [min(v), sorted(v)[len(v) // 2], max(v)] if v else []
    return {"sm_mhz": spread([r[0] for r in rows]),
            "watts": spread([r[1] for r in rows])}


def sass_text(path: pathlib.Path) -> str:
    """cuobjdump -sass of the library at `path`."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300).stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default="build/scan_ablation.json")
    ap.add_argument("--sass", default=None,
                    help="also write the library's SASS to this file")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scan_ablation: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build, ssm_scan as ss
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"[scan ablation] {args.label} ({src}); {smi}; torch "
        f"{torch.__version__}")
    t0 = time.perf_counter()
    kind, libs = variant_libs(build.CSRC, ROOT / "build" / "scan_ablation"
                              / args.label.replace(" ", "_"))
    log(f"  {kind}: {len(libs)} variants built in "
        f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    ins = cs._scan_case(rng, SHAPE["B"], SHAPE["S"], SHAPE["di"], SHAPE["N"],
                        dev)
    result = {"device": smi, "label": args.label, "design": kind,
              "shape": SHAPE}

    def with_lib(n):
        build._LIBS["ssm_scan"] = libs[n]
        return ss.ssm_scan(*ins)

    ms, _ = cs._in_turns(list(libs), with_lib, reps=REPS, rounds=ROUNDS)
    want = ss.ssm_scan_plain(*ins)
    errs = {}
    for n in libs:
        build._LIBS["ssm_scan"] = libs[n]
        errs[n] = float((ss.ssm_scan(*ins) - want).abs().max())
    build._LIBS.pop("ssm_scan", None)
    log(f"  max |y - plain| of each variant (the plain version's max |y| "
        f"{float(want.abs().max()):.3e}): " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()))
    result["variants_max_abs_err"] = errs
    for n, t in ms.items():
        log(f"  {n:12s} {t:8.4f} ms a launch, {t - ms['full']:+8.4f} ms "
            f"against the kernel")
    result["variants_ms"] = ms

    if args.sass:
        pathlib.Path(args.sass).write_text(
            sass_text(pathlib.Path(build.load("ssm_scan")._name)))

    if kind == "state_groups":
        result["clocks"] = clocks_during(lambda: ss.ssm_scan(*ins))
        log(f"  SM clock and power beside a second of launches of the "
            f"default instance: {result['clocks']}")
        scale = max(1.0, float(want.abs().max()))
        keys = [(g, n) for n in CHUNKS for g in ss.GROUPS]
        bad = []

        def held(key, got):
            a, _, ok = cs._errors(got, want, cs.SCAN_ATOL * scale,
                                  cs.SCAN_RTOL)
            if not ok:
                bad.append((key, a))

        def with_group(key):
            build._LIBS["ssm_scan"] = libs[key[1]]
            return ss.ssm_scan(*ins, group=key[0])
        sweep, _ = cs._in_turns(keys, with_group, reps=REPS, rounds=ROUNDS,
                                each=held)
        build._LIBS.pop("ssm_scan", None)
        for (g, n), t in sweep.items():
            plan = ss.scan_launch_plan(SHAPE["B"], SHAPE["S"], SHAPE["di"],
                                       SHAPE["N"], group=g)
            log(f"  G={g:2d} chunk={CHUNKS[n]:3d}: {t:8.4f} ms a launch "
                f"({plan['threads']} threads a block)")
        result["sweep_ms"] = {f"G={g} chunk={CHUNKS[n]}": t
                              for (g, n), t in sweep.items()}
        if bad:
            raise SystemExit(f"scan_ablation: instances disagree with the "
                             f"plain version: {bad}")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    log(smi)
    log(json.dumps(result))


if __name__ == "__main__":
    main()
