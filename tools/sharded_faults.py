#!/usr/bin/env python3
"""`chip_smoke.py` phases 24 and 25(a) alone, on the checkout and with
planted faults.

    python3 tools/sharded_faults.py [FAULT ...]     # default: 1 2 3 4 5

Needs one NVIDIA card and nvcc; run from the root of a checkout. Runs
the phase of each FAULT -- phase 24 (the sharded LM steps on a (data 2,
model 2) mesh of 4 ranks on `cuda:0`, each result held to the
one-process run) or phase 25(a) (llama4-scout's expert-parallel MoE on
that mesh, held to the grouped twin) -- once on the checkout, then once
for each FAULT, planted in a copy of the checkout in a temporary
directory (the checkout is not touched). Each fault is a bug a sharded
step could have, and its phase must fail on it:

  1. every rank's q heads (and the scan's input channels) shifted by one
     in `models/shards.py::local_kernel`: a rank attends with the wrong
     heads' queries;
  2. the embedding table's grad not summed over "data" in
     `models/shards.py::lookup_rows`: each data rank keeps only its own
     batch rows' grad;
  3. AdamW's global grad norm over this rank's shards only
     (`optim/adamw.py`), not the whole gradient;
  4. the expert-parallel MoE's local expert offset, base = tp index x
     E_loc, shifted by one (`models/layers.py::_moe_forward_shardmap`):
     a rank runs its tokens through its neighbour's experts (phase 25);
  5. the expert-parallel MoE's output not summed over "model" (the
     psum over tp skipped; resident, summed over fsdp only): a rank keeps
     its own experts' share (phase 25).

Prints each run's check lines (every reading beside its limit) and one
summary line a run; exits 1 when the checkout fails the phase or a fault
passes it.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAULTS = {
    "1": ("src/repro_torch/models/shards.py",
          "    out = kernel(*local, **kw)\n",
          "    out = kernel(local[0].roll(1, split[0]), *local[1:], **kw)\n"),
    "2": ("src/repro_torch/models/shards.py",
          "        Partial() if isinstance(t, Replicate) and isinstance(o, "
          "Shard)\n        else t for t, o in zip(tpl, opl)])",
          "        t for t, o in zip(tpl, opl)])"),
    "3": ("src/repro_torch/optim/adamw.py",
          "    gsq = sum(torch.sum(torch.square(grads[k].float())) for k in "
          "params)",
          "    gsq = sum(torch.sum(torch.square(getattr(grads[k], "
          "'_local_tensor', grads[k]).float())) for k in params)"),
    "4": ("src/repro_torch/models/layers.py",
          "    base = mesh.coords()[tp] * E_loc\n",
          "    base = mesh.coords()[tp] * E_loc + 1\n"),
    "5": ("src/repro_torch/models/layers.py",
          "    out = col.psum(out, g_tp if gather_w\n"
          "                   else mesh.subgroup((tp,) + fsdp_axes))\n",
          "    out = out if gather_w else col.psum(out, g_fs)\n"),
}
PHASE_OF = {"1": "24", "2": "24", "3": "24", "4": "25", "5": "25"}
PHASE = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
name, count, smi = C.phase_device()
sys.path.insert(0, "src")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rows = [{"name": "flash_attention", "launches": 0},
        {"name": "ssm_scan", "launches": 0}]
if "{phase}" == "24":
    C.phase_sharded(torch.device("cuda:0"), rows, smi)
else:
    C._phase_ep(torch.device("cuda:0"), rows, smi)
print("phase {phase} passed")
"""
SHOWN = ("limit", "FAIL", "phase 24 took", "spawn took", "written in",
         "one process:", "grouped twin:", "rank {", "Error")


def _phase(where: pathlib.Path, phase: str) -> bool:
    """Phase 24 or 25(a) in a fresh process from `where`; True when it
    passed."""
    run = subprocess.run([sys.executable, "-c",
                          PHASE.replace("{phase}", phase)],
                         cwd=where, capture_output=True, text=True,
                         timeout=900)
    for line in (run.stdout + run.stderr).splitlines():
        if any(s in line for s in SHOWN) and "Warning" not in line:
            print("  " + line.strip(), flush=True)
    return run.returncode == 0 and f"phase {phase} passed" in run.stdout


def _plant(where: pathlib.Path, fault: str) -> None:
    path, old, new = FAULTS[fault]
    text = (where / path).read_text()
    if text.count(old) != 1:
        raise SystemExit(f"fault {fault}: the line to change is not in "
                         f"{path} once")
    (where / path).write_text(text.replace(old, new))


def main() -> None:
    faults = sys.argv[1:] or sorted(FAULTS)
    unknown = set(faults) - set(FAULTS)
    if unknown:
        raise SystemExit(f"no fault {sorted(unknown)}; faults: "
                         f"{sorted(FAULTS)}")
    ok = True
    for phase in sorted({PHASE_OF[f] for f in faults}):
        print(f"== the checkout, phase {phase}", flush=True)
        passed = _phase(ROOT, phase)
        print(f"the checkout: phase {phase} "
              f"{'passed' if passed else 'FAILED'}", flush=True)
        ok = ok and passed
    for fault in faults:
        with tempfile.TemporaryDirectory() as tmp:
            copy = pathlib.Path(tmp) / "repo"
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                ".git", "__pycache__"))
            _plant(copy, fault)
            phase = PHASE_OF[fault]
            print(f"== fault {fault}: {FAULTS[fault][0]}, phase {phase}",
                  flush=True)
            caught = not _phase(copy, phase)
        print(f"fault {fault}: phase {phase} "
              f"{'failed, as it must' if caught else 'PASSED'}", flush=True)
        ok = ok and caught
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
