#!/usr/bin/env python3
"""`chip_smoke.py` phase 24 alone, on the checkout and with planted faults.

    python3 tools/sharded_faults.py [FAULT ...]     # default: 1 2 3

Needs one NVIDIA card and nvcc; run from the root of a checkout. Runs
phase 24 (the sharded LM steps on a (data 2, model 2) mesh of 4 ranks on
`cuda:0`, each result held to the one-process run) once on the checkout,
then once for each FAULT, planted in a copy of the checkout in a
temporary directory (the checkout is not touched). Each fault is a bug a
sharded step could have, and phase 24 must fail on it:

  1. every rank's q heads (and the scan's input channels) shifted by one
     in `models/shards.py::local_kernel`: a rank attends with the wrong
     heads' queries;
  2. the embedding table's grad not summed over "data" in
     `models/shards.py::lookup_rows`: each data rank keeps only its own
     batch rows' grad;
  3. AdamW's global grad norm over this rank's shards only
     (`optim/adamw.py`), not the whole gradient.

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
}
PHASE = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
name, count, smi = C.phase_device()
sys.path.insert(0, "src")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.phase_sharded(torch.device("cuda:0"), [
    {"name": "flash_attention", "launches": 0},
    {"name": "ssm_scan", "launches": 0}], smi)
print("phase 24 passed")
"""
SHOWN = ("limit", "FAIL", "phase 24 took", "spawn took", "written in",
         "one process:", "rank {", "Error")


def _phase(where: pathlib.Path) -> bool:
    """Phase 24 in a fresh process from `where`; True when it passed."""
    run = subprocess.run([sys.executable, "-c", PHASE], cwd=where,
                         capture_output=True, text=True, timeout=900)
    for line in (run.stdout + run.stderr).splitlines():
        if any(s in line for s in SHOWN) and "Warning" not in line:
            print("  " + line.strip(), flush=True)
    return run.returncode == 0 and "phase 24 passed" in run.stdout


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
    print("== the checkout", flush=True)
    ok = _phase(ROOT)
    print(f"the checkout: phase 24 {'passed' if ok else 'FAILED'}",
          flush=True)
    for fault in faults:
        with tempfile.TemporaryDirectory() as tmp:
            copy = pathlib.Path(tmp) / "repo"
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                ".git", "__pycache__"))
            _plant(copy, fault)
            print(f"== fault {fault}: {FAULTS[fault][0]}", flush=True)
            caught = not _phase(copy)
        print(f"fault {fault}: phase 24 "
              f"{'failed, as it must' if caught else 'PASSED'}", flush=True)
        ok = ok and caught
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
