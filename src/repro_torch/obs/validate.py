"""JSONL schema validator CLI: `python -m repro_torch.obs.validate run.jsonl`.

Port of `repro.obs.validate` (the schemas are the reference's, so either
package's files pass either validator).

Reads the metrics file `cocoa_train --metrics-out` (or any `JsonlSink`)
wrote and validates every line -- the CI gate that keeps the emitted
telemetry and the schemas from drifting apart. Two record schemas are
understood, sniffed per line by the `kind` field: `KernelProfile` rows
(which carry one) and `RoundRecord` rows (which don't). `--require-timing`
also insists every record carries nonzero measured time (the acceptance
bar for a real run; omit it for synthetic fixtures).

Cross-schema consistency: `--prof run.prof.jsonl` validates the profile
stream `cocoa_train --profile --metrics-out` emitted *and* checks that
every round profile's `round_global` matches a RoundRecord in the metrics
file -- the two streams describe the same certified rounds or the run
fails validation.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Set

from .metrics import validate_record
from .prof import validate_profile


def _validate_line(rec: dict, require_timing: bool) -> dict:
    """Dispatch one parsed record to its schema by sniffing `kind`
    (profiles carry it; RoundRecords don't)."""
    if "kind" in rec:
        out = validate_profile(rec)
        if require_timing and out["wall_s"] <= 0.0:
            raise ValueError("wall_s must be > 0 for a real run")
        return out
    out = validate_record(rec)
    if require_timing and out["execute_s"] <= 0.0:
        raise ValueError("execute_s must be > 0 for a real run")
    return out


def validate_file(path: str, require_timing: bool = False) -> int:
    """Validate every JSONL record in `path`; returns the last
    round_global covered (or the record count for kernel profiles),
    raises ValueError (with the line number) on the first bad row."""
    count = 0
    kernels = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = _validate_line(json.loads(line), require_timing)
                rg = rec.get("round_global")
                if rg is None:
                    kernels += 1        # kind="kernel" profiles, unordered
                    continue
                # round_global is monotone across solve segments (elastic /
                # failure restarts reset the in-call round, not this one)
                if rg <= count and count > 0:
                    raise ValueError(
                        f"round_global must be strictly increasing; "
                        f"{rg} after {count}")
                count = rg
            except (ValueError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e
    if count == 0 and kernels == 0:
        raise ValueError(f"{path}: no records")
    return count if count else kernels


def round_globals(path: str) -> Set[int]:
    """The set of round_global values in a validated JSONL stream."""
    out = set()
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rg = json.loads(line).get("round_global")
            if rg is not None:
                out.add(rg)
    return out


def check_cross(metrics_path: str, prof_path: str) -> int:
    """Every round profile must pair with a RoundRecord: its
    round_global set must be a subset of the metrics stream's (gap_every
    batching can certify rounds the profiler stream missed a restart
    for, but a profile of a round no record certifies is a lie).
    Returns the number of paired rounds."""
    rounds = round_globals(metrics_path)
    profs = round_globals(prof_path)
    orphans = sorted(profs - rounds)
    if orphans:
        raise ValueError(
            f"{prof_path}: round profiles {orphans} have no matching "
            f"RoundRecord in {metrics_path}")
    return len(profs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="JSONL metrics files")
    ap.add_argument("--require-timing", action="store_true",
                    help="fail records with zero measured time")
    ap.add_argument("--prof", default="",
                    help="KernelProfile JSONL to validate and cross-check "
                         "against the first metrics file (round_global "
                         "pairing)")
    args = ap.parse_args(argv)
    for path in args.paths:
        try:
            n = validate_file(path, require_timing=args.require_timing)
        except ValueError as e:
            print(f"INVALID {e}", file=sys.stderr)
            return 1
        print(f"ok {path}: rounds covered through {n}, schema valid")
    if args.prof:
        try:
            validate_file(args.prof, require_timing=args.require_timing)
            paired = check_cross(args.paths[0], args.prof)
        except ValueError as e:
            print(f"INVALID {e}", file=sys.stderr)
            return 1
        print(f"ok {args.prof}: {paired} round profiles paired with "
              f"{args.paths[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
