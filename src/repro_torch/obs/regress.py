"""Perf-regression gate over a bench history.

Port of `repro.obs.regress`: the same comparison, verdicts and exit codes.
A bench appends every run to an append-only trajectory
(`benchmarks/results/history/<name>.jsonl`); this CLI compares the
*latest* record's `payload["metrics"]` against a pinned baseline with a
multiplicative noise band and exits nonzero on regression:

    python -m repro_torch.obs.regress                    # gate (exit 1)
    python -m repro_torch.obs.regress --report-only      # CI phase-in
    python -m repro_torch.obs.regress --update-baseline  # pin current run

The port's default trajectory is `torch_autotune`, apart from the
reference's `autotune`: a card's seconds and a TPU's are never compared.
No baseline is committed for it, so the gate fails closed (exit 2) until
a run on the card is pinned with `--update-baseline`.

Verdicts per metric (metrics are seconds -- smaller is better):

    regression        latest > baseline * (1 + noise_band)
    improvement       latest < baseline * (1 - noise_band)
    within-noise      otherwise
    missing-baseline  metric genuinely new (readable baseline lacks it)

A baseline file that is *unreadable* -- missing, truncated, corrupt
JSON, or without a metrics dict -- is NOT the same as a new metric: it
means the gate cannot run at all, so it exits 2 (unless `--report-only`)
instead of silently passing everything as missing-baseline. Re-pin with
`--update-baseline` to restore the gate.

The default noise band is 0.5 (flag only >1.5x slower): wall-clock
jitters tens of percent run-to-run, and the gate's job is catching the 2x
cliffs -- a lost kernel config, a fall back to a plain version -- not 10%
drift. A baseline lives at `benchmarks/baselines/<name>.json` and is
re-pinned deliberately via `--update-baseline` when a legitimate perf
change lands.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional

REGRESS_SCHEMA_VERSION = 1
DEFAULT_NOISE_BAND = 0.5
DEFAULT_NAME = "torch_autotune"

_REPO = pathlib.Path(__file__).resolve().parents[3]


def default_history(name: str = DEFAULT_NAME) -> pathlib.Path:
    return _REPO / "benchmarks" / "results" / "history" / f"{name}.jsonl"


def default_baseline(name: str = DEFAULT_NAME) -> pathlib.Path:
    return _REPO / "benchmarks" / "baselines" / f"{name}.json"


def latest_record(history_path) -> Optional[dict]:
    """Last well-formed record of the history JSONL, or None."""
    try:
        lines = pathlib.Path(history_path).read_text().splitlines()
    except OSError:
        return None
    for ln in reversed(lines):
        ln = ln.strip()
        if not ln:
            continue
        try:
            return json.loads(ln)
        except ValueError:
            continue
    return None


def compare(latest: Dict[str, float], baseline: Dict[str, float],
            noise_band: float = DEFAULT_NOISE_BAND) -> List[dict]:
    """Verdict rows for every metric in `latest` (seconds, smaller is
    better). Pure -- the synthetic-history tests drive this directly."""
    rows = []
    for key in sorted(latest):
        cur = float(latest[key])
        if key not in baseline:
            rows.append(dict(metric=key, latest=cur, baseline=None,
                             ratio=None, verdict="missing-baseline"))
            continue
        base = float(baseline[key])
        ratio = cur / base if base > 0 else float("inf")
        if ratio > 1.0 + noise_band:
            verdict = "regression"
        elif ratio < 1.0 - noise_band:
            verdict = "improvement"
        else:
            verdict = "within-noise"
        rows.append(dict(metric=key, latest=cur, baseline=base,
                         ratio=ratio, verdict=verdict))
    return rows


def overall(rows: List[dict]) -> str:
    """Worst verdict: regression > missing-baseline > improvement >
    within-noise (missing-baseline does not gate -- it asks for a pin)."""
    order = ("regression", "missing-baseline", "improvement", "within-noise")
    for verdict in order:
        if any(r["verdict"] == verdict for r in rows):
            return verdict
    return "within-noise"


def format_rows(rows: List[dict], noise_band: float) -> str:
    out = [f"regress: noise band +/-{noise_band:.0%} (metrics are seconds)"]
    for r in rows:
        if r["baseline"] is None:
            out.append(f"  {r['metric']}: {r['latest']:.4g}s "
                       f"[missing-baseline]")
        else:
            out.append(f"  {r['metric']}: {r['latest']:.4g}s vs "
                       f"{r['baseline']:.4g}s ({r['ratio']:.2f}x) "
                       f"[{r['verdict']}]")
    return "\n".join(out)


def read_baseline(path) -> tuple:
    """(baseline dict, None) when the pinned baseline is usable, else
    (None, reason). Unreadable covers missing, corrupt/truncated JSON,
    and a payload without a metrics dict -- each a state in which the
    gate cannot compare anything, distinct from an individual metric
    being genuinely new (the per-metric missing-baseline verdict)."""
    p = pathlib.Path(path)
    try:
        payload = json.loads(p.read_text())
    except OSError:
        return None, f"no baseline at {p}"
    except ValueError:
        return None, f"baseline {p} is corrupt (not valid JSON)"
    if not isinstance(payload, dict) or \
            not isinstance(payload.get("metrics"), dict):
        return None, f"baseline {p} has no metrics dict"
    return payload, None


def write_baseline(path, metrics: Dict[str, float], *, ts: str = "",
                   noise_band: float = DEFAULT_NOISE_BAND) -> pathlib.Path:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        {"schema": REGRESS_SCHEMA_VERSION, "noise_band": noise_band,
         "source_ts": ts,
         "metrics": {k: float(v) for k, v in sorted(metrics.items())}},
        indent=1) + "\n")
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="compare the latest bench-history run to the pinned "
                    "baseline; exit 1 on regression")
    ap.add_argument("--history", default=None,
                    help=f"history JSONL (default: "
                         f"results/history/{DEFAULT_NAME}.jsonl)")
    ap.add_argument("--baseline", default=None,
                    help=f"pinned baseline JSON (default: "
                         f"baselines/{DEFAULT_NAME}.json)")
    ap.add_argument("--name", default=DEFAULT_NAME,
                    help="trajectory name used for both defaults")
    ap.add_argument("--noise-band", type=float, default=None,
                    help="override the band (default: baseline file's, "
                         f"else {DEFAULT_NOISE_BAND})")
    ap.add_argument("--report-only", action="store_true",
                    help="print verdicts but always exit 0 (CI phase-in)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="pin the latest run as the new baseline and exit")
    args = ap.parse_args(argv)

    history = pathlib.Path(args.history or default_history(args.name))
    baseline_path = pathlib.Path(args.baseline or default_baseline(args.name))

    rec = latest_record(history)
    if rec is None:
        print(f"regress: no history at {history} -- run the bench first "
              f"(the port's bench is ROADMAP.md Queue 1 item 12)")
        return 0 if args.report_only else 2
    metrics = rec.get("payload", {}).get("metrics", {})
    if not metrics:
        print(f"regress: latest record in {history} has no metrics")
        return 0 if args.report_only else 2

    if args.update_baseline:
        band = (args.noise_band if args.noise_band is not None
                else DEFAULT_NOISE_BAND)
        p = write_baseline(baseline_path, metrics, ts=rec.get("ts", ""),
                           noise_band=band)
        print(f"regress: pinned {len(metrics)} metrics from "
              f"{rec.get('ts', '?')} -> {p}")
        return 0

    base, problem = read_baseline(baseline_path)
    if problem is not None:
        print(f"regress: {problem} -- the perf gate cannot run; re-pin "
              f"with --update-baseline"
              + (" [report-only]" if args.report_only else ""))
        return 0 if args.report_only else 2
    band = (args.noise_band if args.noise_band is not None
            else float(base.get("noise_band", DEFAULT_NOISE_BAND)))
    rows = compare(metrics, base.get("metrics", {}), noise_band=band)
    print(format_rows(rows, band))
    verdict = overall(rows)
    print(f"regress: overall [{verdict}] (latest {rec.get('ts', '?')} vs "
          f"baseline {base.get('source_ts', 'none')})"
          + (" [report-only]" if args.report_only else ""))
    if verdict == "regression" and not args.report_only:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
