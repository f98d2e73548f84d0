"""Zero-dependency live terminal dashboard (`cocoa_train --dashboard`).

Port of `repro.obs.dashboard`, line for line: the same records render to
the same bytes in both packages.

An `EventBus` sink that redraws a fixed block in place on every certified
round (ANSI cursor-up on a tty; one compact appended line per record when
piped, so logs stay greppable). Monochrome by design -- identity is
carried by labels and position, never color; bold marks the headline
stats and dim marks the recessive chrome (axes, units), nothing else.

Layout (one screen, one scale per element):

    round 40/60  gap 3.21e-04  P 0.102311 D 0.101990   p50 12.4ms p99 19.8ms
    gap  1.0e-01 |##########----------------------------| 3.2e-04  (log10)
         trajectory  ▇▆▅▄▃▂▁▁ (last 48 certified rounds)
    wire 12,288 floats/round · 49.2 KiB · 1.1e6 floats/s
         hop reduce[data]  8 msg x 1536 = 12288
    comp 1.1e9 FLOP/s |#---------| 1.1% peak · 3.2e9 B/s |##--------| 16% HBM
    thru w0 ████████ 9.8e3  w1 ████ 5.1e3  ... steps/s (EMA)

The gap meter and sparkline share one log10 scale anchored at the first
certified gap; per-worker throughput bars share one linear scale. More
than 8 workers fold into a `+K more` tail rather than shrinking bars
below legibility. The compute/roofline row appears when a
`prof.RoundProfileSink` is wired in as `prof_source` (`cocoa_train
--profile --metrics-out --dashboard`): achieved FLOP/s and HBM-BW as
fractions of the profile's `HardwareSpec` peaks, plus the dominant
roofline term -- same tty/piped split as every other row.
"""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from .metrics import RoundRecord

_BLOCKS = " ▁▂▃▄▅▆▇█"
_MAX_WORKER_BARS = 8


def sparkline(values, width: int = 48, lo=None, hi=None) -> str:
    """Map `values` (linear) onto unicode block heights; the *last*
    `width` samples, one shared scale."""
    vals = [v for v in values if np.isfinite(v)][-width:]
    if not vals:
        return ""
    lo = min(vals) if lo is None else lo
    hi = max(vals) if hi is None else hi
    span = hi - lo
    if span <= 0:
        return _BLOCKS[4] * len(vals)
    out = []
    for v in vals:
        i = int(round((v - lo) / span * (len(_BLOCKS) - 2))) + 1
        out.append(_BLOCKS[max(1, min(i, len(_BLOCKS) - 1))])
    return "".join(out)


def _bar(frac: float, width: int) -> str:
    frac = min(max(frac, 0.0), 1.0)
    n = int(round(frac * width))
    return "#" * n + "-" * (width - n)


class Dashboard:
    """Render round records in place. `out` defaults to stdout; pass any
    text stream (tests use StringIO, which takes the non-tty path)."""

    def __init__(self, out=None, total_rounds: Optional[int] = None,
                 width: int = 72, prof_source=None):
        self.out = out if out is not None else sys.stdout
        self.total_rounds = total_rounds
        self.width = width
        # anything with a `.profiles` list of KernelProfiles (a
        # `prof.RoundProfileSink` subscribed *before* this dashboard, so
        # the matching profile exists by the time a record renders)
        self.prof_source = prof_source
        self._tty = bool(getattr(self.out, "isatty", lambda: False)())
        self._gaps: List[float] = []
        self._lines_drawn = 0

    # -- styling (tty only; piped output stays plain text) -------------------

    def _bold(self, s: str) -> str:
        return f"\x1b[1m{s}\x1b[0m" if self._tty else s

    def _dim(self, s: str) -> str:
        return f"\x1b[2m{s}\x1b[0m" if self._tty else s

    def emit(self, record: RoundRecord) -> None:
        self._gaps.append(record.gap)
        if self._tty:
            self._redraw(record)
        else:
            self.out.write(self._plain_line(record) + "\n")

    def close(self) -> None:
        if self._tty and self._lines_drawn:
            self.out.write("\n")
            self.out.flush()

    # -- rendering -----------------------------------------------------------

    def _profile_for(self, r: RoundRecord):
        """The round profile paired with this record, if a prof source is
        wired in and its latest profile shares the record's round_global."""
        profs = getattr(self.prof_source, "profiles", None)
        if not profs:
            return None
        p = profs[-1]
        return p if p.round_global == r.round_global else None

    def _plain_line(self, r: RoundRecord) -> str:
        ms = 1e3 * r.execute_s / r.rounds_in_record
        line = (f"round {r.round_global}: gap={r.gap:.3e} "
                f"P={r.primal:.6f} D={r.dual:.6f} "
                f"round_ms={ms:.1f} wire_floats={r.wire_floats}"
                + (f" compile_s={r.compile_s:.2f}" if r.compile_s else ""))
        p = self._profile_for(r)
        if p is not None:
            line += (f" flops_frac={p.flops_frac:.3g} "
                     f"bw_frac={p.bw_frac:.3g} dominant={p.dominant}")
        return line

    def _render(self, r: RoundRecord) -> List[str]:
        lines = []
        total = f"/{self.total_rounds}" if self.total_rounds else ""
        ms = 1e3 * r.execute_s / r.rounds_in_record
        lines.append(
            self._bold(f"round {r.round_global}{total}  gap {r.gap:.3e}")
            + f"  P {r.primal:.6f} D {r.dual:.6f}"
            + self._dim(f"  round {ms:.1f}ms"
                        + (f"  compile {r.compile_s:.2f}s"
                           if r.compile_s else "")))
        # gap meter + trajectory on one shared log10 scale anchored at the
        # first certified gap (progress reads left-to-right as a fill)
        finite = [g for g in self._gaps if np.isfinite(g) and g > 0]
        if finite:
            logs = np.log10(finite)
            lo, hi = float(logs.min()), float(logs.max())
            frac = ((hi - np.log10(max(r.gap, 1e-300))) / (hi - lo)
                    if hi > lo else 1.0)
            lines.append(f"gap  {10 ** hi:8.1e} |{_bar(frac, 38)}| "
                         f"{r.gap:8.1e} " + self._dim("(log10)"))
            # falling gap should read as a falling line: plot -log10(gap)
            lines.append("     " + sparkline(list(-logs), width=48)
                         + self._dim(f" last {min(len(finite), 48)} "
                                     f"certified rounds"))
        per_round = r.wire_floats // max(r.rounds_in_record, 1)
        lines.append(f"wire {per_round:,} floats/round"
                     + self._dim(f" · {4 * per_round / 1024:.1f} KiB · ")
                     + (f"{per_round * r.rounds_in_record / r.execute_s:.3g}"
                        " floats/s" if r.execute_s > 0 else "n/a"))
        for h in r.hops:
            measured = (f" (measured {h['measured_floats_round']})"
                        if "measured_floats_round" in h else "")
            lines.append(self._dim(
                f"     hop {h['hop']}[{h['axis']}]  {h['messages']} msg x "
                f"{h['floats_per_message']} = {h['floats']}{measured}"))
        p = self._profile_for(r)
        if p is not None:
            # achieved-vs-peak fraction bars (clamped at full; >100% means
            # the HardwareSpec understates this host, stated in the label)
            lines.append(
                f"comp {p.achieved_flops:.3g} FLOP/s "
                f"|{_bar(p.flops_frac, 10)}| {p.flops_frac:.1%} peak"
                + self._dim(" · ")
                + f"{p.achieved_bw:.3g} B/s |{_bar(p.bw_frac, 10)}| "
                  f"{p.bw_frac:.1%} HBM"
                + self._dim(f" · {p.dominant}-bound on {p.hw}, "
                            f"model/meas {p.model_vs_measured:.2f}"))
        if r.throughput:
            rates = list(r.throughput)
            shown = rates[:_MAX_WORKER_BARS]
            peak = max(shown) or 1.0
            cells = []
            for i, rate in enumerate(shown):
                bar = "█" * max(1, int(round(rate / peak * 8)))
                budget = (f"@{r.budgets[i]}" if r.budgets
                          and i < len(r.budgets) else "")
                cells.append(f"w{i} {bar} {rate:.2g}{budget}")
            tail = (self._dim(f" +{len(rates) - len(shown)} more")
                    if len(rates) > len(shown) else "")
            lines.append("thru " + "  ".join(cells) + tail
                         + self._dim(" steps/s (EMA)"))
        return lines

    def _redraw(self, r: RoundRecord) -> None:
        if self._lines_drawn:
            # cursor to the top of the previous block, clear to screen end
            self.out.write(f"\x1b[{self._lines_drawn}F\x1b[0J")
        lines = self._render(r)
        self.out.write("\n".join(lines) + "\n")
        self.out.flush()
        self._lines_drawn = len(lines)
