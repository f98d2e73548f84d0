"""Straggler mitigation via the paper's own Theta knob (Assumption 1).

Port of `repro.runtime.straggler`, on numpy (the rates) and torch (the
budgets a deadline solver takes). CoCoA+ only needs each local solver to
make *some* relative progress (Theta < 1); it never requires a fixed H.
So the round deadline is enforced by budgeting per-worker inner steps
from measured throughput instead of blocking on the slowest machine:

    budget_k = clip(throughput_k * round_deadline, H_min, H)

The tracker is fed from *measured* per-round timings: `core.cocoa.solve`
calls `observe_round(steps_done, round_execute_s)` with the fenced
wall-clock of every round when a tracker is attached (the `RoundRecord`
then carries both the budgets and the EMA rates). A `slowdown` vector
lets a simulated straggler run on real measurements with one worker's
clock scaled (the `--simulate-straggler` trainer flag) -- the budgets
still derive from observed time, not synthetic rates.
"""
from __future__ import annotations

import numpy as np
import torch


class ThroughputTracker:
    """EWMA steps/sec per worker, fed by round telemetry."""

    def __init__(self, K: int, init_rate: float = 1e4, beta: float = 0.8,
                 slowdown=None):
        self.rate = np.full(K, init_rate)
        self.beta = beta
        # per-worker wall-clock multiplier for simulated heterogeneity
        # (identity by default: measurements are taken at face value)
        self.slowdown = (np.ones(K) if slowdown is None
                         else np.asarray(slowdown, float))
        if self.slowdown.shape != (K,):
            raise ValueError(f"slowdown wants shape ({K},), got "
                             f"{self.slowdown.shape}")

    def update(self, steps_done: np.ndarray, elapsed_s: np.ndarray):
        inst = steps_done / np.maximum(elapsed_s, 1e-9)
        self.rate = self.beta * self.rate + (1 - self.beta) * inst

    def observe_round(self, steps_done, round_s: float) -> None:
        """Feed one measured round: `steps_done` is the per-worker inner
        steps actually run ((K,) array or a scalar broadcast to all
        workers) and `round_s` the fenced wall-clock of the round. In a
        bulk-synchronous round every worker shares the round's wall
        clock; the `slowdown` vector then scales each worker's effective
        elapsed time (1x everywhere outside simulations)."""
        steps = np.broadcast_to(np.asarray(steps_done, float),
                                self.rate.shape)
        elapsed = np.maximum(float(round_s), 1e-9) * self.slowdown
        self.update(steps, elapsed)

    def budgets(self, deadline_s: float, H_max: int,
                H_min: int = 16) -> torch.Tensor:
        return _clipped_budgets(self.rate, deadline_s, H_max, H_min)


def _clipped_budgets(rates, deadline_s: float, H_max: int,
                     H_min: int) -> torch.Tensor:
    """clip(rate * deadline, H_min, H_max) as a (K,) int32 tensor on the
    host, with the two failure modes closed: np.clip with H_max < H_min
    silently returns H_max everywhere (numpy clips with the upper bound
    last) -- reject the inverted interval instead; and a non-finite EMA
    rate cast straight to int64 is garbage (inf -> INT64_MIN on most
    platforms), so non-finite rates are pinned to the budget bounds
    *before* the cast: +inf (arbitrarily fast) -> H_max, NaN / -inf
    (unknown / nonsense) -> the conservative H_min."""
    if H_max < H_min:
        raise ValueError(f"H_max ({H_max}) must be >= H_min ({H_min})")
    raw = np.asarray(rates, float) * float(deadline_s)
    raw = np.nan_to_num(raw, nan=float(H_min), posinf=float(H_max),
                        neginf=float(H_min))
    b = np.clip(raw, H_min, H_max).astype(np.int64)
    return torch.as_tensor(b, dtype=torch.int32)


def budget_fn_from_rates(rates, deadline_s: float, H_max: int,
                         H_min: int = 16):
    """Stateless helper: per-round budget function for core.cocoa.solve."""
    b = _clipped_budgets(rates, deadline_s, H_max, H_min)
    return lambda t: b


def budget_fn_from_tracker(tracker: ThroughputTracker, deadline_s: float,
                           H_max: int, H_min: int = 16):
    """Deadline-budget function that re-reads the tracker every round, so
    budgets follow the measured EMA as `solve` feeds `observe_round` --
    the closed loop the deadline trainer runs on."""
    return lambda t: tracker.budgets(deadline_s, H_max, H_min)
