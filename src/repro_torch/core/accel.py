"""Accelerated outer rounds: momentum around the CoCoA+ round operator.

Port of `repro.core.accel` (Ma et al. 1711.05305). The round operator R
maps the carried pair -- the shared v-frame vector (`CoCoAState.w`,
v = A alpha / (tau n)) and the partitioned duals alpha -- one round
forward. Momentum composes outside it, extrapolating the pair:

    v_md     = v_t + beta_t (v_t - v_{t-1})
    alpha_md = alpha_t + beta_t (alpha_t - alpha_{t-1})
    v_{t+1}, alpha_{t+1} = R(v_md, alpha_md)

One beta for both legs keeps v_md = v(alpha_md) exactly (v is linear in
alpha), so the carried state stays self-consistent. The solvers, both
backends, the kernels and the wire stack never learn that the point they
were handed was extrapolated.

Schedules (`CoCoAConfig.accel`):

  "nesterov[:R]"   beta_t = t / (t + 3), t the state's round counter;
                   ":R" restarts the schedule every R rounds (t mod R).
  "catalyst:<k>"   q = 1 / (1 + kappa) and the alpha-recursion
                       a_t^2 = (1 - a_t) a_{t-1}^2 + q a_t,  a_0 = sqrt(q)
                       beta_t = a_{t-1} (1 - a_{t-1}) / (a_{t-1}^2 + a_t)

The schedule is float32 scalar arithmetic on the host, as the
reference's traced scalars are; beta reaches the device as a 0-d tensor.

The momentum leaves of `CoCoAState` (`v_prev`, `alpha_prev`, `accel_a`)
are None while accel="none". `v_prev` and `alpha_prev` live where w and
alpha do -- on a mesh each worker's own slices -- and the extrapolation
is elementwise, so acceleration moves zero extra floats (`comm.accel_hops`
prices that) and runs unchanged on a process mesh.

`solve` certifies at the carried, not the extrapolated, iterate, with
the duals passed through `loss.project`: an extrapolated coordinate may
sit a whisker outside the conjugate's domain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AccelSpec:
    """Parsed `CoCoAConfig.accel`. `kind` is "none" | "nesterov" |
    "catalyst"; `kappa` is Catalyst's prox weight, `restart` Nesterov's
    restart interval in rounds (0: never)."""
    kind: str = "none"
    kappa: float = 0.0
    restart: int = 0

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    @property
    def q(self) -> float:
        """Catalyst's strong-convexity ratio q = 1 / (1 + kappa)."""
        return 1.0 / (1.0 + self.kappa)

    @property
    def a0(self) -> float:
        """The alpha-recursion's start (sqrt(q) for catalyst; inert for
        nesterov)."""
        return math.sqrt(self.q) if self.kind == "catalyst" else 0.0

    def beta_limit(self) -> float:
        """The schedule's limiting momentum."""
        if self.kind == "catalyst":
            sq = math.sqrt(self.q)
            return (1.0 - sq) / (1.0 + sq)
        return 1.0 if self.kind == "nesterov" else 0.0


def parse_accel(s: Optional[str]) -> AccelSpec:
    """"none" | "nesterov[:<restart>]" | "catalyst:<kappa>"."""
    if s is None or s in ("", "none"):
        return AccelSpec("none")
    if s.startswith("nesterov"):
        _, _, arg = s.partition(":")
        restart = int(arg) if arg else 0
        if restart < 0 or (arg and restart == 0):
            raise ValueError(
                f"nesterov restart interval must be a positive round "
                f"count, got {arg!r} (plain 'nesterov' never restarts)")
        return AccelSpec("nesterov", restart=restart)
    if s.startswith("catalyst"):
        _, _, arg = s.partition(":")
        if not arg:
            raise ValueError(
                "catalyst needs its prox weight: accel='catalyst:<kappa>' "
                "(e.g. 'catalyst:10')")
        kappa = float(arg)
        if kappa <= 0:
            raise ValueError(f"catalyst kappa must be > 0, got {kappa}")
        return AccelSpec("catalyst", kappa)
    raise ValueError(f"unknown accel scheme {s!r}; expected 'none', "
                     f"'nesterov[:<restart>]', or 'catalyst:<kappa>'")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def nesterov_beta(t) -> torch.Tensor:
    """beta_t = t / (t + 3) in float32: 0 at t = 0 (the first round is
    plain), tending to 1."""
    tf = _f32(t)
    return tf / (tf + 3.0)


def catalyst_step(a_prev, q: float):
    """One alpha-recursion step: (a_new, beta_t), float32. a_new is the
    positive root of a^2 + (a_prev^2 - q) a - a_prev^2 = 0."""
    a_prev = _f32(a_prev)
    b = a_prev * a_prev - q
    a_new = 0.5 * (-b + torch.sqrt(b * b + 4.0 * a_prev * a_prev))
    beta = a_prev * (1.0 - a_prev) / (a_prev * a_prev + a_new)
    return a_new, beta


def momentum_coeffs(spec: AccelSpec, t, a_prev):
    """(a_new, beta_t) for round t: catalyst advances its recursion (t is
    ignored); nesterov passes the carried scalar through and restarts
    every `spec.restart` rounds when set."""
    if spec.kind == "catalyst":
        return catalyst_step(a_prev, spec.q)
    if spec.restart:
        t = int(t) % spec.restart
    return a_prev, nesterov_beta(t)


def wrap_round(round_fn: Callable, spec: AccelSpec) -> Callable:
    """The accelerated version of a round function `round_fn(state, ...)
    -> state`; under accel="none" `round_fn` itself. The wrapper
    extrapolates (w, alpha) with one beta_t, runs the round at the
    look-ahead pair, and re-attaches the momentum leaves the round's
    state rebuild dropped: v_prev <- v_t, alpha_prev <- alpha_t,
    accel_a <- a_new."""
    if not spec.enabled:
        return round_fn

    def accel_round(state, *args, **kwargs):
        if state.v_prev is None or state.alpha_prev is None \
                or state.accel_a is None:
            raise ValueError(
                "accelerated round needs the momentum leaves initialized: "
                "core.accel.init_accel_state(state, spec) before the loop "
                "(core.cocoa.solve does this)")
        v, alpha = state.w, state.alpha
        a_new, beta = momentum_coeffs(spec, state.rounds, state.accel_a)
        b = beta.to(v.dtype)
        v_md = v + b * (v - state.v_prev)
        alpha_md = alpha + b * (alpha - state.alpha_prev)
        inner = round_fn(state._replace(w=v_md, alpha=alpha_md),
                         *args, **kwargs)
        return inner._replace(v_prev=v, alpha_prev=alpha, accel_a=a_new)

    return accel_round


def init_accel_state(state, spec: AccelSpec):
    """Attach the momentum leaves where they are missing: (v_prev,
    alpha_prev) at the current pair, so the first round is exactly plain,
    and the recursion's scalar at `spec.a0`. Leaves already present (a
    state carried from an accelerated run) are kept."""
    if not spec.enabled:
        return state
    if state.v_prev is None:
        state = state._replace(v_prev=state.w)
    if state.alpha_prev is None:
        state = state._replace(alpha_prev=state.alpha)
    if state.accel_a is None:
        state = state._replace(accel_a=_f32(spec.a0))
    return state
