"""Pluggable aggregation for the CoCoA round: how partial updates combine.

Port of `repro.comm.aggregate`. Workers solve the sigma'-damped subproblem
and the driver applies

    v     <- v     + gamma * sum_k Delta v_k,     Delta v_k = du_k / sigma'
    alpha <- alpha + gamma * Delta alpha_k                       (Algorithm 1)

    add      gamma = 1,   sigma' = K    CoCoA+ (adding, Lemma 4)
    average  gamma = 1/K, sigma' = 1    original CoCoA (Remark 12)
    gamma:g  gamma = g,   sigma' = g*K  the full interpolation

`exchange` is the communication step (damp, compress, reduce) and
`apply_update` the gamma application.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from .compress import NoCompression
from .topology import Topology


class AggParams(NamedTuple):
    """The (gamma, sigma') pair a round runs with."""
    gamma: float
    sigma_prime: float


class Aggregator:
    """Strategy object producing the (gamma, sigma') pair for K workers."""
    name: str = "abstract"

    def params(self, K: int) -> AggParams:
        raise NotImplementedError


class Add(Aggregator):
    """CoCoA+ adding: gamma = 1 with the safe bound sigma' = K (Lemma 4)."""
    name = "add"

    def params(self, K: int) -> AggParams:
        return AggParams(1.0, _safe_sigma(1.0, K))


class Average(Aggregator):
    """Original CoCoA averaging: gamma = 1/K, sigma' = 1 (Remark 12)."""
    name = "average"

    def params(self, K: int) -> AggParams:
        return AggParams(1.0 / K, 1.0)


class GammaInterp(Aggregator):
    """gamma-interpolated aggregation with the matching safe bound
    sigma' = gamma * K; `Add` at gamma=1 and `Average` at gamma=1/K."""
    name = "gamma"

    def __init__(self, gamma: float):
        if not 0.0 < gamma <= 1.0:
            raise ValueError(f"gamma must be in (0, 1], got {gamma}")
        self.gamma = float(gamma)

    def params(self, K: int) -> AggParams:
        return AggParams(self.gamma, _safe_sigma(self.gamma, K))


def _safe_sigma(gamma: float, K: int) -> float:
    # late import: core.cocoa imports this module at load time, and a
    # top-level import of core.sigma would re-enter core/__init__ mid-import
    from ..core.sigma import lemma3_safe_sigma
    return lemma3_safe_sigma(gamma, K)


def resolve(spec) -> Aggregator:
    """Aggregator from a config string: "add" | "average"/"avg" | "gamma:<g>"."""
    if isinstance(spec, Aggregator):
        return spec
    if spec == "add":
        return Add()
    if spec in ("average", "avg"):
        return Average()
    if isinstance(spec, str) and spec.startswith("gamma:"):
        return GammaInterp(float(spec.split(":", 1)[1]))
    raise ValueError(f"unknown aggregator {spec!r}; "
                     f"use 'add', 'average', or 'gamma:<g>'")


def from_config(gamma: float, sigma_p: Optional[float], K: int,
                aggregator: Optional[str] = None) -> AggParams:
    """The round's (gamma, sigma'): a named strategy if one is set, else the
    explicit (gamma, sigma_p) pair with sigma_p=None meaning the safe bound."""
    if aggregator:
        return resolve(aggregator).params(K)
    sp = (float(sigma_p) if sigma_p is not None
          else _safe_sigma(gamma, K))
    return AggParams(float(gamma), sp)


def exchange(topo: Topology, du, ef, params: AggParams,
             compressor: Optional[NoCompression] = None):
    """Communicate-and-reduce one round's local updates, dense form.

    `du`/`ef` are (K, d): each worker's wire message is du_k / sigma',
    compressed with error feedback, then summed over the workers.
    Returns (dw_sum (d,), new_ef (K, d))."""
    comp = compressor if compressor is not None else NoCompression()
    msg, ef = comp(du / params.sigma_prime, ef)
    return topo.all_sum(msg), ef


def apply_update(w, alpha, dw_sum, dalpha, params: AggParams):
    """Algorithm-1 line 9: the gamma application to (v, alpha). `dw_sum`
    comes from `exchange` (already 1/sigma'-damped)."""
    return w + params.gamma * dw_sum, alpha + params.gamma * dalpha
