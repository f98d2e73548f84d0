"""Pluggable aggregation for the CoCoA round: how partial updates combine.

Port of `repro.comm.aggregate`. Workers solve the sigma'-damped subproblem
and the driver applies

    v     <- v     + gamma * sum_k Delta v_k,     Delta v_k = du_k / sigma'
    alpha <- alpha + gamma * Delta alpha_k                       (Algorithm 1)

    add      gamma = 1,   sigma' = K    CoCoA+ (adding, Lemma 4)
    average  gamma = 1/K, sigma' = 1    original CoCoA (Remark 12)
    gamma:g  gamma = g,   sigma' = g*K  the full interpolation

`exchange` is the communication step (damp, compress, reduce or
gather), `apply_update` the gamma application and `flush_ef` the
uncompressed delivery of the error-feedback residuals.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .compress import Compressor, NoCompression, decode_sum
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
             compressor: Optional[Compressor] = None, gather: bool = False,
             stats: Optional[dict] = None, draws=None):
    """Communicate-and-reduce one round's local updates.

    Each worker's wire message is Delta v_k = du_k / sigma', compressed
    with error feedback, then reduced per the topology. `du`/`ef` are
    (K, d); on a feature-sharded topology (M > 1) they are (K, M d_local)
    and every step runs per model shard: each worker sends M messages of
    d_local floats with shard-local coordinates, and the reduce crosses
    the workers only. `draws` are the compressor's random draws, one row
    per worker (`Compressor.draw`), shared by a worker's model shards.

    With `gather=True` (a `supports_gather` sparsifier) the wire carries
    each worker's SparseMessage, the topology gathers the K sets, and the
    summed Delta v is rebuilt by scatter-add: the reduce moves ~2kK floats
    instead of dK. The transmitted x_hat and the EF residual equal the
    dense form's, so gather is a wire-routing choice, not an algorithm
    change. `stats`, when a dict is passed, receives the measured
    post-dedup hier gather volume (`inter_gather`), averaged over the
    model shards as the reference's per-shard tracer units need.

    Returns (dw_sum (d,), new_ef (K, d)), dw_sum already damped by
    1/sigma'."""
    comp = compressor if compressor is not None else NoCompression()
    if gather and not comp.supports_gather:
        raise ValueError(
            f"compressed gather needs a sparse-set compressor "
            f"(topk/randk); {comp.name!r} only has a dense wire form")
    K, width = du.shape
    M = topo.M
    x = du / params.sigma_prime
    if M > 1:
        x, ef = x.reshape(K, M, -1), ef.reshape(K, M, -1)
        if draws is not None:
            draws = draws.unsqueeze(1)
    if not gather:
        msg, ef = comp(x, ef, draws)
        return topo.all_sum(msg).reshape(width), ef.reshape(K, width)
    msg, ef = comp.encode(x, ef, draws)
    if M == 1:
        idx, val = topo.gather_sets(msg.idx, msg.val, width, stats)
        return decode_sum(idx, val, width), ef
    d_loc = width // M
    parts, wire = [], 0
    for m in range(M):
        shard_stats = {}
        idx, val = topo.gather_sets(msg.idx[:, m], msg.val[:, m], d_loc,
                                    shard_stats)
        parts.append(decode_sum(idx, val, d_loc))
        wire = wire + shard_stats.get("inter_gather", 0)
    if stats is not None and topo.reduce == "hier":
        stats["inter_gather"] = wire // M
    return torch.cat(parts), ef.reshape(K, width)


def apply_update(w, alpha, dw_sum, dalpha, params: AggParams):
    """Algorithm-1 line 9: the gamma application to (v, alpha). `dw_sum`
    comes from `exchange` (already 1/sigma'-damped)."""
    return w + params.gamma * dw_sum, alpha + params.gamma * dalpha


def flush_ef(w, ef, params: AggParams):
    """Send all outstanding error-feedback debt at once, uncompressed:
    w += gamma sum_k ef_k. The residuals are un-transmitted message mass
    (already 1/sigma'-damped), so this is what EF would eventually
    deliver; use it before the residual state is rebuilt or dropped."""
    return w + params.gamma * torch.sum(ef, dim=0)
