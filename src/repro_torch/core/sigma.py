"""Partition-difficulty quantities. Port of `repro.core.sigma`; only the
Lemma-3/4 safe bound so far (the power-iteration sigma_k and sigma'_min
are still to port)."""
from __future__ import annotations


def lemma3_safe_sigma(gamma: float, K: int) -> float:
    """The Lemma-3/4 safe subproblem bound sigma' = gamma * K, >= sigma'_min
    (eq. 11) for any data partition."""
    return float(gamma) * K
