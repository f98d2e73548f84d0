"""Node-failure handling for CoCoA+. Port of `repro.runtime.failures`.

Dual-safe drop: losing worker k's state = resetting alpha_[k] to 0. Any
alpha with alpha_[k] = 0 is still dual-feasible, so D(alpha) remains a valid
lower bound and the duality-gap certificate stays correct -- the run degrades
instead of corrupting. The shared w must then be re-derived as w(alpha)
(eq. 3) to stay consistent with the surviving duals; the data shard itself is
re-read from storage (here: regenerated/reloaded by the caller).

On a process mesh (`topo` from `comm.Topology.from_mesh`) every rank
calls these with its own block: only the rank that holds worker k zeroes
its rows, and the rebuild of v sums over the ranks' data rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import comm
from ..core import duality
from ..core.cocoa import CoCoAState
from ..core.regularizers import L2, Regularizer


def drop_worker(state: CoCoAState, k: int,
                topo: Optional[comm.Topology] = None) -> CoCoAState:
    """Zero worker k's duals (its machine died and lost local state), out
    of place.

    The error-feedback residual dies with the machine too: it is
    uncommunicated local compression debt, and zeroing it is always safe
    (EF residuals only affect future messages, never dual feasibility)."""
    if topo is not None and topo.process:
        if topo.worker != k:
            return state
        k = 0                    # the rank's block holds its worker alone

    def zeroed(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        t[k] = 0.0
        return t

    return state._replace(alpha=zeroed(state.alpha),
                          alpha_bar=zeroed(state.alpha_bar),
                          ef=zeroed(state.ef))


def recover_consistent_w(state: CoCoAState, X, mask, lam: float,
                         reg: Regularizer = L2,
                         topo: Optional[comm.Topology] = None) -> CoCoAState:
    """Recompute the shared state after a drop so it is consistent with the
    surviving duals. The state's leaf carries v = A alpha/(tau n) (the
    primal w is reg.conj_grad of it); under L2 this is exactly the old
    w(alpha) rebuild."""
    n = duality.effective_n(mask, topo)
    v = duality.v_of_alpha(X, state.alpha, lam, n, reg, topo)
    return state._replace(w=v)


def fail_and_recover(state: CoCoAState, X, mask, lam: float, k: int,
                     reg: Regularizer = L2,
                     topo: Optional[comm.Topology] = None) -> CoCoAState:
    return recover_consistent_w(drop_worker(state, k, topo), X, mask, lam,
                                reg, topo)
