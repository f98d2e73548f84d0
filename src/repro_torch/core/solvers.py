"""Local solvers for the CoCoA+ subproblem and their registry.

Port of `repro.core.solvers`. The reference writes each solver for one
worker and vmaps it over K; here every solver takes all K workers at once,
with the K axis written out: X is (K, nk, d) or a `SparseShards`, the duals
and labels are (K, nk) and the shared v is (d,). The solvers flagged
`model_axis` also take a `FeatureShards` (K, M, nk, r_loc) and the padded
(M d_local,) v of a (data=K, model=M) mesh on one card. Each returns an
`SDCAResult` with dalpha (K, nk) and du (K, d), the sigma'-scaled v-space
delta (sigma'/(tau n)) A_[k] dalpha of every worker.

The reference draws its visit order inside the solver from a threefry key.
torch cannot reproduce threefry, so here the order is an explicit input,
and the two kinds are kept apart by `LocalSolver.visit`:

    "draws"        a (K, H) stream of uniform row ids -- the eager twins
                   `sdca` / `sdca_sparse` (the reference's
                   `jax.random.randint` at solvers.py:126 and :311)
    "permutation"  a (K, nk) row permutation per worker, walked for
                   round(H / nk) passes -- the kernel solvers
                   `sdca_kernel` / `sdca_sparse_kernel` (the reference's
                   `jax.random.permutation` at kernels/ops.py:88 and :206)
    "importance"   a (K, H) stream of row ids drawn with p_i ~ ||x_i||^2 +
                   mean ||x||^2 (`importance_probs`) -- `sdca_importance`
                   (the reference's `jax.random.choice(..., p=)` at
                   solvers.py:262)
    "none"         no visit input -- `gd`, which steps every row at once

The eager solvers are plain PyTorch loops: on the GPU they launch a dozen
tiny kernels per coordinate step, so there the kernel solvers are the
solver and the twins are what they are tested against on the CPU. The
deadline, importance and gradient solvers have no Pallas counterpart in
the reference either (they are jnp there); on the card they run as these
per-step loops.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Callable, NamedTuple, Optional

import torch

from ..comm.placement import WSpec
from ..comm.tracer import model_hops
from .losses import Loss
from .regularizers import L2, Regularizer


class SDCAResult(NamedTuple):
    dalpha: torch.Tensor    # (K, nk) local dual updates
    du: torch.Tensor        # (K, d)  = (sigma'/(tau n)) * A_[k] dalpha_k
    steps: int              # inner steps run per worker


def local_sdca(X, y, alpha, mask, v, idxs, loss: Loss, lam: float, n,
               sigma_p: float, H: int, reg: Regularizer = L2,
               sqnorms: Optional[torch.Tensor] = None) -> SDCAResult:
    """H randomized coordinate-ascent steps on G_k^{sigma'} for every worker.
    X (K, nk, d); `idxs` (K, H) row ids; `v` the shared scaled vector;
    `sqnorms` the rows' ||x_i||^2 (K, nk) when the caller hoisted them.
    The deadline solver's walk with no deadline."""
    return local_sdca_deadline(X, y, alpha, mask, v, idxs, loss, lam, n,
                               sigma_p, H, reg=reg, sqnorms=sqnorms)


def local_sdca_deadline(X, y, alpha, mask, v, idxs, loss: Loss, lam: float,
                        n, sigma_p: float, H: int, budget=None,
                        reg: Regularizer = L2,
                        sqnorms: Optional[torch.Tensor] = None
                        ) -> SDCAResult:
    """Straggler-tolerant LocalSDCA: worker k runs min(H, budget_k) of the
    H steps its (K, H) `idxs` stream lists, and its steps past the
    deadline are exact no-ops. `budget` is a python int (every worker; the
    loop itself stops at min(H, budget)), a (K,) tensor of per-worker
    budgets, or None (H). A per-worker budget equal to a static one gives
    the same result bit for bit, as the reference's traced and static
    budgets do (tests/test_solver_conformance.py). `steps` is the (K,)
    tensor of live steps (an int for a static budget)."""
    K, nk, _ = X.shape
    if sqnorms is None:
        sqnorms = torch.sum(X * X, dim=-1) * mask      # padded rows -> 0
    scale = sigma_p / (reg.tau(lam) * n)
    ks = torch.arange(K, device=X.device)
    idxs = idxs.to(X.device, torch.long)
    if budget is None or isinstance(budget, numbers.Integral):
        hmax = H if budget is None else min(int(H), int(budget))
        trip, live = hmax, None
    else:
        hmax = torch.clamp(torch.as_tensor(budget).long().cpu(), max=H)
        trip = int(hmax.max()) if hmax.numel() else 0
        live = hmax.to(X.device)
    dalpha = torch.zeros((K, nk), dtype=X.dtype, device=X.device)
    u = v.to(X.dtype).expand(K, -1).clone()
    for h in range(trip):
        i = idxs[:, h]
        x = X[ks, i]
        z = torch.sum(x * reg.conj_grad(u, lam), dim=-1)
        abar = alpha[ks, i] + dalpha[ks, i]
        q = scale * sqnorms[ks, i]
        delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
        if live is not None:
            # a worker past its deadline takes a zero step: dalpha and u
            # are left as they are
            delta = torch.where(h < live, delta, torch.zeros_like(delta))
        dalpha[ks, i] += delta
        u += (scale * delta)[:, None] * x
    return SDCAResult(dalpha, u - v, hmax)


def importance_probs(X, mask) -> torch.Tensor:
    """The (K, nk) row distribution of `local_sdca_importance`:
    p_i ~ ||x_i||^2 + mean ||x||^2 over the worker's real rows, masked."""
    sqnorms = torch.sum(X * X, dim=-1) * mask
    mean_sq = (torch.sum(sqnorms, dim=-1, keepdim=True)
               / torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0))
    probs = (sqnorms + mean_sq) * mask
    return probs / torch.sum(probs, dim=-1, keepdim=True)


def local_sdca_importance(X, y, alpha, mask, v, idxs, loss: Loss,
                          lam: float, n, sigma_p: float, H: int,
                          reg: Regularizer = L2,
                          sqnorms: Optional[torch.Tensor] = None
                          ) -> SDCAResult:
    """LocalSDCA with importance sampling: the same closed-form steps as
    `local_sdca`, over a (K, H) stream drawn from `importance_probs`
    (Zhao & Zhang-style mixed sampling; the draw is the caller's)."""
    return local_sdca(X, y, alpha, mask, v, idxs, loss, lam, n, sigma_p, H,
                      reg=reg, sqnorms=sqnorms)


def local_gd(X, y, alpha, mask, v, idxs, loss: Loss, lam: float, n,
             sigma_p: float, H: int, reg: Regularizer = L2,
             lr_scale: float = 1.0) -> SDCAResult:
    """Projected-gradient ascent on G_k over each worker's whole local
    batch -- the "arbitrary local solver" of Assumption 1. Takes no visit
    input (`idxs` is ignored).

    grad_i(n G_k) = -conj'(a_i + da_i) - x_i^T grad g*(tau v_loc), with
    v_loc = v + (sigma'/(tau n)) A da; step 1/L with L = sigma' max_i
    ||x_i||^2 nk / (tau n) + max(mu, 1), per worker; the iterate is
    projected onto the dual-feasible set after every step
    (`Loss.project`)."""
    if loss.conj_grad is None or loss.project is None:
        raise ValueError(f"local_gd needs a loss with conj_grad and "
                         f"project; {loss.name!r} has none")
    K, nk, _ = X.shape
    scale = sigma_p / (reg.tau(lam) * n)
    sqmax = torch.amax(torch.sum(X * X, dim=-1) * mask, dim=-1)     # (K,)
    lr = (lr_scale / (scale * sqmax * nk + max(loss.mu, 1.0)))[:, None]
    dalpha = torch.zeros((K, nk), dtype=X.dtype, device=X.device)
    u = v.to(X.dtype).expand(K, -1).clone()
    for _ in range(H):
        a = alpha + dalpha
        g = (-loss.conj_grad(a, y)
             - torch.einsum("kid,kd->ki", X, reg.conj_grad(u, lam))) * mask
        a_new = loss.project(a + lr * g, y) * mask
        step = a_new - a
        dalpha = dalpha + step
        u = u + scale * torch.einsum("kid,ki->kd", X, step)
    return SDCAResult(dalpha, u - v, H)


def local_sdca_sparse(shard, y, alpha, mask, v, idxs, loss: Loss, lam: float,
                      n, sigma_p: float, H: int, reg: Regularizer = L2,
                      sqnorms: Optional[torch.Tensor] = None,
                      model_axis: Optional[str] = None) -> SDCAResult:
    """LocalSDCA over padded-ELL shards: per step one r_max gather-dot
    through the conjugate map and one r_max scatter-axpy (scatter_add_,
    so duplicate columns all land). Padding slots are exact no-ops.

    `model_axis` set: the feature-sharded form. `shard` is a
    `FeatureShards` (cols (K, M, nk, r_loc), shard-local ids) and `v` the
    padded (M d_local,) vector; each step's partial dots are summed over
    the M shards in a fixed order (the reference's psum over the model
    axis), q comes from the global `sqnorms` (K, nk), which the slices
    cannot rebuild, and each shard's scatter touches its own slice only."""
    if model_axis is not None:
        if sqnorms is None:
            raise ValueError("feature-sharded local_sdca_sparse needs global "
                             "sqnorms; the local ELL slices can't rebuild "
                             "||x_i||^2")
        return _local_sdca_sparse_fs(shard, y, alpha, mask, v, idxs, loss,
                                     lam, n, sigma_p, H, reg, sqnorms)
    cols, vals = shard.cols.long(), shard.vals
    K, nk, _ = cols.shape
    if sqnorms is None:
        sqnorms = torch.sum(vals * vals, dim=-1) * mask
    scale = sigma_p / (reg.tau(lam) * n)
    ks = torch.arange(K, device=vals.device)
    idxs = idxs.to(vals.device, torch.long)
    dalpha = torch.zeros((K, nk), dtype=vals.dtype, device=vals.device)
    u = v.to(vals.dtype).expand(K, -1).clone()
    for h in range(H):
        i = idxs[:, h]
        ci, vi = cols[ks, i], vals[ks, i]
        z = torch.sum(vi * reg.conj_grad(u.gather(1, ci), lam), dim=-1)
        abar = alpha[ks, i] + dalpha[ks, i]
        q = scale * sqnorms[ks, i]
        delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
        dalpha[ks, i] += delta
        u.scatter_add_(1, ci, (scale * delta)[:, None] * vi)
    return SDCAResult(dalpha, u - v, H)


def _local_sdca_sparse_fs(fs, y, alpha, mask, v, idxs, loss, lam, n,
                          sigma_p, H, reg, sqnorms) -> SDCAResult:
    cols, vals = fs.cols.long(), fs.vals
    K, M, nk, _ = cols.shape
    d_loc = v.shape[0] // M
    scale = sigma_p / (reg.tau(lam) * n)
    ks = torch.arange(K, device=vals.device)
    idxs = idxs.to(vals.device, torch.long)
    dalpha = torch.zeros((K, nk), dtype=vals.dtype, device=vals.device)
    v3 = v.to(vals.dtype).reshape(1, M, d_loc)
    u = v3.expand(K, M, d_loc).clone()
    for h in range(H):
        i = idxs[:, h]
        ci, vi = cols[ks, :, i], vals[ks, :, i]            # (K, M, r_loc)
        zm = torch.sum(vi * reg.conj_grad(u.gather(2, ci), lam), dim=-1)
        z = zm[:, 0]
        for m in range(1, M):                 # the psum, in a fixed order
            z = z + zm[:, m]
        abar = alpha[ks, i] + dalpha[ks, i]
        q = scale * sqnorms[ks, i]
        delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
        dalpha[ks, i] += delta
        u.scatter_add_(2, ci, (scale * delta)[:, None, None] * vi)
    return SDCAResult(dalpha, (u - v3).reshape(K, M * d_loc), H)


# ----------------------------------------------------------------------------
# The LocalSolver registry: frozen descriptors + open registration
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalSolver:
    """A Theta-approximate local subproblem solver, by contract.

    `fn(X, y, alpha, mask, v, order, loss, lam, n, sigma_p, H, reg=)`
    returns an `SDCAResult` for all K workers. `X` is dense (K, nk, d)
    when `dense`, a `SparseShards` when `sparse`; `order` is the visit
    input of kind `visit` (see the module docstring). The capability
    flags, as the reference's:

        sparse_name  registry key of the padded-ELL counterpart the driver
                     maps to when the data is sparse
        model_axis   runs feature-sharded (M > 1): takes a `FeatureShards`
                     and the padded v, with `sqnorms=` (the global row
                     norms) and `model_axis=`; `model_hop(X, H, reg)` is
                     then its model-axis wire plan on the `FeatureShards`
                     X, a tuple of `comm.Hop`s (`comm.model_hops`)
        deadline     takes `budget=`, the round's step budget (an int, or
                     (K,) per worker)
        sqnorms      takes `sqnorms=`, the rows' ||x_i||^2 hoisted by the
                     driver once for the run
    """
    name: str
    fn: Callable[..., SDCAResult]
    dense: bool = True
    sparse: bool = False
    visit: str = "draws"
    sparse_name: Optional[str] = None
    model_axis: bool = False
    model_hop: Optional[Callable[..., tuple]] = None
    deadline: bool = False
    sqnorms: bool = False

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        if isinstance(other, str):
            return self.name == other
        return isinstance(other, LocalSolver) and self.name == other.name


SOLVERS: dict = {}
VISIT_KINDS = ("draws", "permutation", "importance", "none")


def register_solver(solver: LocalSolver, *,
                    overwrite: bool = False) -> LocalSolver:
    """Register a LocalSolver descriptor under its name."""
    if not isinstance(solver, LocalSolver):
        raise TypeError(f"register_solver wants a LocalSolver descriptor, "
                        f"got {type(solver).__name__}")
    if solver.visit not in VISIT_KINDS:
        raise ValueError(f"visit must be one of {VISIT_KINDS}, got "
                         f"{solver.visit!r}")
    if solver.model_axis and solver.model_hop is None:
        raise ValueError(f"solver {solver.name!r} runs feature-sharded "
                         f"(model_axis) but prices no model_hop")
    if solver.name in SOLVERS and not overwrite:
        raise ValueError(f"solver {solver.name!r} is already registered; "
                         f"pass overwrite=True to replace it")
    SOLVERS[solver.name] = solver
    return solver


def get_solver(name) -> LocalSolver:
    """LocalSolver descriptor by registry key (instances pass through)."""
    if isinstance(name, LocalSolver):
        return name
    try:
        return SOLVERS[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; registered: "
                       f"{sorted(SOLVERS)}") from None


def per_step_model_hops(X, H: int, reg: Regularizer = L2) -> tuple:
    """The eager feature-sharded `local_sdca_sparse`'s model-axis plan on
    the `FeatureShards` X: one partial dot per (worker, shard) per step."""
    return model_hops(WSpec(X.d, X.M, "model"), X.cols.shape[0], H)


def _lazy_kernel(attr: str) -> Callable[..., SDCAResult]:
    """Import-cycle-free binding for the kernel entry points
    (kernels.ops imports SDCAResult from here)."""
    def call(*args, **kwargs):
        from ..kernels import ops as kernel_ops
        return getattr(kernel_ops, attr)(*args, **kwargs)
    call.__name__ = attr
    return call


register_solver(LocalSolver("sdca", local_sdca, sparse_name="sdca_sparse",
                            sqnorms=True))
register_solver(LocalSolver("sdca_deadline", local_sdca_deadline,
                            deadline=True, sqnorms=True))
register_solver(LocalSolver("sdca_importance", local_sdca_importance,
                            visit="importance", sqnorms=True))
register_solver(LocalSolver("gd", local_gd, visit="none"))
register_solver(LocalSolver("sdca_sparse", local_sdca_sparse, dense=False,
                            sparse=True, model_axis=True,
                            model_hop=per_step_model_hops))
register_solver(LocalSolver(
    "sdca_kernel", _lazy_kernel("local_sdca_block"), visit="permutation",
    sparse_name="sdca_sparse_kernel"))
register_solver(LocalSolver(
    "sdca_sparse_kernel", _lazy_kernel("sparse_local_sdca_block"),
    dense=False, sparse=True, visit="permutation", model_axis=True,
    model_hop=_lazy_kernel("sparse_zx_model_hops")))


def sparse_counterpart(name) -> Optional[str]:
    """Registry key of the padded-ELL solver `name` resolves to on sparse
    inputs (itself when already sparse), or None when it has none."""
    ls = get_solver(name)
    if ls.sparse:
        return ls.name
    return ls.sparse_name
