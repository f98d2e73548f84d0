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

The eager twins are plain PyTorch loops: on the GPU they would launch a
dozen tiny kernels per coordinate step, so there the kernel solvers are the
solver and the twins are what they are tested against on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .losses import Loss
from .regularizers import L2, Regularizer


class SDCAResult(NamedTuple):
    dalpha: torch.Tensor    # (K, nk) local dual updates
    du: torch.Tensor        # (K, d)  = (sigma'/(tau n)) * A_[k] dalpha_k
    steps: int              # inner steps run per worker


def local_sdca(X, y, alpha, mask, v, idxs, loss: Loss, lam: float, n,
               sigma_p: float, H: int, reg: Regularizer = L2) -> SDCAResult:
    """H randomized coordinate-ascent steps on G_k^{sigma'} for every worker.
    X (K, nk, d); `idxs` (K, H) row ids; `v` the shared scaled vector."""
    K, nk, _ = X.shape
    sqnorms = torch.sum(X * X, dim=-1) * mask          # padded rows -> 0
    scale = sigma_p / (reg.tau(lam) * n)
    ks = torch.arange(K, device=X.device)
    idxs = idxs.to(X.device, torch.long)
    dalpha = torch.zeros((K, nk), dtype=X.dtype, device=X.device)
    u = v.to(X.dtype).expand(K, -1).clone()
    for h in range(H):
        i = idxs[:, h]
        x = X[ks, i]
        z = torch.sum(x * reg.conj_grad(u, lam), dim=-1)
        abar = alpha[ks, i] + dalpha[ks, i]
        q = scale * sqnorms[ks, i]
        delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
        dalpha[ks, i] += delta
        u += (scale * delta)[:, None] * x
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
    input of kind `visit` ("draws" (K, H) or "permutation" (K, nk)).
    `sparse_name` is the registry key of the padded-ELL counterpart the
    driver maps to when the data is sparse. `model_axis` marks a solver
    that runs feature-sharded (M > 1): it takes a `FeatureShards` and the
    padded v, with `sqnorms=` (the global row norms) and `model_axis=`;
    `model_hop(X, H, reg)` is then the floats its model axis carries in
    one round on the `FeatureShards` X."""
    name: str
    fn: Callable[..., SDCAResult]
    dense: bool = True
    sparse: bool = False
    visit: str = "draws"
    sparse_name: Optional[str] = None
    model_axis: bool = False
    model_hop: Optional[Callable[..., int]] = None

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        if isinstance(other, str):
            return self.name == other
        return isinstance(other, LocalSolver) and self.name == other.name


SOLVERS: dict = {}
VISIT_KINDS = ("draws", "permutation")


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


def per_step_hop_floats(X, H: int, reg: Regularizer = L2) -> int:
    """Floats the model axis carries in one round of the eager
    feature-sharded `local_sdca_sparse`: one partial dot per (worker,
    shard) per step."""
    K, M = X.cols.shape[:2]
    return K * M * H


def _lazy_kernel(attr: str) -> Callable[..., SDCAResult]:
    """Import-cycle-free binding for the kernel entry points
    (kernels.ops imports SDCAResult from here)."""
    def call(*args, **kwargs):
        from ..kernels import ops as kernel_ops
        return getattr(kernel_ops, attr)(*args, **kwargs)
    call.__name__ = attr
    return call


register_solver(LocalSolver("sdca", local_sdca, sparse_name="sdca_sparse"))
register_solver(LocalSolver("sdca_sparse", local_sdca_sparse, dense=False,
                            sparse=True, model_axis=True,
                            model_hop=per_step_hop_floats))
register_solver(LocalSolver(
    "sdca_kernel", _lazy_kernel("local_sdca_block"), visit="permutation",
    sparse_name="sdca_sparse_kernel"))
register_solver(LocalSolver(
    "sdca_sparse_kernel", _lazy_kernel("sparse_local_sdca_block"),
    dense=False, sparse=True, visit="permutation", model_axis=True,
    model_hop=_lazy_kernel("sparse_zx_hop_floats")))


def sparse_counterpart(name) -> Optional[str]:
    """Registry key of the padded-ELL solver `name` resolves to on sparse
    inputs (itself when already sparse), or None when it has none."""
    ls = get_solver(name)
    if ls.sparse:
        return ls.name
    return ls.sparse_name
