"""Loss functions, convex conjugates and closed-form SDCA coordinate updates.

Port of `repro.core.losses`: the same five losses, the same closed forms and
the same guards, on torch tensors. With l_i(z) := loss(z, y_i), the
single-coordinate update of the sigma'-damped subproblem maximizes

    J(delta) = -l_i*(-(abar + delta)) - delta * z - (q/2) delta^2

with abar = alpha_i + Delta alpha_i, z = x_i^T u and q = scale * ||x_i||^2.
Each Loss provides that argmax as `cd_update(abar, z, q, y)`.

    L   Lipschitz constant of l (None if not globally Lipschitz)
    mu  l is (1/mu)-smooth  <=>  l* is mu-strongly convex (0 if non-smooth)

`smoothing` carries smooth_hinge's g so the CUDA kernels can take it as a
number; it is 0 for the other losses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Loss:
    name: str
    # primal loss value l(z, y)
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # conjugate term as it appears in D: conj(a, y) = l*(-a)   (a = alpha_i)
    conj: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # closed-form coordinate maximizer of J(delta) above
    cd_update: Callable[..., torch.Tensor]
    # u_i with -u_i in d l_i(z)  (eq. 17)
    u_subgrad: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    L: Optional[float]
    mu: float
    # analytic d/da l*(-a) on the feasible set
    conj_grad: Optional[Callable] = None
    # projection of a dual candidate onto the feasible set
    project: Optional[Callable] = None
    # smooth_hinge's g (0 for every other loss)
    smoothing: float = 0.0

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Loss) and self.name == other.name


def _safe_div(a, b):
    return a / torch.where(b == 0, 1.0, b)


# ----------------------------------------------------------------------------
# Hinge loss:  l(z, y) = max(0, 1 - y z);  L = 1, non-smooth.
# l*(-a) = -a y   valid for a y in [0, 1]  (else +inf).
# ----------------------------------------------------------------------------

def _hinge_value(z, y):
    return torch.clamp(1.0 - y * z, min=0.0)


def _hinge_conj(a, y):
    b = a * y
    feasible = (b >= -1e-6) & (b <= 1.0 + 1e-6)
    return torch.where(feasible, -b, INF)


def _hinge_cd(abar, z, q, y):
    # beta = y*(abar+delta) in [0,1]; unconstrained opt beta* = y*abar + (1-yz)/q
    beta = y * abar + _safe_div(1.0 - y * z, q)
    beta = torch.clamp(beta, 0.0, 1.0)
    delta = y * beta - abar
    return torch.where(q == 0, 0.0, delta)


def _hinge_u(z, y):
    return torch.where(y * z < 1.0, y, 0.0)


def _box01_project(a, y):
    return y * torch.clamp(a * y, 0.0, 1.0)


HINGE = Loss("hinge", _hinge_value, _hinge_conj, _hinge_cd, _hinge_u,
             L=1.0, mu=0.0,
             conj_grad=lambda a, y: -y,
             project=_box01_project)


# ----------------------------------------------------------------------------
# Smoothed hinge, smoothing g (1.0 by default):
#   l(z,y) = 0 if yz >= 1;  1 - yz - g/2 if yz <= 1 - g;  (1-yz)^2/(2g) else
# l*(-a) = -ay + (g/2) a^2   for a y in [0,1].   (1/mu)-smooth with mu = g.
# ----------------------------------------------------------------------------

def make_smooth_hinge(g: float = 1.0) -> Loss:
    def value(z, y):
        m = y * z
        return torch.where(
            m >= 1.0, 0.0,
            torch.where(m <= 1.0 - g, 1.0 - m - g / 2.0,
                        (1.0 - m) ** 2 / (2.0 * g)))

    def conj(a, y):
        b = a * y
        feasible = (b >= -1e-6) & (b <= 1.0 + 1e-6)
        return torch.where(feasible, -b + (g / 2.0) * b * b, INF)

    def cd(abar, z, q, y):
        # solve y - g(abar+d) - z - q d = 0 for d, then project beta onto [0,1]
        d_unc = _safe_div(y - g * abar - z, g + q)
        beta = torch.clamp(y * (abar + d_unc), 0.0, 1.0)
        return y * beta - abar

    def u(z, y):
        m = y * z
        return y * torch.clamp((1.0 - m) / g, 0.0, 1.0)

    return Loss(f"smooth_hinge{g:g}", value, conj, cd, u, L=1.0, mu=g,
                conj_grad=lambda a, y: -y + g * a,
                project=_box01_project, smoothing=float(g))


SMOOTH_HINGE = make_smooth_hinge(1.0)


# ----------------------------------------------------------------------------
# Squared loss: l(z,y) = (z-y)^2 / 2;  1-smooth (mu=1), not Lipschitz.
# l*(-a) = a^2/2 - a y.
# ----------------------------------------------------------------------------

def _sq_value(z, y):
    return 0.5 * (z - y) ** 2


def _sq_conj(a, y):
    return 0.5 * a * a - a * y


def _sq_cd(abar, z, q, y):
    return (y - abar - z) / (1.0 + q)


def _sq_u(z, y):
    return y - z


SQUARED = Loss("squared", _sq_value, _sq_conj, _sq_cd, _sq_u, L=None, mu=1.0,
               conj_grad=lambda a, y: a - y,
               project=lambda a, y: a)


# ----------------------------------------------------------------------------
# Absolute loss: l(z,y) = |z - y|;  L = 1, non-smooth regression.
# l*(-a) = -a y  for |a| <= 1.
# ----------------------------------------------------------------------------

def _abs_value(z, y):
    return torch.abs(z - y)


def _abs_conj(a, y):
    feasible = torch.abs(a) <= 1.0 + 1e-6
    return torch.where(feasible, -a * y, INF)


def _abs_cd(abar, z, q, y):
    b = torch.clamp(abar + _safe_div(y - z, q), -1.0, 1.0)
    return torch.where(q == 0, 0.0, b - abar)


def _abs_u(z, y):
    return -torch.sign(z - y)


ABSOLUTE = Loss("absolute", _abs_value, _abs_conj, _abs_cd, _abs_u,
                L=1.0, mu=0.0,
                conj_grad=lambda a, y: -y,
                project=lambda a, y: torch.clamp(a, -1.0, 1.0))


# ----------------------------------------------------------------------------
# Logistic loss: l(z,y) = log(1 + exp(-y z));  L = 1, mu = 4.
# l*(-a): with beta = a y in [0,1]:  beta log beta + (1-beta) log(1-beta).
# No closed-form coordinate update -> guarded Newton on beta in (0,1).
# ----------------------------------------------------------------------------

def _xlogx(x):
    return torch.where(x <= 0.0, 0.0,
                       x * torch.log(torch.where(x <= 0.0, 1.0, x)))


def _log_value(z, y):
    return torch.logaddexp(torch.zeros_like(z), -y * z)


def _log_conj(a, y):
    b = a * y
    feasible = (b >= -1e-6) & (b <= 1.0 + 1e-6)
    bc = torch.clamp(b, 0.0, 1.0)
    return torch.where(feasible, _xlogx(bc) + _xlogx(1.0 - bc), INF)


def _log_cd(abar, z, q, y):
    # J'(beta) = log((1-beta)/beta) - y z - q (beta - y abar) = 0, beta in (0,1)
    # Newton with bisection guard, fixed 25 iterations (as the reference).
    yz = y * z
    yab = y * abar

    def g(beta):
        return torch.log1p(-beta) - torch.log(beta) - yz - q * (beta - yab)

    lo = torch.full_like(abar, 1e-12)
    hi = torch.full_like(abar, 1.0 - 1e-12)
    beta = torch.clamp(yab, 1e-6, 1.0 - 1e-6)
    for _ in range(25):
        gb = g(beta)
        lo = torch.where(gb > 0, beta, lo)   # g decreasing in beta
        hi = torch.where(gb <= 0, beta, hi)
        gp = -1.0 / (beta * (1.0 - beta)) - q
        nb = beta - gb / gp
        bad = (nb <= lo) | (nb >= hi) | ~torch.isfinite(nb)
        beta = torch.where(bad, 0.5 * (lo + hi), nb)
    return y * beta - abar


def _log_u(z, y):
    return y * torch.sigmoid(-y * z)


def _log_conj_grad(a, y):
    b = torch.clamp(a * y, 1e-6, 1.0 - 1e-6)
    return y * (torch.log(b) - torch.log1p(-b))


LOGISTIC = Loss("logistic", _log_value, _log_conj, _log_cd, _log_u,
                L=1.0, mu=4.0,
                conj_grad=_log_conj_grad,
                project=lambda a, y: y * torch.clamp(a * y, 0.0, 1.0))


LOSSES = {l.name: l for l in [HINGE, SMOOTH_HINGE, SQUARED, ABSOLUTE, LOGISTIC]}


def get_loss(name: str) -> Loss:
    if name in LOSSES:
        return LOSSES[name]
    if name.startswith("smooth_hinge"):
        return make_smooth_hinge(float(name[len("smooth_hinge"):] or 1.0))
    raise KeyError(f"unknown loss {name!r}; have {sorted(LOSSES)}")
