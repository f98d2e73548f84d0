"""Regularizers, their convex conjugates and the v -> w primal map.

Port of `repro.core.regularizers`. Everything works in the tau-scaled frame
v := A alpha / (tau n), where tau is the strong-convexity constant of g:

    value(w, lam)       g(w)                      (primal penalty)
    conj(v, lam)        g*(tau v)                 (dual penalty at scaled v)
    conj_grad(v, lam)   grad g*(tau v)            (the v -> w map)
    tau(lam)            strong-convexity constant of g
    prox_kappa(lam)     the scalar soft-threshold of conj_grad (0 for L2),
                        which the sparse CUDA kernel fuses per gathered entry

Instances: `L2` (the paper's setup, conj_grad the identity),
`make_elastic_net(eta)` and `make_smoothed_l1(eps)`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def soft_threshold(v, kappa):
    """sign(v) * max(|v| - kappa, 0), elementwise (kappa >= 0)."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - kappa, min=0.0)


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """A tau(lam)-strongly-convex regularizer in the scaled dual frame."""
    name: str
    value: Callable[[torch.Tensor, float], torch.Tensor]
    conj: Callable[[torch.Tensor, float], torch.Tensor]
    conj_grad: Callable[[torch.Tensor, float], torch.Tensor]
    tau: Callable[[float], float]
    prox_kappa: Optional[Callable[[float], float]] = None
    family: str = "other"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Regularizer) and self.name == other.name


L2 = Regularizer(
    "l2",
    value=lambda w, lam: 0.5 * lam * torch.dot(w, w),
    conj=lambda v, lam: 0.5 * lam * torch.dot(v, v),
    conj_grad=lambda v, lam: v,
    tau=lambda lam: lam,
    prox_kappa=lambda lam: 0.0,
    family="l2",
)


# Elastic net: g = lambda (eta ||w||_1 + (1-eta)/2 ||w||^2), 0 <= eta < 1.
# At u = tau v the soft-threshold is eta/(1-eta) (lambda cancels) and
# g*(tau v) = (tau/2) ||conj_grad(v)||^2.

def make_elastic_net(eta: float) -> Regularizer:
    if not 0.0 <= eta < 1.0:
        raise ValueError(f"elastic-net eta must be in [0, 1) -- eta=1 is "
                         f"pure L1, which is not strongly convex; use "
                         f"SmoothedL1(eps) for the Lasso regime (got {eta})")
    kappa = eta / (1.0 - eta)

    def value(w, lam):
        return lam * (eta * torch.sum(torch.abs(w))
                      + 0.5 * (1.0 - eta) * torch.dot(w, w))

    def conj(v, lam):
        s = soft_threshold(v, kappa)
        return 0.5 * lam * (1.0 - eta) * torch.dot(s, s)

    return Regularizer(f"elastic{eta!r}", value, conj,
                       conj_grad=lambda v, lam: soft_threshold(v, kappa),
                       tau=lambda lam: lam * (1.0 - eta),
                       prox_kappa=lambda lam: kappa,
                       family="elastic")


# Smoothed L1: g = lambda ||w||_1 + (eps/2)||w||^2; tau = eps and the
# scaled-frame threshold is lambda/eps (lam does not cancel here).

def make_smoothed_l1(eps: float) -> Regularizer:
    if eps <= 0.0:
        raise ValueError(f"smoothed-L1 needs eps > 0 (the strong-convexity "
                         f"floor), got {eps}")

    def value(w, lam):
        return lam * torch.sum(torch.abs(w)) + 0.5 * eps * torch.dot(w, w)

    def conj(v, lam):
        s = soft_threshold(v, lam / eps)
        return 0.5 * eps * torch.dot(s, s)

    return Regularizer(f"l1s{eps!r}", value, conj,
                       conj_grad=lambda v, lam: soft_threshold(v, lam / eps),
                       tau=lambda lam: eps,
                       prox_kappa=lambda lam: lam / eps,
                       family="l1s")


REGULARIZERS = {"l2": L2}


def get_regularizer(spec) -> Regularizer:
    """Regularizer from a config string:
    "l2" | "elastic:<eta>" | "l1s:<eps>" (instances pass through)."""
    if isinstance(spec, Regularizer):
        return spec
    if spec in (None, "", "l2"):
        return L2
    if isinstance(spec, str) and spec.startswith("elastic:"):
        return make_elastic_net(float(spec.split(":", 1)[1]))
    if isinstance(spec, str) and spec.startswith("l1s:"):
        return make_smoothed_l1(float(spec.split(":", 1)[1]))
    raise KeyError(f"unknown regularizer {spec!r}; use 'l2', "
                   f"'elastic:<eta>', or 'l1s:<eps>'")
