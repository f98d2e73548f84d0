"""Quickstart on the PyTorch port: distributed hinge-loss SVM with CoCoA+
(the paper, end to end).

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Solves the synthetic `tiny` problem on K=8 (simulated) workers with the
duality-gap certificate as the stopping rule, then compares against
original CoCoA (averaging) and naive adding (diverges). The local solver
is the dense SDCA kernel (`sdca_kernel`): one launch a round on the card,
its plain PyTorch walk on the CPU.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import CoCoAConfig, solve  # noqa: E402
from repro_torch.data import load, partition  # noqa: E402

K = 8
ROUNDS, EPS_GAP, GAP_EVERY = 40, 1e-3, 5


def configs(K: int = K):
    """The three runs: (name, config)."""
    common = dict(loss="hinge", lam=1e-3, H=512, solver="sdca_kernel")
    return [
        ("CoCoA+  (adding, sigma'=K)", CoCoAConfig.adding(K, **common)),
        ("CoCoA   (averaging)       ", CoCoAConfig.averaging(K, **common)),
        ("naive add (sigma'=1)      ", CoCoAConfig(gamma=1.0, sigma_p=1.0,
                                                   **common)),
    ]


def train_accuracy(Xp, yp, mk, w) -> float:
    z = torch.einsum("kid,d->ki", Xp, w)
    return float((torch.sign(z) == yp)[mk > 0].float().mean())


def run(device, rounds: int = ROUNDS, visit_orders=None):
    """Every config of `configs` on `tiny`: [(name, SolveResult, train
    accuracy)]. `visit_orders(i)` gives run i's visit input hook (default:
    the solver's own draws)."""
    X, y = load("tiny")
    Xp, yp, mk = partition(X, y, K, seed=0, device=device)
    out = []
    for i, (name, cfg) in enumerate(configs()):
        r = solve(cfg, Xp, yp, mk, rounds=rounds, eps_gap=EPS_GAP,
                  gap_every=GAP_EVERY,
                  visit_orders=visit_orders(i) if visit_orders else None)
        out.append((name, r, train_accuracy(Xp, yp, mk, r.state.w)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel on the card) or cpu (its plain "
                         "version)")
    args = ap.parse_args(argv)
    X, _ = load("tiny")
    print(f"n={X.shape[0]} d={X.shape[1]} K={K}")
    for name, r, acc in run(args.device, rounds=ROUNDS):
        print(f"{name}: rounds={r.history['round'][-1]:3d} "
              f"gap={r.history['gap'][-1]:9.2e} train_acc={acc:.3f}")
    print("\nThe duality gap is a *certificate*: primal error <= gap, no "
          "oracle needed (paper section 2).")


if __name__ == "__main__":
    main()
