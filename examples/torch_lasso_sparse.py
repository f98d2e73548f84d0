"""Lasso on a sparse dataset via generalized CoCoA+ on the PyTorch port --
the smoothed-L1 regularizer end to end, certified by the generalized
duality gap.

    P(w) = (1/(2n)) ||A^T w - y||^2 + lam ||w||_1 + (eps/2) ||w||^2

The (eps/2)||w||^2 term is the eps-Moreau smoothing of the Lasso dual's
box indicator (core.regularizers.SmoothedL1): it makes g strongly convex
(tau = eps) so the dual rounds carry v = A alpha/(eps n) and recover the
primal through the soft-threshold conjugate map w = S_{lam/eps}(v) --
which is what makes the served w genuinely sparse.

The local solver is the padded-ELL SDCA kernel (`sdca_sparse_kernel`)
with its fused soft-threshold prox: one launch a round on the card, its
plain PyTorch walk on the CPU.

    PYTHONPATH=src python examples/torch_lasso_sparse.py        # rcv1-scale
    PYTHONPATH=src python examples/torch_lasso_sparse.py --device cpu \\
        --dataset tiny_sparse --rounds 60 --eps-gap 1e-4         # seconds
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import (CoCoAConfig, duality, get_regularizer,  # noqa
                              primal_w, solve)
from repro_torch.core.losses import get_loss  # noqa: E402
from repro_torch.data import load, partition_sparse  # noqa: E402


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="rcv1_sparse")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--lam", type=float, default=1e-4,
                    help="L1 weight (the Lasso knob; keep it under the "
                         "data's lambda_max = ||A y||_inf / n or the "
                         "selected support is empty)")
    ap.add_argument("--eps-smooth", type=float, default=1e-4,
                    help="Moreau smoothing / strong-convexity floor eps")
    ap.add_argument("--H", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--eps-gap", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel on the card) or cpu (its plain "
                         "version)")
    return ap


def lasso(args, on_round=None, visit_orders=None):
    """Solve `args`' Lasso: (config, SolveResult, (P, D, gap) at the
    served point, w)."""
    csr, y = load(args.dataset)
    sh, yp, mk = partition_sparse(csr, y, args.workers, seed=0,
                                  device=args.device)
    reg_spec = f"l1s:{args.eps_smooth}"
    cfg = CoCoAConfig.adding(args.workers, loss="squared", lam=args.lam,
                             H=args.H, reg=reg_spec,
                             solver="sdca_sparse_kernel")
    r = solve(cfg, sh, yp, mk, rounds=args.rounds, eps_gap=args.eps_gap,
              gap_every=2, on_round=on_round, visit_orders=visit_orders)
    # the generalized certificate: P(w) - D(alpha) at the served primal
    # point w = grad g*(tau v) (identical to the gap solve() tracked; shown
    # explicitly here as the Lasso deliverable)
    pdg = duality.gap_at_v(r.state.w, r.state.alpha, sh, yp, mk,
                           get_loss("squared"), args.lam,
                           get_regularizer(reg_spec))
    return cfg, r, tuple(float(t) for t in pdg), primal_w(r.state, cfg)


def main(argv=None):
    args = parser().parse_args(argv)
    csr, _ = load(args.dataset)
    reg = get_regularizer(f"l1s:{args.eps_smooth}")
    print(f"{args.dataset}: n={csr.shape[0]} d={csr.shape[1]} "
          f"density={csr.density:.4g}; lasso lam={args.lam} "
          f"eps={args.eps_smooth} (tau={reg.tau(args.lam):.3g})")
    _, _, (p, d, g), w = lasso(
        args, on_round=lambda t, st, gap: print(f"round {t}: gap={gap:.3e}"))
    nnz = int(torch.sum(torch.abs(w) > 0))
    print(f"final: P={p:.6f} D={d:.6f} gap={g:.3e}")
    print(f"lasso w: {nnz}/{w.shape[0]} nonzeros "
          f"({100.0 * nnz / w.shape[0]:.1f}% dense); certificate: primal "
          f"suboptimality <= {g:.3e} on the smoothed objective")


if __name__ == "__main__":
    main()
