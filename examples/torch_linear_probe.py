"""Exact CoCoA+ on top of the LM stack, on the PyTorch port: train a linear
probe (binary SVM) on frozen transformer features, distributed over K
workers -- the paper's convex machinery attached to a modern model.

    PYTHONPATH=src python examples/torch_linear_probe.py             # card
    PYTHONPATH=src python examples/torch_linear_probe.py --device cpu

The features are a smoke-width gemma's final hidden states (random
weights from the seed); the probe's local solver is the dense SDCA kernel
(`sdca_kernel`): one launch a round on the card, its plain PyTorch walk on
the CPU.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import CoCoAConfig, solve  # noqa: E402
from repro_torch.data import partition  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

K = 8
N, S, CHUNK = 2048, 32, 256
ROUNDS, EPS_GAP, GAP_EVERY = 50, 1e-3, 5


def tokens_and_labels(cfg, n: int = N, seq: int = S):
    """Synthetic sequences from seed 0; the probe predicts whether a
    sequence's token ids sum to an even number."""
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab, (n, seq)).astype(np.int32)
    labels = np.where(toks.sum(axis=1) % 2 == 0, 1.0, -1.0).astype(
        np.float32)
    return toks, labels


@torch.no_grad()
def features(model, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The last token's final hidden state, (B, d): the stack's output
    before the final norm's logits."""
    B, seq = tokens.shape
    x = M._embed_inputs(model, {"tokens": tokens}, cfg)
    ctx = {"positions": M._positions(cfg, {}, B, seq, tokens.device),
           "pos": None, "decode": False, "aux": False}
    h, _, _ = M._run_stack(model, x, cfg, ctx, None)
    return h[:, -1]


def pooled_features(model, cfg, toks: np.ndarray, device) -> np.ndarray:
    """`features` of every row, CHUNK rows a call, L2-normalized."""
    feats = np.concatenate([
        features(model, cfg, torch.from_numpy(toks[i:i + CHUNK]).to(device))
        .float().cpu().numpy() for i in range(0, len(toks), CHUNK)])
    return feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                              1e-9)


def probe(feats: np.ndarray, labels: np.ndarray, device,
          rounds: int = ROUNDS, visit_orders=None):
    """The distributed convex probe with the duality-gap certificate:
    (SolveResult, train accuracy)."""
    Xp, yp, mk = partition(feats.astype(np.float32), labels, K, seed=0,
                           device=device)
    r = solve(CoCoAConfig.adding(K, loss="smooth_hinge1", lam=1e-3, H=512,
                                 solver="sdca_kernel"),
              Xp, yp, mk, rounds=rounds, eps_gap=EPS_GAP,
              gap_every=GAP_EVERY, visit_orders=visit_orders)
    z = torch.einsum("kid,d->ki", Xp, r.state.w)
    return r, float((torch.sign(z) == yp)[mk > 0].float().mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel on the card) or cpu (its plain "
                         "version)")
    args = ap.parse_args(argv)
    # 1) frozen LM features: final hidden states of a tiny gemma on
    #    synthetic token sequences
    cfg = smoke_config("gemma-7b")
    model = M.init_params(cfg, seed=0, device=args.device)
    toks, labels = tokens_and_labels(cfg, N, S)
    feats = pooled_features(model, cfg, toks, args.device)
    # 2) distributed convex probe training with the duality-gap certificate
    r, acc = probe(feats, labels, args.device, rounds=ROUNDS)
    print(f"probe: rounds={r.history['round'][-1]} "
          f"gap={r.history['gap'][-1]:.2e} train_acc={acc:.3f}")
    print("certificate: primal suboptimality <=",
          f"{r.history['gap'][-1]:.2e}")


if __name__ == "__main__":
    main()
