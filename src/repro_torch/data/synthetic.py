"""Synthetic convex-ERM datasets with controllable partition difficulty.

Port of `repro.data.synthetic`. The generators are the reference's numpy
code verbatim, so the same seed gives *equal* arrays, not merely close
ones; tensors are made only at the end, in `partition`. The paper's
datasets are not available offline: these are stand-ins with matched
aspect ratios and the paper's normalization (||x_i|| <= 1, Remark 7).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


def _normalize_rows(X: np.ndarray) -> np.ndarray:
    nrm = np.linalg.norm(X, axis=1, keepdims=True)
    return X / np.maximum(nrm, 1e-12)


def make_classification(n: int, d: int, *, seed: int = 0, noise: float = 0.1,
                        sparsity: float = 0.0,
                        cond: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Linearly separable-ish binary labels in {-1, +1}, rows ||x||<=1.

    `cond` > 1 scales column j by cond^(-j/(d-1)) and the whole matrix by
    one global constant, giving the Gram matrix a condition ~cond^2."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    if sparsity > 0:
        X *= (rng.random((n, d)) > sparsity)
    if cond > 1.0:
        spectrum = (cond ** (-np.arange(d) / max(d - 1, 1))).astype(
            np.float32)
        X *= spectrum
        X /= max(float(np.linalg.norm(X, axis=1).max()), 1e-12)
    else:
        X = _normalize_rows(X)
    w_star = rng.standard_normal(d).astype(np.float32)
    if cond > 1.0:
        w_star /= np.maximum(spectrum, 1e-6)
    margin = X @ w_star
    flip = rng.random(n) < noise
    yv = np.sign(margin) * np.where(flip, -1.0, 1.0)
    yv[yv == 0] = 1.0
    return X, yv.astype(np.float32)


def make_regression(n: int, d: int, *, seed: int = 0, noise: float = 0.1):
    rng = np.random.default_rng(seed)
    X = _normalize_rows(rng.standard_normal((n, d)).astype(np.float32))
    w_star = rng.standard_normal(d).astype(np.float32)
    yv = X @ w_star + noise * rng.standard_normal(n).astype(np.float32)
    return X, yv.astype(np.float32)


def split_order(n: int, rng: np.random.Generator, heterogeneity: float,
                proj_of) -> np.ndarray:
    """Row visit order shared by the dense and sparse partitioners.

    `proj_of(rng) -> (n,)` projects every example onto a random direction;
    it is only invoked when heterogeneity < 1 so the rng stream matches
    between callers that do and don't use it.
    """
    order = rng.permutation(n)
    if heterogeneity < 1.0:
        proj = proj_of(rng)
        sorted_idx = np.argsort(proj)
        n_sorted = int((1.0 - heterogeneity) * n)
        take = sorted_idx[:n_sorted]
        # keep the permutation order for the unsorted fraction
        rest = order[~np.isin(order, take)]
        order = np.concatenate([take, rest])
    return order


def partition(X: np.ndarray, y: np.ndarray, K: int, *, seed: int = 0,
              heterogeneity: float = 1.0, device=DEFAULT_DEVICE):
    """Shuffle + split into (K, nk, d) with zero-padding + mask, as tensors
    on `device`: (X (K, nk, d), y (K, nk), mask (K, nk))."""
    dev = resolve_device(device)
    n, d = X.shape
    rng = np.random.default_rng(seed)
    order = split_order(
        n, rng, heterogeneity,
        lambda r: X @ r.standard_normal(d).astype(np.float32))
    nk = (n + K - 1) // K
    pad = nk * K - n
    Xp = np.concatenate([X[order], np.zeros((pad, d), X.dtype)])
    yp = np.concatenate([y[order], np.zeros(pad, y.dtype)])
    mk = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (torch.from_numpy(Xp.reshape(K, nk, d)).to(dev),
            torch.from_numpy(yp.reshape(K, nk)).to(dev),
            torch.from_numpy(mk.reshape(K, nk)).to(dev))


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    d: int
    kind: str = "classification"   # or "regression"
    sparsity: float = 0.0          # dense format: fraction of zeroed entries
    format: str = "dense"          # "dense" -> (n, d) array; "sparse" -> CSR
    density: float = 0.0           # sparse format: true nnz / (n * d)
    cond: float = 1.0              # dense format: column-spectrum knob


# The reference's offline stand-ins (repro.data.synthetic.DATASETS).
DATASETS = {
    "covtype_like": DatasetSpec("covtype_like", n=52_288, d=54),
    "rcv1_like":    DatasetSpec("rcv1_like", n=20_480, d=1024, sparsity=0.9),
    "epsilon_like": DatasetSpec("epsilon_like", n=16_384, d=512),
    "news_like":    DatasetSpec("news_like", n=8_192, d=2048, sparsity=0.95),
    "tiny":         DatasetSpec("tiny", n=1_024, d=64),
    "rcv1_sparse":  DatasetSpec("rcv1_sparse", n=20_480, d=16_384,
                                format="sparse", density=0.0016),
    "news_sparse":  DatasetSpec("news_sparse", n=8_192, d=65_536,
                                format="sparse", density=0.0005),
    "tiny_sparse":  DatasetSpec("tiny_sparse", n=1_024, d=512,
                                format="sparse", density=0.05),
    "illcond":      DatasetSpec("illcond", n=4_096, d=256, cond=100.0),
}


def load(spec_name: str, *, seed: int = 0):
    """Host-side (numpy) data for a named spec: (X, y) dense or
    (CSRMatrix, y) sparse; `partition` / `partition_sparse` place it."""
    spec = DATASETS[spec_name]
    if spec.format == "sparse":
        from . import sparse                      # local import: no cycle
        return sparse.make_sparse_classification(
            spec.n, spec.d, density=spec.density, seed=seed)
    if spec.kind == "classification":
        return make_classification(spec.n, spec.d, seed=seed,
                                   sparsity=spec.sparsity, cond=spec.cond)
    return make_regression(spec.n, spec.d, seed=seed)
