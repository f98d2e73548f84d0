"""Elastic scaling for CoCoA+: re-partition the (K, nk, ...) layout when
workers join/leave. Port of `repro.runtime.elastic`. The dual state alpha
carries over (it lives with its datapoints); only sigma' must be reset to
gamma * K_new (Lemma 4), which a config made for K_new does by
construction, since CoCoAConfig.agg_params(K) reads the current K.

The re-split runs on the tensors' own device, with no trip through the
host (at rcv1's shape the ELL shards are ~640 MB, at epsilon's X is
3.2 GB), and gives the reference's arrays bit for bit: it only copies.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..data.sparse import FeatureShards


def repartition(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                K_new: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Re-split worker-major data onto K_new workers.

    arrays: {"X": (K, nk, d), "y": (K, nk), "alpha": (K, nk), ...} -- every
    array shares the (K, nk) leading layout. Valid rows (mask != 0) are
    flattened in worker-major order and re-split contiguously, zero-padded
    to K_new * ceil(n / K_new) rows, so datapoints keep their alpha and the
    objective is unchanged (up to partition-dependent sigma'_min, which the
    safe bound gamma*K_new always covers). The new mask is float32 ones on
    the n valid rows.
    """
    m = mask.reshape(-1) != 0
    n = int(m.sum())
    nk_new = -(-n // K_new)
    out = {}
    for name, arr in arrays.items():
        tail = tuple(arr.shape[2:])
        flat = arr.new_zeros((K_new * nk_new,) + tail)
        flat[:n] = arr.reshape((-1,) + tail)[m]
        out[name] = flat.reshape((K_new, nk_new) + tail)
    mnew = torch.zeros(K_new * nk_new, dtype=torch.float32,
                       device=mask.device)
    mnew[:n] = 1.0
    return out, mnew.reshape(K_new, nk_new)


def repartition_features(fs: FeatureShards, y, alpha, mask, K_new: int):
    """Re-split feature-sharded ELL data (data.sparse.FeatureShards) onto
    K_new workers, keeping the model axis intact: rows move between
    workers exactly like the replicated layouts (datapoints keep their
    alpha), while each row's M feature slices travel with it. The w
    placement is untouched -- elastic scaling changes K, never M (a mesh
    reshape that changes M goes through core.cocoa.reshard_w_state).

    Returns (fs_new, y_new, alpha_new, mask_new).
    """
    # leaves are (K, M, nk, ...): swap to (K, nk, M, ...) so rows are the
    # second axis `repartition` expects, then swap back
    arrs = {"cols": fs.cols.transpose(1, 2), "vals": fs.vals.transpose(1, 2),
            "nnz": fs.nnz.transpose(1, 2), "y": y, "alpha": alpha}
    new, mask_new = repartition(arrs, mask, K_new)
    fs_new = FeatureShards(new["cols"].transpose(1, 2).contiguous(),
                           new["vals"].transpose(1, 2).contiguous(),
                           new["nnz"].transpose(1, 2).contiguous(),
                           d=fs.d, M=fs.M, d_local=fs.d_local)
    return fs_new, new["y"], new["alpha"], mask_new
