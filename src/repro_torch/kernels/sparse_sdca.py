"""LocalSDCA over padded-ELL rows, with the fused prox: the CUDA kernel
`csrc/sparse_sdca.cu` and its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/sparse_sdca.py::_sparse_sdca_kernel`
(depth-1 buffering). One call runs one round for all K workers: per row an
r_max gather-dot `sum_r prox(u[c_r]) * v_r` (prox only when `prox_kappa`
is set), `q = scale * sum_r v_r^2`, the closed-form update, then an r_max
scatter-axpy into raw u. Padding slots (col 0, val 0) are exact no-ops and
duplicate column ids in a row all land. With the prox fused the caller
passes w = v, so u lives in v-space; du = u - w = scale * A_[k] dalpha.

`sparse_local_sdca` launches the kernel for CUDA tensors and runs
`sparse_local_sdca_plain` for CPU tensors. `LAUNCHES` counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.losses import Loss
from ..core.regularizers import soft_threshold
from . import build
from .local_sdca import check_u_fits, loss_code

LAUNCHES = 0


def _check_shapes(cols, vals, y, alpha, mask, w, perm):
    if cols.dim() != 3 or tuple(vals.shape) != tuple(cols.shape):
        raise ValueError(f"cols/vals must both be (K, nk, r_max), got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    K, nk, r_max = cols.shape
    for name, t in (("y", y), ("alpha", alpha), ("mask", mask),
                    ("perm", perm)):
        if tuple(t.shape) != (K, nk):
            raise ValueError(f"{name} must be {(K, nk)}, got "
                             f"{tuple(t.shape)}")
    if w.dim() != 1:
        raise ValueError(f"w must be (d,), got {tuple(w.shape)}")
    return K, nk, r_max, w.shape[0]


def sparse_local_sdca_plain(cols, vals, y, alpha, mask, w, scale, perm, *,
                            loss: Loss, n_passes: int = 1,
                            prox_kappa: Optional[float] = None):
    """Plain PyTorch version: replays `repro.kernels.ref.
    sparse_local_sdca_ref`'s sequence (row perm[k, j] at step j) for all K
    workers at once; scatter_add_ lands duplicate columns one by one."""
    loss_code(loss)
    K, nk, r_max, d = _check_shapes(cols, vals, y, alpha, mask, w, perm)
    ks = torch.arange(K, device=vals.device)
    perm = perm.long()
    cols = cols.long()
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=vals.device)
    u = w.float().expand(K, d).clone()
    for _ in range(n_passes):
        for j in range(nk):
            i = perm[:, j]
            ci, vi = cols[ks, i], vals[ks, i]
            uv = u.gather(1, ci)
            if prox_kappa is not None:
                uv = soft_threshold(uv, prox_kappa)
            z = torch.sum(uv * vi, dim=-1)
            q = scale * torch.sum(vi * vi, dim=-1)
            abar = alpha[ks, i] + dalpha[ks, i]
            delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
            dalpha[ks, i] += delta
            u.scatter_add_(1, ci, (scale * delta)[:, None] * vi)
    return dalpha, u - w


def sparse_local_sdca(cols, vals, y, alpha, mask, w, scale, perm, *,
                      loss: Loss, n_passes: int = 1,
                      prox_kappa: Optional[float] = None):
    """One round of sparse LocalSDCA for all K workers: the CUDA kernel on
    CUDA tensors, `sparse_local_sdca_plain` on CPU tensors.

    cols (K, nk, r_max) int32 (padding col 0); vals (K, nk, r_max) f32
    (padding 0); y, alpha, mask (K, nk) f32; w (d,) f32; perm (K, nk) int32;
    scale = sigma'/(tau n). Returns (dalpha (K, nk), du (K, d)).

    The kernel indexes with perm and cols unchecked: a range check here
    would cost device syncs and a pass over cols every launch, so perm is
    checked on the host by `ops.perm_i32` and the column ids once where the
    shards are built (`data.sparse`)."""
    lid, g = loss_code(loss)
    K, nk, r_max, d = _check_shapes(cols, vals, y, alpha, mask, w, perm)
    if vals.device.type == "cpu":
        return sparse_local_sdca_plain(cols, vals, y, alpha, mask, w, scale,
                                       perm, loss=loss, n_passes=n_passes,
                                       prox_kappa=prox_kappa)
    if vals.device.type != "cuda":
        raise ValueError(f"sparse_local_sdca runs on cuda or cpu, got "
                         f"{vals.device}")
    for name, t in (("vals", vals), ("y", y), ("alpha", alpha),
                    ("mask", mask), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != vals.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {vals.device}")
    for name, t in (("cols", cols), ("perm", perm)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != vals.device:
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{vals.device}")
    check_u_fits(d)
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=vals.device)
    du = torch.empty((K, d), dtype=torch.float32, device=vals.device)
    lib = build.load("sparse_sdca")
    code = lib.sparse_sdca_launch(
        cols.data_ptr(), vals.data_ptr(), y.data_ptr(), alpha.data_ptr(),
        mask.data_ptr(), w.data_ptr(), perm.data_ptr(), dalpha.data_ptr(),
        du.data_ptr(), K, nk, r_max, d, int(n_passes), float(scale), lid, g,
        int(prox_kappa is not None),
        float(prox_kappa) if prox_kappa is not None else 0.0,
        torch.cuda.current_stream(vals.device).cuda_stream)
    build.check(lib, "sparse_sdca", code)
    global LAUNCHES
    LAUNCHES += 1
    return dalpha, du
