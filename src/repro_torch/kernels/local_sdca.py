"""LocalSDCA over dense rows: the CUDA kernel `csrc/local_sdca.cu` and its
plain PyTorch version.

Replaces the TPU kernel `repro/kernels/local_sdca.py::_sdca_kernel`. One
call runs one round for all K workers: `n_passes` passes over each worker's
nk rows in the order of its row of `perm`, from the shared start u = w,
emitting (dalpha (K, nk), du (K, d)) with du = scale * A_[k] dalpha.

`local_sdca` launches the kernel for CUDA tensors and runs
`local_sdca_plain` for CPU tensors; there is no fallback between the two.
`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..core.losses import Loss
from . import build

CLOSED_FORM_LOSSES = ("hinge", "smooth_hinge", "squared", "absolute")
# bytes of dynamic shared memory a block may use on Hopper (opt-in limit)
MAX_SMEM_BYTES = 232_448
SCRATCH_BYTES = 32 * 8 + 16     # sdca::SCRATCH_BYTES in csrc/sdca_common.cuh

LAUNCHES = 0


def loss_code(loss: Loss):
    """(kernel loss id, smoothing g) -- `sdca::LossId` in sdca_common.cuh.
    Logistic has no closed form: use the eager solvers (core.solvers)."""
    for lid, prefix in enumerate(CLOSED_FORM_LOSSES):
        if loss.name.startswith(prefix):
            return lid, float(loss.smoothing)
    raise ValueError(
        f"kernel supports closed-form losses {CLOSED_FORM_LOSSES}, "
        f"got {loss.name!r}; use the core.solvers eager path instead")


def check_u_fits(d: int) -> None:
    """u lives in shared memory: reject widths that do not fit."""
    need = SCRATCH_BYTES + 4 * d
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"d={d} needs {need} bytes of shared memory for u; the limit "
            f"is {MAX_SMEM_BYTES} bytes per block (d <= "
            f"{(MAX_SMEM_BYTES - SCRATCH_BYTES) // 4})")


def _check_shapes(X, y, alpha, mask, w, perm):
    if X.dim() != 3:
        raise ValueError(f"X must be (K, nk, d), got {tuple(X.shape)}")
    K, nk, d = X.shape
    for name, t in (("y", y), ("alpha", alpha), ("mask", mask),
                    ("perm", perm)):
        if tuple(t.shape) != (K, nk):
            raise ValueError(f"{name} must be {(K, nk)}, got "
                             f"{tuple(t.shape)}")
    if tuple(w.shape) != (d,):
        raise ValueError(f"w must be ({d},), got {tuple(w.shape)}")
    return K, nk, d


def local_sdca_plain(X, y, alpha, mask, w, scale, perm, *, loss: Loss,
                     n_passes: int = 1):
    """Plain PyTorch version: replays `repro.kernels.ref.local_sdca_ref`'s
    sequence (row perm[k, j] at step j) for all K workers at once."""
    loss_code(loss)
    K, nk, d = _check_shapes(X, y, alpha, mask, w, perm)
    ks = torch.arange(K, device=X.device)
    perm = perm.long()
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=X.device)
    u = w.float().expand(K, d).clone()
    for _ in range(n_passes):
        for j in range(nk):
            i = perm[:, j]
            x = X[ks, i]
            z = torch.sum(x * u, dim=-1)
            q = scale * torch.sum(x * x, dim=-1)
            abar = alpha[ks, i] + dalpha[ks, i]
            delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
            dalpha[ks, i] += delta
            u += (scale * delta)[:, None] * x
    return dalpha, u - w


def local_sdca(X, y, alpha, mask, w, scale, perm, *, loss: Loss,
               n_passes: int = 1):
    """One round of LocalSDCA for all K workers: the CUDA kernel on CUDA
    tensors, `local_sdca_plain` on CPU tensors.

    X (K, nk, d) f32; y, alpha, mask (K, nk) f32; w (d,) f32; perm (K, nk)
    int32, each row a permutation of range(nk); scale = sigma'/(tau n).
    Returns (dalpha (K, nk), du (K, d)).

    The kernel indexes X with perm unchecked: a range check here would
    cost a device sync every launch, so `ops.perm_i32` checks perm on the
    host before it is copied over."""
    lid, g = loss_code(loss)
    K, nk, d = _check_shapes(X, y, alpha, mask, w, perm)
    if X.device.type == "cpu":
        return local_sdca_plain(X, y, alpha, mask, w, scale, perm,
                                loss=loss, n_passes=n_passes)
    if X.device.type != "cuda":
        raise ValueError(f"local_sdca runs on cuda or cpu, got {X.device}")
    for name, t in (("X", X), ("y", y), ("alpha", alpha), ("mask", mask),
                    ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != X.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {X.device}")
    if perm.dtype != torch.int32 or not perm.is_contiguous() \
            or perm.device != X.device:
        raise ValueError(f"perm must be a contiguous int32 tensor on "
                         f"{X.device}")
    check_u_fits(d)
    dalpha = torch.zeros((K, nk), dtype=torch.float32, device=X.device)
    du = torch.empty((K, d), dtype=torch.float32, device=X.device)
    lib = build.load("local_sdca")
    code = lib.local_sdca_launch(
        X.data_ptr(), y.data_ptr(), alpha.data_ptr(), mask.data_ptr(),
        w.data_ptr(), perm.data_ptr(), dalpha.data_ptr(), du.data_ptr(),
        K, nk, d, int(n_passes), float(scale), lid, g,
        torch.cuda.current_stream(X.device).cuda_stream)
    build.check(lib, "local_sdca", code)
    global LAUNCHES
    LAUNCHES += 1
    return dalpha, du
