"""Update compression for the communicated Delta v_k vectors.

Port of `repro.comm.compress`, identity scheme only: `NoCompression`
sends the dense d floats and leaves the error-feedback residual untouched.
Top-k, rand-k and the quantizers are still to port.
"""
from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device


class NoCompression:
    """The identity compressor with error feedback:
    `compressor(x, residual) -> (x_hat, new_residual)` on (K, d) messages."""
    name = "none"

    def __call__(self, x, residual):
        return x, residual

    def floats_per_message(self, d: int) -> int:
        return d


def init_residual(K: int, d: int, dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """Fresh per-worker EF residuals (zeros; identity for 'none'), on the
    card unless the caller names another device."""
    return torch.zeros((K, d), dtype=dtype, device=resolve_device(device))
