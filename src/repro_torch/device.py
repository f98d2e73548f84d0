"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` as a `torch.device`; raises when it names CUDA and no card
    is visible, so a run meant for the GPU never silently lands on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read afterwards measures the work, not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
