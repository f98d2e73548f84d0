"""Meshes of the port (`repro.launch.mesh` counterpart).

The reference lays its (data=K, model=M) mesh over K M devices. On one
card the port runs the same rounds as one grid of K M thread blocks (the
z-exchange kernel) or K blocks (the 1-D kernels), so a mesh here is a
value naming the axes, their sizes and the card: `Topology.from_mesh`
reads it. `initialize_distributed` and meshes across cards belong to the
multi-process backend (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the reference's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device=DEFAULT_DEVICE) -> Mesh:
    """A (data, model) mesh on one card: `shape[i]` blocks along
    `axes[i]`."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up "
                         f"with distinct names")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    return Mesh(axes, shape, resolve_device(device))
