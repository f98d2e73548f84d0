"""Worker-topology descriptor. Port of `repro.comm.topology`, with the
`flat` reduce plan only: the K workers live on the leading axis of every
tensor and the cross-worker sum is a sum over that axis.

`from_mesh` is the counterpart of the reference's shard_map topology on
one card: K = the data axis's size, M = the model axis's size, and w is
the padded (M d_local,) vector whose M slices are the model shards. The
flat reduce of (K, M d_local) deltas over K is then the per-model-shard
reduce, K messages of d_local floats for each shard. `hier:<g>`, `a2a` and
the multi-process flavor are still to port (ROADMAP Queue 1 items 8, 10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .placement import WSpec


def _check_flat(topology: Optional[str]) -> None:
    if topology not in (None, "", "flat"):
        raise ValueError(f"topology {topology!r} is not ported yet; "
                         f"only 'flat' is (ROADMAP Queue 1 item 8)")


@dataclasses.dataclass(frozen=True)
class Topology:
    K: int                              # number of CoCoA workers
    M: int = 1                          # model shards of w
    model_axis: Optional[str] = None    # the mesh axis carrying them

    @staticmethod
    def simulated(K: int, topology: Optional[str] = None) -> "Topology":
        """K workers on the leading tensor axis."""
        _check_flat(topology)
        return Topology(K=K)

    @staticmethod
    def from_mesh(mesh, data_axis: str = "data",
                  model_axis: Optional[str] = None,
                  topology: Optional[str] = None) -> "Topology":
        """Workers = the data axis's size; model shards = the model axis's
        size (1 when `model_axis` is None)."""
        _check_flat(topology)
        if data_axis not in mesh.shape:
            raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no data "
                             f"axis {data_axis!r}")
        M = 1
        if model_axis is not None:
            if model_axis not in mesh.shape:
                raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no "
                                 f"model axis {model_axis!r}")
            M = mesh.shape[model_axis]
        return Topology(K=mesh.shape[data_axis], M=M, model_axis=model_axis)

    def wspec(self, d: int) -> WSpec:
        """The placement of a d-feature w under this topology."""
        return WSpec(d=d, M=self.M,
                     model_axis=self.model_axis if self.M > 1 else None)

    def d_local(self, d: int) -> int:
        """Floats of w each worker moves per reduce, per model shard."""
        return self.wspec(d).d_local

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-worker sum of a (K, ...) tensor; on (K, M d_local) deltas,
        each model shard's reduce at once."""
        return torch.sum(x, dim=0)

    def floats_per_round(self, f_msg: int) -> int:
        """Wire floats of one flat reduce: K messages of f_msg floats."""
        return self.K * f_msg
