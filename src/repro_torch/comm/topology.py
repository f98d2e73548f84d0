"""Worker-topology descriptor. Port of `repro.comm.topology`, simulated
flavor with the `flat` reduce plan only: the K workers live on the leading
axis of every tensor and the cross-worker sum is a sum over that axis.
`hier:<g>`, `a2a` and the multi-process flavor are still to port."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    K: int                    # number of CoCoA workers

    @staticmethod
    def simulated(K: int, topology: Optional[str] = None) -> "Topology":
        """K workers on the leading tensor axis."""
        if topology not in (None, "", "flat"):
            raise ValueError(f"topology {topology!r} is not ported yet; "
                             f"only 'flat' is (ROADMAP Queue 1 item 8)")
        return Topology(K=K)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-worker sum of a (K, ...) tensor."""
        return torch.sum(x, dim=0)

    def floats_per_round(self, f_msg: int) -> int:
        """Wire floats of one flat reduce: K messages of f_msg floats."""
        return self.K * f_msg
