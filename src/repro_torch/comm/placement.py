"""Where the shared d-vector w lives. Port of `repro.comm.placement`.

    WSpec(d, M=1)                    replicated: every worker holds all d
    WSpec(d, M, model_axis="model")  feature-sharded over a (data=K,
                                     model=M) mesh: model shard m holds the
                                     contiguous slice [m d_local,
                                     (m+1) d_local) of the padded vector,
                                     d_local = ceil(d / M)

On one card the M shards are the M contiguous slices of one padded
(M d_local,) tensor. Padded coordinates carry no data (no column maps to
them), so they stay exactly zero through every round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WSpec:
    d: int
    M: int = 1
    model_axis: Optional[str] = None

    def __post_init__(self):
        if self.d < 1:
            raise ValueError(f"d must be >= 1, got {self.d}")
        if self.M < 1:
            raise ValueError(f"M must be >= 1, got {self.M}")
        if self.M > 1 and self.model_axis is None:
            raise ValueError(
                f"M={self.M} feature shards need a model_axis mesh axis "
                f"to live on")

    @property
    def sharded(self) -> bool:
        return self.M > 1

    @property
    def d_local(self) -> int:
        """Floats of w each model shard holds (and moves per reduce)."""
        return -(-self.d // self.M)

    @property
    def d_padded(self) -> int:
        return self.d_local * self.M

    def shard_offset(self, m) -> int:
        """Global coordinate of shard m's first column."""
        return m * self.d_local

    def shard_bounds(self, m: int) -> Tuple[int, int]:
        """[lo, hi) of the real (unpadded) global columns of shard m."""
        lo = m * self.d_local
        return lo, min(lo + self.d_local, self.d)

    def to_local(self, cols, m):
        """Global column ids -> shard-m-local ids."""
        return cols - self.shard_offset(m)

    def to_global(self, cols, m):
        """Shard-m-local column ids -> global ids."""
        return cols + self.shard_offset(m)

    def owner_of(self, cols):
        """The shard that owns each global column."""
        return cols // self.d_local

    def pad_w(self, w):
        """(d,) -> (d_padded,); the same object when already padded."""
        if w.shape[-1] == self.d_padded:
            return w
        if w.shape[-1] != self.d:
            raise ValueError(f"cannot place a ({w.shape[-1]},) vector under "
                             f"WSpec(d={self.d}, M={self.M})")
        pad = self.d_padded - self.d
        if isinstance(w, np.ndarray):
            return np.pad(w, (0, pad))
        return torch.nn.functional.pad(w, (0, pad))

    def unpad_w(self, w):
        """(d_padded,) -> the global (d,) vector."""
        if w.shape[-1] not in (self.d, self.d_padded):
            raise ValueError(f"({w.shape[-1]},) vector is neither d={self.d} "
                             f"nor d_padded={self.d_padded}")
        return w[..., :self.d]

    def spec(self) -> Optional[str]:
        """The axis the stored w is split over: the model axis, or None
        while replicated (the reference's PartitionSpec, as a name)."""
        return self.model_axis if self.sharded else None
