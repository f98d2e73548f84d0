"""Deterministic, resumable synthetic LM token pipeline
(`repro.data.tokens` counterpart).

The corpus and every batch are made with numpy exactly as the reference
makes them, so `batch_at` returns arrays *equal* to the reference's;
`tensors_at` hands the same batch over as int64 tensors on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 shard: int = 0, shards: int = 1, corpus_len: int = 1 << 22):
        if batch % shards:
            raise ValueError(f"batch {batch} must divide by shards {shards}")
        self.vocab, self.batch, self.seq = vocab, batch // shards, seq
        self.shard, self.shards = shard, shards
        rng = np.random.default_rng(seed)
        base = rng.zipf(1.3, size=corpus_len).astype(np.int64) % (vocab - 1) + 1
        # learnable bigram structure: every odd position continues
        # deterministically from its predecessor
        base[1::2] = (base[0::2][: base[1::2].size] * 7 + 3) % (vocab - 1) + 1
        self.corpus = base.astype(np.int32)

    def batch_at(self, step: int):
        """Batch for a global step -- pure function of (seed, step, shard)."""
        n = self.corpus.size - self.seq - 2
        out = np.empty((self.batch, self.seq + 1), np.int32)
        for j in range(self.batch):
            # golden-ratio hashing spreads reads; deterministic & collision-light
            idx = ((step * self.shards * self.batch
                    + self.shard * self.batch + j) * 2654435761) % n
            out[j] = self.corpus[idx: idx + self.seq + 1]
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def tensors_at(self, step: int, device=DEFAULT_DEVICE):
        """`batch_at(step)` as int64 tensors on `device`."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                for k, v in self.batch_at(step).items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
