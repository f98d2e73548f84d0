"""Update compression for the communicated Delta v_k vectors.

Port of `repro.comm.compress`. Every scheme carries error feedback (EF):
the compressor is applied to (update + residual), and whatever it drops
accumulates into the next round's residual instead of being lost.

    none   identity                              d floats on the wire
    topk   keep the k largest-|v| entries        2k floats (value + index)
    randk  keep k uniformly random entries       k floats (indices re-derived
                                                 from the shared round seed)
    qsgd   8-bit stochastic quantization         d/4 + 1 floats
    int8   deterministic symmetric int8          d/4 + 1 floats

`floats_per_message(d)` is the wire model of `comm.tracer.CommTracer`.

Batches. The reference writes each compressor for one (d,) message and
vmaps it over the K workers; here a compressor takes any (..., d) batch at
once and works along the last axis: (K, d) on the simulated backend,
(K, M, d_local) on a feature-sharded mesh (one message per worker and
model shard).

Random draws come in from outside. The reference draws rand-k's index set
with `jax.random.choice(key, d, (k,), replace=False)` and QSGD's rounding
as `uniform(key, (d,)) < p` from a threefry key. torch cannot reproduce
threefry, so `RandK` takes a (..., slots) tensor of distinct indices and
`StochasticQuant` a (..., d) tensor of uniforms in [0, 1), one row per
worker; `draw(K, d, generator)` makes them from a CPU `torch.Generator`
(`core.cocoa.solve` seeds it from (seed, round)), and the parity tests
feed the reference's own draws.

Sparsifiers (top-k / rand-k) also have the compressed-gather wire form
(`supports_gather`): `encode` emits a `SparseMessage` of (indices, values),
the topology gathers the K sets, and `decode_sum` scatter-adds them into
the summed dense message. `with_shards(M)` splits the budget k over the M
model shards of a feature-sharded w: ceil(k/M) slots each, of which shard
m keeps k//M + (m < k%M) live entries. Dead slots are parked at the
sentinel index d with value 0; every scatter here drops that index
explicitly (torch's `index_add_` would raise on it, or write out of
bounds on the card), where the reference relies on `mode="drop"`.

The pytree API at the bottom (`EFState`, `ef_init`, `compress`,
`compressed_bytes`) works on dicts, lists and tuples of tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device


class SparseMessage(NamedTuple):
    """A sparsifier's wire form for compressed gather: (..., k) index and
    value pairs instead of a d-length masked vector. Under feature
    sharding the indices are shard-local; `rebase` lifts a set into the
    global frame."""
    idx: torch.Tensor     # (..., k) int64 coordinate ids; d marks a dead slot
    val: torch.Tensor     # (..., k) values at those coordinates

    def rebase(self, offset) -> "SparseMessage":
        """Offset-rebase the coordinate frame (local -> global for
        +wspec.shard_offset(m), global -> local for the negative)."""
        return SparseMessage(self.idx + offset, self.val)


def _scatter_set(like: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """zeros_like(like) with val written at idx along the last axis;
    indices >= d (the dead-slot sentinel) are dropped."""
    d = like.shape[-1]
    out = like.new_zeros(like.shape[:-1] + (d + 1,))
    out.scatter_(-1, torch.clamp(idx, max=d), val)
    return out[..., :d]


def decode_sum(idx: torch.Tensor, val: torch.Tensor, d: int) -> torch.Tensor:
    """Server-side decompression: scatter-add every gathered (idx, val)
    pair -- any shape, e.g. (K, k) -- into the summed dense (d,) message.
    Indices >= d (the `merge_sets` and budget-split sentinel) are
    dropped."""
    flat_i = torch.clamp(idx.reshape(-1).long(), max=d)
    out = val.new_zeros(d + 1)
    out.index_add_(0, flat_i, val.reshape(-1))
    return out[:d]


def merge_sets(idx: torch.Tensor, val: torch.Tensor, d: int):
    """Deduplicate coincident coordinates across gathered (idx, val) sets.

    Input: a (..., G, k) stack of sets sharing one coordinate frame (the g
    per-worker sets a hier pod gathered); the leading axes are a batch.
    Output: one merged (..., G k) set per batch entry in which each
    distinct coordinate appears once with its values summed; the G k -
    unique duplicate slots sit at the sentinel index d with value 0, so
    `decode_sum` drops them. Returns (midx, mval, unique (...,)): `unique`
    is the measured number of live pairs, excluding incoming sentinel
    entries (a budget-split sparsifier's dead slots)."""
    batch = idx.shape[:-2]
    flat_i = idx.reshape(batch + (-1,)).long()
    flat_v = val.reshape(batch + (-1,))
    si, order = torch.sort(flat_i, dim=-1, stable=True)
    sv = torch.gather(flat_v, -1, order)
    first = torch.ones_like(si, dtype=torch.bool)
    first[..., 1:] = si[..., 1:] != si[..., :-1]
    run = torch.cumsum(first.long(), dim=-1) - 1     # run id of each element
    mval = torch.zeros_like(sv).scatter_add_(-1, run, sv)
    midx = torch.full_like(si, d).scatter_(-1, run, si)
    unique = torch.sum(first & (si < d), dim=-1)
    return midx, mval, unique


class Compressor:
    """Message compressor with error feedback, on (..., d) batches:
    `compressor(x, residual, draws) -> (x_hat, new_residual)`.
    Deterministic schemes take no draws. Sparsifiers also expose `encode`
    (the `SparseMessage` wire form) and set `supports_gather`."""
    name: str = "none"
    supports_gather: bool = False

    def __call__(self, x, residual, draws=None):
        raise NotImplementedError

    def draw(self, K: int, d: int, generator: torch.Generator):
        """One round's random draws for K workers' d-float messages, on
        the CPU; None for the deterministic schemes."""
        return None

    def encode(self, x, residual, draws=None):
        """(SparseMessage, new_residual) -- only for `supports_gather`."""
        raise NotImplementedError(
            f"{self.name!r} has no sparse wire form; compressed gather "
            f"needs topk or randk")

    def floats_per_message(self, d: int) -> int:
        """Equivalent f32 floats one worker puts on the wire per round."""
        raise NotImplementedError

    def gather_floats(self, d: int) -> int:
        """Floats in one SparseMessage set -- only for `supports_gather`."""
        raise NotImplementedError(
            f"{self.name!r} has no sparse wire form; compressed gather "
            f"needs topk or randk")


class NoCompression(Compressor):
    name = "none"

    def __call__(self, x, residual, draws=None):
        return x, residual

    def floats_per_message(self, d: int) -> int:
        return d


class _Sparsifier(Compressor):
    """The k-sparse schemes: `encode` picks the index set, and the dense
    `__call__` form is its scatter, so the dense reduce and the compressed
    gather transmit the same x_hat and carry the same EF residual.

    Budget split: `with_shards(M)` deals the total budget k over M model
    shards -- ceil(k/M) slots per shard, of which shard m keeps
    k//M + (m < k%M) live entries (the remainder to low shards). The
    split form takes (K, M, d_local) messages; the shard index is the
    position on axis -2 (the reference reads it from `lax.axis_index`)."""
    supports_gather = True

    def __init__(self, k: int, shards: int = 1):
        if k <= 0:
            raise ValueError(f"{self.name} needs k >= 1, got {k}")
        if shards < 1:
            raise ValueError(f"{self.name} needs shards >= 1, got {shards}")
        self.k = int(k)                 # total budget across all shards
        self.shards = int(shards)

    @property
    def slots(self) -> int:
        """Per-shard message slots: ceil(k / shards)."""
        return -(-self.k // self.shards)

    def live_budget(self, m):
        """Live entries shard m transmits: k//M + (m < k%M), summing to k
        with the remainder dealt to low shards."""
        return self.k // self.shards + (m < self.k % self.shards)

    def with_shards(self, M: int) -> "_Sparsifier":
        """The budget-split copy of this sparsifier for M model shards."""
        if M == 1:
            return self
        return type(self)(self.k, shards=M)

    def _select(self, xc, draws):
        raise NotImplementedError

    def encode(self, x, residual, draws=None):
        xc = x + residual
        idx = self._select(xc, draws)
        val = torch.gather(xc, -1, idx)
        d = xc.shape[-1]
        if self.shards > 1:
            if xc.dim() < 2 or xc.shape[-2] != self.shards:
                raise ValueError(
                    f"a budget split over {self.shards} shards takes "
                    f"(..., {self.shards}, d_local) messages, got "
                    f"{tuple(xc.shape)}")
            m = torch.arange(self.shards, device=xc.device)[:, None]
            slot = torch.arange(idx.shape[-1], device=xc.device)[None, :]
            live = slot < self.live_budget(m)              # (M, slots)
            # dead slots -> sentinel d / value 0: dropped by every scatter,
            # their mass stays in the EF residual (top-k's indices come in
            # magnitude order, so the live prefix is the largest entries)
            idx = torch.where(live, idx, d)
            val = torch.where(live, val, torch.zeros_like(val))
        xhat = _scatter_set(xc, idx, val)
        return SparseMessage(idx, val), xc - xhat

    def __call__(self, x, residual, draws=None):
        msg, res = self.encode(x, residual, draws)
        return _scatter_set(x, msg.idx, msg.val), res

    def __repr__(self):
        extra = f", k/{self.shards} per shard" if self.shards > 1 else ""
        return f"{type(self).__name__}(k={self.k}{extra})"


class TopK(_Sparsifier):
    """Keep the k largest-magnitude entries of (x + residual) -- the
    per-shard largest ceil(k/M) under a budget split.

    Ties go to the lowest index, in the order `jax.lax.top_k` returns
    them: a stable descending sort of |x|. `torch.topk` leaves the order of
    ties unspecified on the card, and zeros tie whenever a message has
    fewer nonzeros than k -- which zero indices are picked decides
    `merge_sets`' unique count and the live prefix of a budget split."""
    name = "topk"

    def _select(self, xc, draws):
        order = torch.sort(torch.abs(xc), dim=-1, descending=True,
                           stable=True).indices
        return order[..., :min(self.slots, xc.shape[-1])]

    def floats_per_message(self, d: int) -> int:
        return 2 * min(self.slots, d)   # (value, index) pairs per shard

    def gather_floats(self, d: int) -> int:
        return 2 * min(self.slots, d)


class RandK(_Sparsifier):
    """Keep k uniformly random entries of (x + residual) -- ceil(k/M) per
    shard under a budget split. `draws` is the (..., slots) index set, k
    distinct ids per worker (broadcast over the model shards of a worker,
    as the reference's per-worker key is); only the k values travel on
    the dense reduce (the receiver re-derives the indices from the seed)."""
    name = "randk"

    def draw(self, K: int, d: int, generator: torch.Generator):
        n = min(self.slots, d)
        return torch.stack([torch.randperm(d, generator=generator)[:n]
                            for _ in range(K)])

    def _select(self, xc, draws):
        n = min(self.slots, xc.shape[-1])
        if draws is None or draws.shape[-1] != n:
            raise ValueError(f"randk takes its index draws as (..., {n}) "
                             f"ids; got "
                             f"{None if draws is None else tuple(draws.shape)}")
        idx = draws.to(xc.device, torch.long)
        return idx.expand(xc.shape[:-1] + (n,))

    def floats_per_message(self, d: int) -> int:
        return min(self.slots, d)       # values only; indices are seed-derived

    def gather_floats(self, d: int) -> int:
        # the gathered sets travel indices and all
        return 2 * min(self.slots, d)


class StochasticQuant(Compressor):
    """QSGD-style stochastic quantization to 2^(bits-1)-1 magnitude levels
    against the max-|v| norm, rounding up with probability equal to the
    fractional level. `draws` are (..., d) uniforms in [0, 1): the level
    rounds up where `uniform < fraction`, the reference's
    `jax.random.bernoulli`."""
    name = "qsgd"

    def __init__(self, bits: int = 8):
        if not 2 <= bits <= 16:
            raise ValueError(f"bits must be in [2, 16], got {bits}")
        self.bits = int(bits)

    def draw(self, K: int, d: int, generator: torch.Generator):
        return torch.rand((K, d), generator=generator)

    def __call__(self, x, residual, draws=None):
        xc = x + residual
        if draws is None or draws.shape[-1] != xc.shape[-1]:
            raise ValueError(f"qsgd takes (..., {xc.shape[-1]}) uniforms "
                             f"as its draws")
        s = _const(xc, 2 ** (self.bits - 1) - 1)
        norm = torch.amax(torch.abs(xc), dim=-1, keepdim=True) + 1e-12
        y = torch.abs(xc) / norm * s
        lo = torch.floor(y)
        up = draws.to(xc.device, xc.dtype) < torch.clamp(y - lo, 0.0, 1.0)
        xhat = torch.sign(xc) * (lo + up.to(xc.dtype)) / s * norm
        return xhat, xc - xhat

    def floats_per_message(self, d: int) -> int:
        return -(-d * self.bits // 32) + 1      # packed levels + the norm

    def __repr__(self):
        return f"StochasticQuant(bits={self.bits})"


class Int8(Compressor):
    """Deterministic per-message symmetric int8 quantization."""
    name = "int8"

    def __call__(self, x, residual, draws=None):
        xc = x + residual
        xhat = _int8(xc)
        return xhat, xc - xhat

    def floats_per_message(self, d: int) -> int:
        return -(-d // 4) + 1


def resolve(method: Optional[str], k: int = 0) -> Compressor:
    """Compressor from config: "none" | "topk" | "randk" | "qsgd" | "int8"
    (`k` is the sparsifier budget for topk/randk)."""
    if method in (None, "none", ""):
        return NoCompression()
    if method == "topk":
        return TopK(k)
    if method == "randk":
        return RandK(k)
    if method == "qsgd":
        return StochasticQuant(8)
    if method == "int8":
        return Int8()
    raise ValueError(f"unknown compressor {method!r}; use "
                     f"'none', 'topk', 'randk', 'qsgd', or 'int8'")


def init_residual(K: int, d: int, dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """Fresh per-worker EF residuals (zeros; identity for 'none'), on the
    card unless the caller names another device."""
    return torch.zeros((K, d), dtype=dtype, device=resolve_device(device))


# ----------------------------------------------------------------------------
# Pytree API (the reference's repro.optim.compress interface)
# ----------------------------------------------------------------------------

class EFState(NamedTuple):
    residual: object      # tree matching the compressed tree


def _tree_map(fn, *trees):
    """`fn` over the tensor leaves of dicts, lists and tuples."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def ef_init(tree) -> EFState:
    return EFState(_tree_map(torch.zeros_like, tree))


def _topk_one(x, frac: float):
    flat = x.reshape(-1)
    k = max(1, int(frac * flat.numel()))
    thresh = torch.sort(torch.abs(flat)).values[-k]
    kept = torch.where(torch.abs(flat) >= thresh, flat,
                       torch.zeros_like(flat))
    return kept.reshape(x.shape)


def _const(like: torch.Tensor, c) -> torch.Tensor:
    """`c` as a 0-d tensor on `like`'s device. A division by it rounds
    once, as the reference's does: CUDA divides by a Python number as a
    multiplication by its reciprocal, which can differ in the last bit."""
    return like.new_full((), float(c))


def _int8(x):
    """Symmetric int8 levels against the max |x| along the last axis,
    rounded half to even (`torch.round`, as `jnp.round`)."""
    scale = (torch.amax(torch.abs(x), dim=-1, keepdim=True)
             / _const(x, 127.0) + 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale


def _int8_one(x):
    """`_int8` with one scale for the whole tensor (the pytree API)."""
    return _int8(x.reshape(-1)).reshape(x.shape)


def compress(tree, ef: Optional[EFState], method: str):
    """Returns (compressed_tree, new_ef). method: "none"|"int8"|"topk:<f>"."""
    if method in (None, "none"):
        return tree, ef
    if ef is None:
        ef = ef_init(tree)
    corrected = _tree_map(lambda g, r: g + r, tree, ef.residual)
    if method == "int8":
        comp = _tree_map(_int8_one, corrected)
    elif method.startswith("topk:"):
        frac = float(method.split(":")[1])
        comp = _tree_map(lambda x: _topk_one(x, frac), corrected)
    else:
        raise ValueError(method)
    new_res = _tree_map(lambda c, x: x - c, comp, corrected)
    return comp, EFState(new_res)


def compressed_bytes(tree, method: str) -> int:
    n = sum(leaf.numel() for leaf in _leaves(tree))
    if method in (None, "none"):
        return 4 * n
    if method == "int8":
        return n
    if method.startswith("topk:"):
        frac = float(method.split(":")[1])
        return int(frac * n * 8)      # value + index
    raise ValueError(method)
