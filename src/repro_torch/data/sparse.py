"""Sparse data: CSR on the host, padded-ELL tensors on the device.

Port of `repro.data.sparse` for the main path:

  * `CSRMatrix` -- host-side CSR triple (data, indices, indptr), numpy,
    from `load_libsvm` (LIBSVM text, whole or streamed in row chunks by
    `iter_libsvm_chunks`, stitched by `csr_vstack`) or the synthetic
    generator.
  * `csr_to_ell` / `ell_to_csr` -- the padded-ELL layout `(n, r_max)` of
    (col, value) pairs and back. Padding entries are (col 0, val 0.0):
    every gather adds u[0] * 0 and every scatter adds 0 to u[0], exact
    no-ops.
  * `SparseShards` -- a dataclass of tensors mirroring the dense
    `(K, nk, d)` partition: `cols`/`vals` are `(K, nk, r_max)`, `nnz` the
    true per-row entry count.
  * `FeatureShards` -- the same rows sliced by feature block for a
    (data=K, model=M) mesh: `cols`/`vals` are `(K, M, nk, r_loc)` with
    shard-local column ids (`shard_features`).
  * `partition_sparse` -- the worker partitioner (same shuffle, padding and
    mask as `data.synthetic.partition`); `M > 1` returns `FeatureShards`.
  * `shard_features_streaming` -- `FeatureShards` built chunk by chunk from
    a CSR stream, rows dealt round-robin, with no full-width host array.
  * `matvec` / `rmatvec` / `row_sqnorms` / `densify` -- the sparse matvec
    family the duality certificate uses, over both layouts; `rmatvec` is an
    `index_add_`.

Every host array here equals the reference's (same dtypes, same layout).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .synthetic import split_order


class CSRMatrix(NamedTuple):
    """Compressed sparse rows: row i owns indices[indptr[i]:indptr[i+1]]."""
    data: np.ndarray       # (nnz,) float32
    indices: np.ndarray    # (nnz,) int32, column ids, sorted within a row
    indptr: np.ndarray     # (n + 1,) int64
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def density(self) -> float:
        n, d = self.shape
        return self.nnz / max(n * d, 1)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def toarray(self) -> np.ndarray:
        n, d = self.shape
        out = np.zeros((n, d), np.float32)
        rows = np.repeat(np.arange(n), self.row_nnz())
        # accumulate, don't assign: duplicate (row, col) entries sum
        np.add.at(out, (rows, self.indices), self.data)
        return out


def _iter_source_lines(source: Union[str, pathlib.Path, Iterable[str]]
                       ) -> Iterable[str]:
    """Lazily yield lines: a path streams through open(), an iterable
    passes through."""
    if isinstance(source, (str, pathlib.Path)):
        with open(source, "r") as f:
            yield from f
    else:
        yield from source


def iter_libsvm_chunks(source: Union[str, pathlib.Path, Iterable[str]], *,
                       chunk_rows: int,
                       n_features: Optional[int] = None,
                       zero_based: bool = False
                       ) -> Iterable[Tuple[CSRMatrix, np.ndarray]]:
    """Stream LIBSVM text as (CSRMatrix, labels) blocks of <= chunk_rows
    rows, in O(chunk nnz) memory. `n_features` fixes the column count of
    every chunk; without it each chunk's width is its own max index + 1
    (`load_libsvm` widens to the global max when it stitches)."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    off = 0 if zero_based else 1
    labels, data, indices, indptr = [], [], [], [0]
    row_no = 0   # global data-row count, for error messages across chunks

    def flush():
        top = int(max(indices)) + 1 if indices else 0
        d = n_features if n_features is not None else top
        if top > d:
            raise ValueError(f"feature index {top - 1} out of range for "
                             f"n_features={d}")
        csr = CSRMatrix(np.asarray(data, np.float32),
                        np.asarray(indices, np.int32),
                        np.asarray(indptr, np.int64),
                        (len(labels), d))
        return csr, np.asarray(labels, np.float32)

    for line in _iter_source_lines(source):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        row_no += 1
        row = []
        for tok in parts[1:]:
            i, v = tok.split(":")
            idx = int(i) - off
            if idx < 0:
                raise ValueError(f"negative feature index in {tok!r} "
                                 f"(zero_based={zero_based})")
            row.append((idx, float(v)))
        row.sort()
        for (a, _), (b, _) in zip(row, row[1:]):
            if a == b:
                raise ValueError(f"duplicate feature index {a + off} on "
                                 f"line {row_no}")
        indices.extend(i for i, _ in row)
        data.extend(v for _, v in row)
        indptr.append(len(indices))
        if len(labels) == chunk_rows:
            yield flush()
            labels, data, indices, indptr = [], [], [], [0]
    if labels or row_no == 0:     # trailing partial chunk, or empty input
        yield flush()


def csr_vstack(blocks: Iterable[CSRMatrix],
               d: Optional[int] = None) -> CSRMatrix:
    """Stack CSR blocks row-wise; `d` defaults to the widest block."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("csr_vstack needs at least one block")
    d = max(b.shape[1] for b in blocks) if d is None else d
    for b in blocks:
        if b.shape[1] > d:
            raise ValueError(f"block width {b.shape[1]} exceeds d={d}")
    indptr = [np.asarray([0], np.int64)]
    base = 0
    for b in blocks:
        indptr.append(b.indptr[1:] + base)
        base += b.nnz
    return CSRMatrix(np.concatenate([b.data for b in blocks]),
                     np.concatenate([b.indices for b in blocks]),
                     np.concatenate(indptr),
                     (sum(b.shape[0] for b in blocks), d))


def load_libsvm(source: Union[str, pathlib.Path, Iterable[str]], *,
                n_features: Optional[int] = None,
                zero_based: bool = False,
                chunk_rows: Optional[int] = None
                ) -> Tuple[CSRMatrix, np.ndarray]:
    """Parse LIBSVM-format text: ``<label> <idx>:<val> <idx>:<val> ...``.

    `source` is a path or an iterable of lines. Indices are 1-based by
    default; '#' starts a comment; columns are sorted within each row.
    Returns (CSRMatrix, labels float32). `chunk_rows` parses in CSR
    blocks of that many rows (the same result)."""
    chunks = list(iter_libsvm_chunks(
        source, chunk_rows=chunk_rows if chunk_rows is not None else 2**62,
        n_features=n_features, zero_based=zero_based))
    labels = np.concatenate([y for _, y in chunks])
    if len(chunks) == 1:
        return chunks[0][0], labels
    return csr_vstack([c for c, _ in chunks], d=n_features), labels


def csr_to_ell(csr: CSRMatrix, r_max: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cols (n, r_max) int32, vals (n, r_max) f32, nnz (n,) int32).

    Padding entries are (0, 0.0) -- exact no-ops for gather/scatter."""
    nnz = csr.row_nnz()
    need = int(nnz.max()) if nnz.size else 0
    r_max = need if r_max is None else r_max
    if r_max < need:
        raise ValueError(f"r_max={r_max} < max row nnz {need}")
    n = csr.shape[0]
    slot = np.arange(max(r_max, 1))[None, :] < nnz[:, None]   # (n, r_max)
    cols = np.zeros((n, max(r_max, 1)), np.int32)
    vals = np.zeros((n, max(r_max, 1)), np.float32)
    cols[slot] = csr.indices
    vals[slot] = csr.data
    return cols, vals, nnz


def ell_to_csr(cols: np.ndarray, vals: np.ndarray, nnz: np.ndarray,
               d: int) -> CSRMatrix:
    """Inverse of `csr_to_ell` (drops padding entries)."""
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    nnz = np.asarray(nnz).astype(np.int64)
    n, r_max = cols.shape
    slot = np.arange(max(r_max, 1))[None, :] < nnz[:, None]
    indptr = np.concatenate([[0], np.cumsum(nnz)])
    return CSRMatrix(vals[slot].astype(np.float32),
                     cols[slot].astype(np.int32),
                     indptr, (n, d))


@dataclasses.dataclass(frozen=True)
class SparseShards:
    """Padded-ELL worker shards: the sparse analogue of the dense
    (K, nk, d) partition. Leaves carry the leading K axis."""
    cols: torch.Tensor    # (K, nk, r_max) int32, padding -> 0
    vals: torch.Tensor    # (K, nk, r_max) float32, padding -> 0.0
    nnz: torch.Tensor     # (K, nk) int32 true entries per row
    d: int

    @property
    def r_max(self) -> int:
        return self.cols.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def density(self) -> float:
        rows = self.nnz.numel()
        return float(self.nnz.sum()) / max(rows * self.d, 1)


@dataclasses.dataclass(frozen=True)
class FeatureShards:
    """Worker shards sliced by feature block for a (data=K, model=M) mesh.

    Model shard m of worker k keeps the entries whose global column lies in
    [m d_local, (m+1) d_local), stored with shard-local ids (global -
    m d_local): the contiguous block map of `comm.WSpec(d, M)`. Padding
    slots are (local col 0, val 0.0). `nnz` counts each slice's true
    entries; `d` is the global unpadded width, M d_local the padded one.
    M = 1 holds the `SparseShards` arrays with a singleton model axis."""
    cols: torch.Tensor    # (K, M, nk, r_loc) int32 shard-local ids
    vals: torch.Tensor    # (K, M, nk, r_loc) float32
    nnz: torch.Tensor     # (K, M, nk) int32 true entries per row slice
    d: int
    M: int
    d_local: int

    @property
    def r_loc(self) -> int:
        return self.cols.shape[-1]

    @property
    def d_padded(self) -> int:
        return self.M * self.d_local

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def model_shard_view(self) -> SparseShards:
        """At M = 1, the same tensors as `SparseShards` (no copy)."""
        if self.M != 1:
            raise ValueError(f"model_shard_view needs M = 1, got M={self.M}")
        return SparseShards(self.cols[:, 0], self.vals[:, 0],
                            self.nnz[:, 0], d=self.d_local)


def shard_features(sh: SparseShards, M: int) -> FeatureShards:
    """Slice worker ELL shards along the feature axis into M model shards
    with shard-local column ids, on the host with numpy (arrays equal to
    the reference's `shard_features`), then onto `sh`'s device."""
    cols = sh.cols.cpu().numpy()
    vals = sh.vals.cpu().numpy()
    K, nk, r_max = cols.shape
    d_local = -(-sh.d // M)
    live = np.arange(r_max)[None, None, :] < sh.nnz.cpu().numpy()[:, :, None]
    owner = np.where(live, cols // d_local, -1)        # padding owns nothing
    slice_nnz = np.stack([(owner == m).sum(-1) for m in range(M)], axis=1)
    r_loc = max(int(slice_nnz.max()) if slice_nnz.size else 0, 1)
    out_c = np.zeros((K, M, nk, r_loc), np.int32)
    out_v = np.zeros((K, M, nk, r_loc), np.float32)
    for m in range(M):
        sel = owner == m                               # (K, nk, r_max)
        slot = np.cumsum(sel, axis=-1) - 1             # dest slot per entry
        kk, ii, _ = np.nonzero(sel)
        out_c[kk, m, ii, slot[sel]] = cols[sel] - m * d_local
        out_v[kk, m, ii, slot[sel]] = vals[sel]
    dev = sh.device
    return FeatureShards(torch.from_numpy(out_c).to(dev),
                         torch.from_numpy(out_v).to(dev),
                         torch.from_numpy(slice_nnz.astype(np.int32)).to(dev),
                         d=sh.d, M=M, d_local=d_local)


def shard_features_streaming(chunks, K: int, M: int = 1, *,
                             n_features: Optional[int] = None,
                             device=DEFAULT_DEVICE):
    """`FeatureShards` built incrementally from streamed (CSRMatrix,
    labels) blocks -- e.g. `iter_libsvm_chunks` -- without a host-side
    full-width array: peak host memory is O(nnz) entry lists plus the
    final padded blocks, independent of n r_max.

    Rows are dealt round-robin in arrival order (row j -> worker j % K) and
    sliced into their M feature blocks on arrival with shard-local column
    ids (d_local = ceil(d/M)), so the result is the `FeatureShards`
    `shard_features` gives for the same row assignment. `n_features` fixes
    d up front (required unless the chunks carry a stable width). Returns
    (FeatureShards, y (K, nk), mask (K, nk)) on `device`, zero-padded and
    masked at each worker's tail."""
    if K < 1 or M < 1:
        raise ValueError(f"need K >= 1 and M >= 1, got K={K} M={M}")
    dev = resolve_device(device)
    d = n_features
    d_local = None
    # one tuple of flat per-entry arrays per chunk (k, m, local row, ELL
    # slot, local col, val) and one (rows, M) slice-count block; the padded
    # output is allocated once at the end, when n and r_loc are known
    entry_blocks, count_blocks, label_blocks = [], [], []
    n = 0
    for csr, y in chunks:
        if d is None:
            d = csr.shape[1]
            if d < 1:
                raise ValueError("cannot infer d from an empty first chunk; "
                                 "pass n_features")
        if csr.shape[1] > d:
            raise ValueError(f"chunk width {csr.shape[1]} exceeds d={d}; "
                             f"pass n_features for a stable column count")
        if d_local is None:
            d_local = -(-d // M)
        nc = csr.shape[0]
        if nc == 0:
            continue
        ip = csr.indptr.astype(np.int64)
        row_nnz = np.diff(ip)
        row_of = np.repeat(np.arange(nc, dtype=np.int64), row_nnz)
        owner = csr.indices.astype(np.int64) // d_local
        # entries are column-sorted within a row, so each row's m-slices
        # are contiguous runs: the slice counts give every entry's slot
        counts = np.zeros((nc, M), np.int64)
        np.add.at(counts, (row_of, owner), 1)
        starts = np.zeros((nc, M), np.int64)
        starts[:, 1:] = np.cumsum(counts, axis=1)[:, :-1]
        pos_in_row = np.arange(len(row_of)) - np.repeat(ip[:-1], row_nnz)
        slot = pos_in_row - starts[row_of, owner]
        g = n + row_of                       # global arrival row id
        entry_blocks.append((
            (g % K).astype(np.int32), owner.astype(np.int32),
            (g // K).astype(np.int64), slot,
            (csr.indices - owner * d_local).astype(np.int32),
            csr.data.astype(np.float32)))
        gr = n + np.arange(nc, dtype=np.int64)
        count_blocks.append(((gr % K).astype(np.int32), gr // K, counts))
        label_blocks.append(np.asarray(y, np.float32))
        n += nc
    if d is None:
        raise ValueError("empty stream and no n_features; cannot size d")
    if n == 0:
        raise ValueError("empty stream: no rows to shard (a zero-row "
                         "FeatureShards would certify NaN gaps downstream)")
    d_local = -(-d // M)
    nk = -(-n // K)
    r_loc = max((int(c.max()) for _, _, c in count_blocks if c.size),
                default=0)
    r_loc = max(r_loc, 1)
    cols = np.zeros((K, M, nk, r_loc), np.int32)
    vals = np.zeros((K, M, nk, r_loc), np.float32)
    nnz = np.zeros((K, M, nk), np.int32)
    yp = np.zeros((K, nk), np.float32)
    mask = np.zeros((K, nk), np.float32)
    for (ke, me, re, se, ce, ve), (kr, rr, cnt), yb in zip(
            entry_blocks, count_blocks, label_blocks):
        cols[ke, me, re, se] = ce
        vals[ke, me, re, se] = ve
        nnz[kr, :, rr] = cnt
        yp[kr, rr] = yb
        mask[kr, rr] = 1.0
    fs = FeatureShards(torch.from_numpy(cols).to(dev),
                       torch.from_numpy(vals).to(dev),
                       torch.from_numpy(nnz).to(dev), d=d, M=M,
                       d_local=d_local)
    return fs, torch.from_numpy(yp).to(dev), torch.from_numpy(mask).to(dev)


def check_cols(cols: np.ndarray, d: int) -> None:
    """Column ids must lie in [0, d). Checked on the host, once, where the
    shards are built: the sparse kernel indexes u with them unchecked."""
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= d):
        raise ValueError(f"column ids must lie in [0, {d})")


def shards_from_arrays(cols, vals, nnz, d: int,
                       device=DEFAULT_DEVICE) -> SparseShards:
    """`SparseShards` from array-likes -- e.g. the leaves of the reference's
    `repro.data.sparse.SparseShards` converted to numpy."""
    dev = resolve_device(device)

    def t(a, dtype):     # np.array copies: the inputs may be read-only views
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    cols = np.asarray(cols)
    check_cols(cols, d)
    return SparseShards(t(cols, np.int32), t(vals, np.float32),
                        t(nnz, np.int32), d=int(d))


def _global_cols(fs: FeatureShards) -> torch.Tensor:
    """A FeatureShards' column ids in the padded global frame, as int64."""
    off = torch.arange(fs.M, device=fs.device) * fs.d_local
    return fs.cols.long() + off[None, :, None, None]


def matvec(sh, w: torch.Tensor) -> torch.Tensor:
    """z = A^T w per row:  z_i = sum_r vals[i, r] * w[cols[i, r]], (K, nk).
    For `FeatureShards` w is the padded (M d_local,) vector: the per-shard
    partial dots, summed over the model axis."""
    if isinstance(sh, FeatureShards):
        per_m = torch.sum(sh.vals * w[_global_cols(sh)], dim=-1)
        return torch.sum(per_m, dim=1)
    return torch.sum(sh.vals * w[sh.cols.long()], dim=-1)


def rmatvec(sh, coef: torch.Tensor) -> torch.Tensor:
    """A coef = sum_i coef_i x_i as a scatter-add: (d,) for `SparseShards`,
    the padded (M d_local,) vector for `FeatureShards` (padded coordinates
    receive nothing)."""
    if isinstance(sh, FeatureShards):
        contrib = sh.vals * coef[:, None, :, None]
        out = torch.zeros(sh.d_padded, dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add_(0, _global_cols(sh).reshape(-1),
                              contrib.reshape(-1))
    contrib = sh.vals * coef[..., None]
    out = torch.zeros(sh.d, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, sh.cols.reshape(-1).long(), contrib.reshape(-1))


def row_sqnorms(sh) -> torch.Tensor:
    """||x_i||^2 per row, (K, nk); for `FeatureShards` the slices' masses
    summed over the model axis (the global norms the 2-D solvers need)."""
    if isinstance(sh, FeatureShards):
        return torch.sum(sh.vals * sh.vals, dim=(-3, -1))
    return torch.sum(sh.vals * sh.vals, dim=-1)


def densify(sh) -> torch.Tensor:
    """Dense (K, nk, d) rows; `FeatureShards` densify to the padded
    (K, nk, M d_local) width with local ids lifted back to global."""
    if isinstance(sh, FeatureShards):
        cols, width = _global_cols(sh).transpose(1, 2), sh.d_padded
        vals = sh.vals.transpose(1, 2)
        K, nk = cols.shape[:2]
        cols, vals = cols.reshape(K, nk, -1), vals.reshape(K, nk, -1)
    else:
        cols, vals, width = sh.cols.long(), sh.vals, sh.d
        K, nk = cols.shape[:2]
    out = torch.zeros((K, nk, width), dtype=vals.dtype, device=vals.device)
    # accumulate, don't assign: duplicate (row, col) entries sum
    return out.scatter_add_(2, cols, vals)


def make_sparse_classification(n: int, d: int, *, density: float,
                               seed: int = 0, noise: float = 0.1
                               ) -> Tuple[CSRMatrix, np.ndarray]:
    """Binary labels in {-1, +1} on rows with ~density*d nonzeros, ||x|| <= 1.

    Row nnz is Poisson around density*d (clipped to [1, d]) so r_max stays a
    small multiple of the mean -- the padded-ELL waste is bounded."""
    rng = np.random.default_rng(seed)
    base = max(1, int(round(density * d)))
    nnz = np.clip(rng.poisson(base, n), 1, d).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(nnz)])
    indices = np.empty(int(indptr[-1]), np.int32)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        indices[lo:hi] = np.sort(rng.choice(d, hi - lo, replace=False))
    # normalize rows (paper Remark 7: ||x_i|| <= 1)
    norms = np.sqrt(np.add.reduceat(data * data, indptr[:-1]))
    data /= np.maximum(np.repeat(norms, nnz), 1e-12)
    csr = CSRMatrix(data, indices, indptr, (n, d))
    w_star = rng.standard_normal(d).astype(np.float32)
    margin = np.add.reduceat(data * w_star[indices], indptr[:-1])
    flip = rng.random(n) < noise
    yv = np.sign(margin) * np.where(flip, -1.0, 1.0)
    yv[yv == 0] = 1.0
    return csr, yv.astype(np.float32)


def partition_sparse(csr: CSRMatrix, y: np.ndarray, K: int, *, seed: int = 0,
                     heterogeneity: float = 1.0,
                     r_max: Optional[int] = None, M: int = 1,
                     device=DEFAULT_DEVICE):
    """Shuffle + split CSR rows into (shards, y (K, nk), mask (K, nk)) on
    `device`. Same contract as the dense `partition` (identical rng stream,
    padding rows are all-zero with mask 0). `M > 1` slices each worker's
    rows by feature block into `FeatureShards` (`shard_features`); the row
    partition, and so y and mask, is the same for every M."""
    dev = resolve_device(device)
    n, d = csr.shape
    check_cols(csr.indices, d)
    cols_e, vals_e, nnz_e = csr_to_ell(csr, r_max)
    rng = np.random.default_rng(seed)
    order = split_order(
        n, rng, heterogeneity,
        lambda r: np.sum(
            vals_e * r.standard_normal(d).astype(np.float32)[cols_e], axis=1))
    nk = (n + K - 1) // K
    pad = nk * K - n
    rm = cols_e.shape[1]
    colsp = np.concatenate([cols_e[order], np.zeros((pad, rm), np.int32)])
    valsp = np.concatenate([vals_e[order], np.zeros((pad, rm), np.float32)])
    nnzp = np.concatenate([nnz_e[order], np.zeros(pad, np.int32)])
    yp = np.concatenate([np.asarray(y)[order],
                         np.zeros(pad, np.asarray(y).dtype)])
    mk = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    shards = SparseShards(torch.from_numpy(colsp.reshape(K, nk, rm)),
                          torch.from_numpy(valsp.reshape(K, nk, rm)),
                          torch.from_numpy(nnzp.reshape(K, nk)), d=d)
    if M > 1:          # sliced on the host, before anything moves
        shards = shard_features(shards, M)
    shards = dataclasses.replace(shards, cols=shards.cols.to(dev),
                                 vals=shards.vals.to(dev),
                                 nnz=shards.nnz.to(dev))
    return (shards, torch.from_numpy(yp.reshape(K, nk)).to(dev),
            torch.from_numpy(mk.reshape(K, nk)).to(dev))
