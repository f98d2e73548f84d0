"""The port's LIBSVM ingest against the reference's: `load_libsvm`,
`iter_libsvm_chunks`, `csr_vstack`, `ell_to_csr` and
`shard_features_streaming` give arrays equal to the reference's -- equal,
not close: the same parse, the same dtypes, the same layout. The parsers
read in-memory line iterables; nothing is downloaded.
"""
import numpy as np
import pytest
import torch

from repro.data import load as ref_load
from repro.data import sparse as rsp
from repro_torch.data import sparse as psp

import torch_parity as tp

LINES = [
    "# a comment line",
    "+1 3:0.5 1:2 7:-1.25   # trailing comment",
    "",
    "-1 2:1e-3",
    "1",                                  # a row with no entries
    "-1 1:1 2:2 3:3 4:4 5:5 6:6 7:7 8:8",
    "   +1 8:0.125 4:-2   ",
]


def _csr_equal(got, want):
    for name in ("data", "indices", "indptr"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tuple(got.shape) == tuple(want.shape)


def _libsvm_lines(csr, y, zero_based=False):
    off = 0 if zero_based else 1
    out = []
    for i in range(csr.shape[0]):
        lo, hi = csr.indptr[i], csr.indptr[i + 1]
        toks = [f"{int(c) + off}:{float(v)!r}"
                for c, v in zip(csr.indices[lo:hi], csr.data[lo:hi])]
        out.append(" ".join([f"{float(y[i]):g}"] + toks))
    return out


@pytest.mark.parametrize("kw", [
    {}, {"zero_based": True}, {"n_features": 12}, {"chunk_rows": 1},
    {"chunk_rows": 2}, {"chunk_rows": 3, "n_features": 9},
    {"chunk_rows": 100},
])
def test_load_libsvm_equals_reference(kw):
    got, gy = psp.load_libsvm(iter(LINES), **kw)
    want, wy = rsp.load_libsvm(iter(LINES), **kw)
    _csr_equal(got, want)
    assert gy.dtype == wy.dtype
    np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("chunk_rows,n_features", [(1, None), (2, None),
                                                   (2, 10), (5, None)])
def test_iter_libsvm_chunks_equals_reference(chunk_rows, n_features):
    got = list(psp.iter_libsvm_chunks(LINES, chunk_rows=chunk_rows,
                                      n_features=n_features))
    want = list(rsp.iter_libsvm_chunks(LINES, chunk_rows=chunk_rows,
                                       n_features=n_features))
    assert len(got) == len(want)
    for (gc, gy), (wc, wy) in zip(got, want):
        _csr_equal(gc, wc)
        np.testing.assert_array_equal(gy, wy)


def test_empty_input_equals_reference():
    got, gy = psp.load_libsvm(["# nothing", ""])
    want, wy = rsp.load_libsvm(["# nothing", ""])
    _csr_equal(got, want)
    assert gy.shape == wy.shape == (0,)


@pytest.mark.parametrize("lines,kw,match", [
    (["1 2:1 2:3"], {}, "duplicate feature index 2"),
    (["1 0:1"], {}, "negative feature index"),
    (["1 5:1"], {"n_features": 4}, "out of range"),
    (["1 1:1"], {"chunk_rows": 0}, "chunk_rows must be >= 1"),
])
def test_parse_errors_match_reference(lines, kw, match):
    for mod in (psp, rsp):
        with pytest.raises(ValueError, match=match):
            mod.load_libsvm(lines, **kw)


def test_csr_vstack_equals_reference():
    blocks = [c for c, _ in psp.iter_libsvm_chunks(LINES, chunk_rows=2)]
    rblocks = [c for c, _ in rsp.iter_libsvm_chunks(LINES, chunk_rows=2)]
    _csr_equal(psp.csr_vstack(blocks), rsp.csr_vstack(rblocks))
    _csr_equal(psp.csr_vstack(blocks, d=20), rsp.csr_vstack(rblocks, d=20))
    for mod, bl in ((psp, blocks), (rsp, rblocks)):
        with pytest.raises(ValueError, match="exceeds d=3"):
            mod.csr_vstack(bl, d=3)
        with pytest.raises(ValueError, match="at least one block"):
            mod.csr_vstack([])


@pytest.mark.parametrize("r_max", [None, 11])
def test_ell_round_trip_equals_reference(r_max):
    csr, _ = psp.load_libsvm(LINES)
    cols, vals, nnz = psp.csr_to_ell(csr, r_max)
    got = psp.ell_to_csr(cols, vals, nnz, csr.shape[1])
    want = rsp.ell_to_csr(*rsp.csr_to_ell(csr, r_max), csr.shape[1])
    _csr_equal(got, want)
    _csr_equal(got, csr)


@pytest.fixture(scope="module")
def tiny_sparse_lines():
    csr, y = ref_load("tiny_sparse")
    return csr, y, _libsvm_lines(csr, y)


def test_tiny_sparse_through_libsvm_text(tiny_sparse_lines):
    """tiny_sparse written as LIBSVM text parses back to its own CSR on
    both sides."""
    csr, y, lines = tiny_sparse_lines
    got, gy = psp.load_libsvm(lines, n_features=csr.shape[1],
                              chunk_rows=100)
    want, wy = rsp.load_libsvm(lines, n_features=csr.shape[1],
                               chunk_rows=100)
    _csr_equal(got, want)
    np.testing.assert_array_equal(got.data, csr.data)
    np.testing.assert_array_equal(got.indices, csr.indices)
    np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("K,M,chunk_rows", [(4, 1, 64), (4, 2, 50),
                                            (3, 3, 1000), (8, 2, 7)])
def test_shard_features_streaming_equals_reference(tiny_sparse_lines, K, M,
                                                   chunk_rows):
    csr, _, lines = tiny_sparse_lines
    d = csr.shape[1]
    got_fs, got_y, got_m = psp.shard_features_streaming(
        psp.iter_libsvm_chunks(lines, chunk_rows=chunk_rows, n_features=d),
        K, M, n_features=d, device="cpu")
    want_fs, want_y, want_m = rsp.shard_features_streaming(
        rsp.iter_libsvm_chunks(lines, chunk_rows=chunk_rows, n_features=d),
        K, M, n_features=d)
    for name in ("cols", "vals", "nnz"):
        a, b = tp.to_np(getattr(got_fs, name)), np.asarray(getattr(want_fs,
                                                                   name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got_fs.d, got_fs.M, got_fs.d_local) == \
        (want_fs.d, want_fs.M, want_fs.d_local)
    np.testing.assert_array_equal(tp.to_np(got_y), np.asarray(want_y))
    np.testing.assert_array_equal(tp.to_np(got_m), np.asarray(want_m))


def test_streaming_equals_materialized_shard_features(tiny_sparse_lines):
    """The streamed FeatureShards are `shard_features` of the same
    round-robin row assignment, leaf for leaf."""
    csr, y, lines = tiny_sparse_lines
    K, M, d = 4, 2, csr.shape[1]
    fs, yp, mk = psp.shard_features_streaming(
        psp.iter_libsvm_chunks(lines, chunk_rows=33, n_features=d), K, M,
        device="cpu")
    n = csr.shape[0]
    nk = -(-n // K)
    cols, vals, nnz = psp.csr_to_ell(csr)
    r = cols.shape[1]
    order = np.arange(nk * K)
    wk, wi = order % K, order // K
    sc = np.zeros((K, nk, r), np.int32)
    sv = np.zeros((K, nk, r), np.float32)
    sn = np.zeros((K, nk), np.int32)
    live = order < n
    sc[wk[live], wi[live]] = cols
    sv[wk[live], wi[live]] = vals
    sn[wk[live], wi[live]] = nnz
    sh = psp.SparseShards(torch.from_numpy(sc), torch.from_numpy(sv),
                          torch.from_numpy(sn), d=d)
    want = psp.shard_features(sh, M)
    for name in ("cols", "vals", "nnz"):
        assert torch.equal(getattr(fs, name), getattr(want, name)), name
    assert float(mk.sum()) == n
    assert torch.equal(yp[mk > 0], torch.from_numpy(
        np.asarray(y, np.float32)[np.argsort(wk[live] * nk + wi[live],
                                             kind="stable")]))


def test_streaming_errors_match_reference():
    for mod, kw in ((psp, {"device": "cpu"}), (rsp, {})):
        with pytest.raises(ValueError, match="empty stream"):
            mod.shard_features_streaming(iter([]), 2, 1, **kw)
        with pytest.raises(ValueError, match="need K >= 1"):
            mod.shard_features_streaming(iter([]), 0, 1, **kw)
        chunks = mod.iter_libsvm_chunks(["1 9:1", "1 1:1"], chunk_rows=1)
        with pytest.raises(ValueError, match="exceeds d="):
            mod.shard_features_streaming(chunks, 2, 1, n_features=4, **kw)
