"""The port's data pipeline against the reference's: the numpy generators and
partitioners are the same code, so arrays must be *equal*, not close. The
sparse matvec family is held to rtol 1e-6 (float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import load as rload, partition as rpartition
from repro.data import sparse as rsparse
from repro_torch.data import load, partition, partition_sparse, sparse
from repro_torch.data import shards_from_arrays

from torch_parity import to_np


@pytest.mark.parametrize("name", ["tiny", "illcond", "rcv1_like"])
def test_dense_load_equal(name):
    (Xr, yr), (Xp, yp) = rload(name), load(name)
    assert np.array_equal(Xr, Xp) and np.array_equal(yr, yp)


def test_sparse_load_equal():
    (cr, yr), (cp, yp) = rload("tiny_sparse"), load("tiny_sparse")
    for a, b in zip(cr[:3], cp[:3]):
        assert np.array_equal(a, b)
    assert cr.shape == cp.shape and np.array_equal(yr, yp)
    assert np.array_equal(cr.toarray(), cp.toarray())


@pytest.mark.parametrize("het", [1.0, 0.5])
@pytest.mark.parametrize("K", [4, 7])
def test_partition_equal(K, het):
    X, y = load("tiny")
    ref = rpartition(X, y, K, seed=3, heterogeneity=het)
    port = partition(X, y, K, seed=3, heterogeneity=het, device="cpu")
    for r, p in zip(ref, port):
        assert p.device.type == "cpu"
        assert np.array_equal(np.asarray(r), to_np(p))


@pytest.mark.parametrize("het", [1.0, 0.5])
@pytest.mark.parametrize("K", [4, 7])
def test_partition_sparse_equal(K, het):
    csr, y = load("tiny_sparse")
    sh_r, y_r, m_r = rsparse.partition_sparse(csr, y, K, seed=3,
                                              heterogeneity=het)
    sh_p, y_p, m_p = partition_sparse(csr, y, K, seed=3, heterogeneity=het,
                                      device="cpu")
    assert sh_p.d == sh_r.d and sh_p.r_max == sh_r.r_max
    for name in ("cols", "vals", "nnz"):
        assert np.array_equal(np.asarray(getattr(sh_r, name)),
                              to_np(getattr(sh_p, name)))
    assert sh_p.cols.dtype == torch.int32 and sh_p.vals.dtype == torch.float32
    assert np.array_equal(np.asarray(y_r), to_np(y_p))
    assert np.array_equal(np.asarray(m_r), to_np(m_p))
    assert sh_p.density == pytest.approx(sh_r.density)


def test_csr_to_ell_equal():
    csr, _ = load("tiny_sparse")
    for r_max in (None, 64):
        for a, b in zip(rsparse.csr_to_ell(csr, r_max),
                        sparse.csr_to_ell(csr, r_max)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        sparse.csr_to_ell(csr, 3)


def test_shards_from_reference_arrays_and_matvec_family():
    csr, y = load("tiny_sparse")
    sh_r, _, _ = rsparse.partition_sparse(csr, y, 4, seed=0)
    sh_p = shards_from_arrays(np.asarray(sh_r.cols), np.asarray(sh_r.vals),
                              np.asarray(sh_r.nnz), sh_r.d, device="cpu")
    rng = np.random.default_rng(0)
    w = rng.standard_normal(sh_r.d).astype(np.float32)
    coef = rng.standard_normal(sh_r.nnz.shape).astype(np.float32)
    np.testing.assert_allclose(
        to_np(sparse.matvec(sh_p, torch.from_numpy(w))),
        np.asarray(rsparse.matvec(sh_r, jnp.asarray(w))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        to_np(sparse.rmatvec(sh_p, torch.from_numpy(coef))),
        np.asarray(rsparse.rmatvec(sh_r, jnp.asarray(coef))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(to_np(sparse.row_sqnorms(sh_p)),
                               np.asarray(rsparse.row_sqnorms(sh_r)),
                               rtol=1e-6)


def test_shards_from_arrays_rejects_out_of_range_columns():
    cols = np.zeros((1, 2, 3), np.int32)
    cols[0, 1, 2] = 9
    with pytest.raises(ValueError, match="column ids"):
        shards_from_arrays(cols, np.ones((1, 2, 3), np.float32),
                           np.full((1, 2), 3, np.int32), 9, device="cpu")


def test_partition_sparse_rejects_out_of_range_columns():
    """Column ids are checked once on the host, where the shards are built:
    the sparse kernel indexes u with them unchecked."""
    csr = sparse.CSRMatrix(np.ones(3, np.float32),
                           np.array([0, 2, 5], np.int32),
                           np.array([0, 2, 3], np.int64), (2, 5))
    with pytest.raises(ValueError, match=r"column ids must lie in \[0, 5\)"):
        partition_sparse(csr, np.ones(2, np.float32), 2, device="cpu")
