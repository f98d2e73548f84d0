"""The port's runtime (failures, elastic) against the reference's.

`drop_worker` / `fail_and_recover` act on the same state (the
reference's leaves through `state_from_reference`) and must land within
1e-6 of the reference's result, dense and sparse, under l2 and
elastic:0.5, and on FeatureShards for a (2, 2) one-card mesh.
`repartition` and `repartition_features` only copy, so their arrays must
equal the reference's bit for bit. Then tests/test_runtime.py's
invariance and round-trip tests, the hypothesis property included, run
on the port alone.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.core.cocoa import init_state as ref_init
from repro.core.regularizers import get_regularizer as ref_reg
from repro.data import load, make_classification
from repro.data import partition as ref_partition
from repro.data.sparse import partition_sparse as ref_partition_sparse
from repro.runtime import elastic as ref_elastic, failures as ref_failures
from repro_torch import comm
from repro_torch.core import (CoCoAConfig, duality, init_state, solve,
                              state_from_reference)
from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.data import SparseShards, partition, partition_sparse
from repro_torch.runtime import elastic, failures

import torch_parity as tp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                     # vendored deterministic fallback
    from _hypothesis_stub import given, settings, st

RTOL = 1e-6


def _data(kind: str, K: int):
    """(reference (X, y, mask), port (X, y, mask)) of one dataset, the
    same numpy rows on both sides."""
    if kind == "dense":
        X, y = load("tiny")
        return ref_partition(X, y, K), partition(X, y, K, device="cpu")
    csr, y = load("tiny_sparse")
    M = 2 if kind == "mesh2x2" else 1
    return (ref_partition_sparse(csr, y, K, M=M),
            partition_sparse(csr, y, K, M=M, device="cpu"))


def _width(X) -> int:
    if hasattr(X, "d_padded"):
        return X.d_padded
    return X.d if hasattr(X, "d") else X.shape[-1]


def _random_state(rng, X, y):
    """A reference state with feasible hinge duals and nonzero residuals,
    and its port twin from the reference's leaves."""
    K, nk = y.shape
    d = _width(X)
    st = ref_init(d, K, nk)._replace(
        w=jnp.asarray(rng.standard_normal(d).astype(np.float32)),
        alpha=jnp.asarray((np.asarray(y) * rng.random((K, nk)))
                          .astype(np.float32)),
        alpha_bar=jnp.asarray(rng.random((K, nk)).astype(np.float32)),
        ef=jnp.asarray(rng.standard_normal((K, d)).astype(np.float32)))
    return st, state_from_reference(tp.state_arrays(st), device="cpu")


def _close(port, ref, what):
    np.testing.assert_allclose(tp.to_np(port), np.asarray(ref), rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(ref))),
                               err_msg=what)


@pytest.mark.parametrize("reg", ["l2", "elastic:0.5"])
@pytest.mark.parametrize("kind,K", [("dense", 8), ("sparse", 8),
                                    ("mesh2x2", 2)])
def test_fail_and_recover_matches_reference(kind, K, reg):
    (rX, ry, rm), (X, y, m) = _data(kind, K)
    ref_st, st = _random_state(np.random.default_rng(3), rX, ry)
    k, lam = 1, 1e-3
    ref_drop = ref_failures.drop_worker(ref_st, k)
    drop = failures.drop_worker(st, k)
    for leaf in ("alpha", "alpha_bar", "ef"):
        np.testing.assert_array_equal(tp.to_np(getattr(drop, leaf)),
                                      np.asarray(getattr(ref_drop, leaf)))
    assert torch.equal(st.alpha[k], torch.from_numpy(
        np.array(ref_st.alpha[k])))               # out of place
    ref_out = ref_failures.fail_and_recover(ref_st, rX, rm, lam, k=k,
                                            reg=ref_reg(reg))
    out = failures.fail_and_recover(st, X, m, lam, k=k,
                                    reg=get_regularizer(reg))
    assert out.w.shape[0] == _width(X)
    _close(out.w, ref_out.w, f"w after dropping worker {k}")
    assert not out.alpha[k].any() and not out.ef[k].any()


def test_fail_and_recover_on_a_solved_state_matches_reference():
    (rX, ry, rm), (X, y, m) = _data("dense", 8)
    ref = ref_solve(RefConfig.adding(8, loss="hinge", lam=1e-3, H=128),
                    rX, ry, rm, rounds=3, seed=0)
    st = state_from_reference(tp.state_arrays(ref.state), device="cpu")
    ref_out = ref_failures.fail_and_recover(ref.state, rX, rm, 1e-3, k=3)
    out = failures.fail_and_recover(st, X, m, 1e-3, k=3)
    _close(out.w, ref_out.w, "w")
    loss = get_loss("hinge")
    g = float(duality.duality_gap(out.alpha, X, y, m, loss, 1e-3))
    assert g >= -1e-6


@pytest.fixture(scope="module")
def padded():
    """n = 1,000 rows over K = 6 workers: 2 padded rows."""
    X, y = make_classification(1000, 16, seed=2)
    return ref_partition(X, y, 6, seed=1), partition(X, y, 6, seed=1,
                                                     device="cpu")


def _equal(port: dict, ref: dict):
    assert set(port) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(tp.to_np(port[name]),
                                      np.asarray(ref[name]), err_msg=name)
        assert tp.to_np(port[name]).dtype == np.asarray(ref[name]).dtype


@pytest.mark.parametrize("K_new", [3, 4, 5, 16])
def test_repartition_dense_equals_reference(padded, K_new):
    (rX, ry, rm), (X, y, m) = padded
    alpha = np.random.default_rng(K_new).random(m.shape).astype(np.float32)
    alpha *= tp.to_np(m)
    ref_new, ref_m = ref_elastic.repartition(
        {"X": rX, "y": ry, "alpha": jnp.asarray(alpha)}, rm, K_new)
    new, mnew = elastic.repartition(
        {"X": X, "y": y, "alpha": torch.from_numpy(alpha)}, m, K_new)
    _equal(new, ref_new)
    _equal({"mask": mnew}, {"mask": ref_m})


@pytest.mark.parametrize("K_new", [3, 4, 5, 16])
def test_repartition_sparse_shards_equals_reference(K_new):
    (rX, ry, rm), (X, y, m) = _data("sparse", 6)
    ref_new, ref_m = ref_elastic.repartition(
        {"cols": rX.cols, "vals": rX.vals, "nnz": rX.nnz, "y": ry}, rm,
        K_new)
    new, mnew = elastic.repartition(
        {"cols": X.cols, "vals": X.vals, "nnz": X.nnz, "y": y}, m, K_new)
    _equal(new, ref_new)
    _equal({"mask": mnew}, {"mask": ref_m})
    assert int(mnew.sum()) == int(m.sum())


@pytest.mark.parametrize("K_new", [2, 4, 5])
def test_repartition_features_equals_reference(K_new):
    (rX, ry, rm), (X, y, m) = _data("mesh2x2", 3)
    alpha = (tp.to_np(y) * 0.5).astype(np.float32)
    ref_fs, ref_y, ref_a, ref_m = ref_elastic.repartition_features(
        rX, ry, jnp.asarray(alpha), rm, K_new)
    fs, y2, a2, m2 = elastic.repartition_features(
        X, y, torch.from_numpy(alpha), m, K_new)
    _equal({"cols": fs.cols, "vals": fs.vals, "nnz": fs.nnz, "y": y2,
            "alpha": a2, "mask": m2},
           {"cols": ref_fs.cols, "vals": ref_fs.vals, "nnz": ref_fs.nnz,
            "y": ref_y, "alpha": ref_a, "mask": ref_m})
    assert (fs.d, fs.M, fs.d_local) == (ref_fs.d, ref_fs.M, ref_fs.d_local)
    assert fs.cols.is_contiguous() and fs.vals.is_contiguous()


# ----------------------------------------------------------------------------
# tests/test_runtime.py's fault-tolerance tests on the port
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    X, y = make_classification(1024, 32, seed=0)
    return partition(X, y, 8, seed=1, device="cpu")


def test_worker_failure_dual_safe_recovery(problem):
    """Dropping a worker's duals keeps the certificate valid and the run
    recovers monotonically."""
    Xp, yp, mk = problem
    loss = get_loss("hinge")
    cfg = CoCoAConfig.adding(8, loss="hinge", lam=1e-3, H=256)
    r = solve(cfg, Xp, yp, mk, rounds=10, gap_every=10)
    gap_before = r.history["gap"][-1]
    st = failures.fail_and_recover(r.state, Xp, mk, cfg.lam, k=3)
    g = float(duality.duality_gap(st.alpha, Xp, yp, mk, loss, cfg.lam))
    assert g >= -1e-6
    assert not st.alpha[3].any()
    r2 = solve(cfg, Xp, yp, mk, rounds=15, gap_every=15, state=st)
    assert r2.history["gap"][-1] < g          # recovers
    assert r2.history["gap"][-1] < gap_before * 3


def test_elastic_repartition_objective_invariant(problem):
    """Re-splitting data+duals across a different K leaves P, D unchanged."""
    Xp, yp, mk = problem
    loss = get_loss("hinge")
    cfg = CoCoAConfig.adding(8, loss="hinge", lam=1e-3, H=128)
    r = solve(cfg, Xp, yp, mk, rounds=5, gap_every=5)
    arrs = {"X": Xp, "y": yp, "alpha": r.state.alpha}
    d_old = float(duality.dual(r.state.alpha, Xp, yp, mk, loss, cfg.lam))
    for K_new in (4, 16):
        new, mnew = elastic.repartition(arrs, mk, K_new)
        d_new = float(duality.dual(new["alpha"], new["X"], new["y"], mnew,
                                   loss, cfg.lam))
        assert abs(d_new - d_old) < 1e-5
        # resumed run still makes progress at the new K
        st = init_state(new["X"].shape[2], K_new, new["X"].shape[1],
                        device="cpu")
        st = st._replace(alpha=new["alpha"], w=r.state.w)
        cfg2 = CoCoAConfig.adding(K_new, loss="hinge", lam=1e-3, H=128)
        r2 = solve(cfg2, new["X"], new["y"], mnew, rounds=5, gap_every=5,
                   state=st)
        assert r2.history["gap"][-1] <= r.history["gap"][-1] + 1e-6


def test_elastic_repartition_gap_roundtrip(problem):
    """K -> K' -> K round trip: alpha travels with its datapoints, so the
    primal, dual, and duality gap are invariant across the cycle."""
    Xp, yp, mk = problem
    loss = get_loss("hinge")
    cfg = CoCoAConfig.adding(8, loss="hinge", lam=1e-3, H=128)
    r = solve(cfg, Xp, yp, mk, rounds=4, gap_every=4)
    arrs = {"X": Xp, "y": yp, "alpha": r.state.alpha}
    p0, d0, g0 = (float(v) for v in duality.gap_decomposed(
        r.state.alpha, Xp, yp, mk, loss, cfg.lam))
    for K_mid in (3, 5, 16):
        a1, m1 = elastic.repartition(arrs, mk, K_mid)
        p1, d1, g1 = (float(v) for v in duality.gap_decomposed(
            a1["alpha"], a1["X"], a1["y"], m1, loss, cfg.lam))
        a2, m2 = elastic.repartition(a1, m1, 8)
        p2, d2, g2 = (float(v) for v in duality.gap_decomposed(
            a2["alpha"], a2["X"], a2["y"], m2, loss, cfg.lam))
        for p, d, g in ((p1, d1, g1), (p2, d2, g2)):
            assert abs(p - p0) < 1e-5 and abs(d - d0) < 1e-5
            assert abs(g - g0) < 1e-5
        # back at K=8 the per-worker shapes match the originals
        assert a2["X"].shape == Xp.shape and a2["alpha"].shape == mk.shape


def test_elastic_sparse_shards_keep_the_objective():
    """The ELL shards re-split like dense rows: P and D unchanged."""
    _, (X, y, m) = _data("sparse", 8)
    loss = get_loss("hinge")
    alpha = (y * 0.3) * m
    before = duality.gap_decomposed(alpha, X, y, m, loss, 1e-3)
    new, mnew = elastic.repartition({"cols": X.cols, "vals": X.vals,
                                     "nnz": X.nnz, "y": y, "alpha": alpha},
                                    m, 5)
    sh = SparseShards(new["cols"], new["vals"], new["nnz"], d=X.d)
    after = duality.gap_decomposed(new["alpha"], sh, new["y"], mnew, loss,
                                   1e-3)
    for a, b in zip(before, after):
        assert abs(float(a) - float(b)) < 1e-6 * max(1.0, abs(float(a)))


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 12), st.integers(2, 12))
def test_elastic_repartition_roundtrip_property(K1, K2):
    """Property: repartition K->K1->K2 preserves the multiset of valid rows
    (and therefore every objective value) regardless of padding."""
    X, y = make_classification(257, 8, seed=K1 * 13 + K2)   # prime n: padding
    Xp, yp, mk = partition(X, y, 4, seed=0, device="cpu")
    arrs = {"X": Xp, "y": yp}
    a1, m1 = elastic.repartition(arrs, mk, K1)
    a2, m2 = elastic.repartition(a1, m1, K2)

    def valid_rows(Xa, ma):
        Xf = Xa.reshape(-1, Xa.shape[-1]).numpy()
        return Xf[ma.reshape(-1).numpy() > 0]

    r0 = valid_rows(Xp, mk)
    r2 = valid_rows(a2["X"], m2)
    assert r0.shape == r2.shape
    np.testing.assert_allclose(np.sort(r0.sum(axis=1)),
                               np.sort(r2.sum(axis=1)), rtol=1e-5)


# ----------------------------------------------------------------------------
# on the card: the re-split and the drop stay on the tensors' device
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_runtime.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resplit_and_drop_on_the_card_equal_the_cpu(card):
    _, (X, y, m) = _data("mesh2x2", 3)
    alpha = y * 0.25
    cpu = elastic.repartition_features(X, y, alpha, m, 5)
    on_card = elastic.repartition_features(
        type(X)(X.cols.to(card), X.vals.to(card), X.nnz.to(card), d=X.d,
                M=X.M, d_local=X.d_local), y.to(card), alpha.to(card),
        m.to(card), 5)
    assert on_card[0].vals.device.type == "cuda"
    for a, b in zip((cpu[0].cols, cpu[0].vals, cpu[0].nnz) + cpu[1:],
                    (on_card[0].cols, on_card[0].vals, on_card[0].nnz)
                    + on_card[1:]):
        assert torch.equal(a, b.cpu())
    st = init_state(X.d_padded, 3, y.shape[1], device=card)._replace(
        alpha=alpha.to(card))
    out = failures.drop_worker(st, 2)
    assert out.alpha.device.type == "cuda" and not out.alpha[2].any()
