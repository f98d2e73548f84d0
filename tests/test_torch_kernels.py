"""The port's LocalSDCA kernels, held against the reference's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; these are held
against `local_sdca_pallas` / `sparse_local_sdca` in interpret mode and
against `repro.kernels.ref`, worker by worker, on the same numpy inputs and
the same visit order (the reference takes rows in permuted order, the port
reads row perm[k, j] in place). Tolerance rtol 1e-5, atol 1e-6: the d-dot
and r_max gather-dot are float32 sums taken in another order than XLA's,
and the difference compounds over the walk's dependent steps.

The `cuda` tests build the CUDA kernels and hold them against the plain
versions on the card; they skip where there is no card or nvcc. Run them
on the card with `PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernels.py`.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.kernels import local_sdca as dk, ops, ref as port_ref
from repro_torch.kernels import sparse_sdca as sk

from torch_parity import dense_block, ell_block, to_np

RTOL, ATOL = 1e-5, 1e-6
CLOSED_FORM = ["hinge", "smooth_hinge", "squared", "absolute"]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported only where a test asks for it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import losses, regularizers
    from repro.kernels import ops as rops, ref as rref
    from repro.kernels.local_sdca import local_sdca_pallas
    from repro.kernels.sparse_sdca import sparse_local_sdca
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, losses=losses, regs=regularizers, ops=rops,
        ref=rref, dense=local_sdca_pallas, sparse=sparse_local_sdca)


def _perm(rng, K, nk):
    return np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _per_worker(fn, perm, row_args, shared_args):
    """Run a one-worker reference fn on every worker's rows in visit order;
    dalpha goes back to the original row index."""
    K, nk = perm.shape
    das, dus = [], []
    for k in range(K):
        p = perm[k]
        da_p, du = fn(*[a[k][p] for a in row_args], *shared_args)
        da = np.zeros(nk, np.float32)
        da[p] = np.asarray(da_p)
        das.append(da)
        dus.append(np.asarray(du))
    return np.stack(das), np.stack(dus)


CASES = [(name, passes) for name in CLOSED_FORM for passes in (1, 2)]


@pytest.mark.parametrize("loss_name,n_passes", CASES)
def test_dense_plain_matches_pallas_and_ref(ref, loss_name, n_passes):
    rng = np.random.default_rng(0)
    K, nk, d = 2, 32, 128
    X, y, alpha, mask = dense_block(rng, K, nk, d, pad_rows=3)
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    perm, scale = _perm(rng, K, nk), 0.7
    got = dk.local_sdca(*_t(X, y, alpha, mask, w), scale, *_t(perm),
                        loss=get_loss(loss_name), n_passes=n_passes)
    rloss = ref.losses.get_loss(loss_name)
    pallas = _per_worker(
        lambda *a: ref.dense(*a, loss=rloss, n_passes=n_passes,
                             block_rows=16, interpret=True),
        perm, [ref.jnp.asarray(a) for a in (X, y, alpha, mask)],
        (ref.jnp.asarray(w), scale))
    oracle = _per_worker(
        lambda *a: ref.ref.local_sdca_ref(*a, loss=rloss, n_passes=n_passes),
        perm, [ref.jnp.asarray(a) for a in (X, y, alpha, mask)],
        (ref.jnp.asarray(w), scale))
    for want in (pallas, oracle):
        for g, r in zip(got, want):
            np.testing.assert_allclose(to_np(g), r, rtol=RTOL, atol=ATOL)
    # padding rows (mask 0) are exact no-ops
    assert np.all(to_np(got[0])[:, -3:] == 0.0)


SPARSE_CASES = ([(name, None, 1) for name in CLOSED_FORM]
                + [("hinge", 0.5, 2), ("smooth_hinge", 0.5, 1),
                   ("squared", None, 2), ("absolute", 0.25, 2)])


@pytest.mark.parametrize("loss_name,kappa,n_passes", SPARSE_CASES)
def test_sparse_plain_matches_pallas_and_ref(ref, loss_name, kappa,
                                             n_passes):
    rng = np.random.default_rng(1)
    K, nk, d, r_max = 2, 24, 40, 8
    cols, vals, _ = ell_block(rng, K, nk, d, r_max)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    perm, scale = _perm(rng, K, nk), 0.6
    got = sk.sparse_local_sdca(*_t(cols, vals, y, alpha, mask, w), scale,
                               *_t(perm), loss=get_loss(loss_name),
                               n_passes=n_passes, prox_kappa=kappa)
    rloss = ref.losses.get_loss(loss_name)
    rows = [ref.jnp.asarray(a) for a in (cols, vals, y, alpha, mask)]
    pallas = _per_worker(
        lambda *a: ref.sparse(*a, loss=rloss, n_passes=n_passes,
                              block_rows=8, prox_kappa=kappa,
                              interpret=True),
        perm, rows, (ref.jnp.asarray(w), scale))
    oracle = _per_worker(
        lambda *a: ref.ref.sparse_local_sdca_ref(
            *a, loss=rloss, n_passes=n_passes, prox_kappa=kappa),
        perm, rows, (ref.jnp.asarray(w), scale))
    for want in (pallas, oracle):
        for g, r in zip(got, want):
            np.testing.assert_allclose(to_np(g), r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("H_over_nk,reg", [(1.0, "l2"), (1.5, "l2"),
                                           (2.5, "elastic:0.5")])
def test_dense_block_solver_matches_reference_ops(ref, H_over_nk, reg):
    """ops.local_sdca_block: hoisted conj_grad, scale, H -> passes with
    Python's round (2.5 -> 2), the reference's permutation per worker."""
    rng = np.random.default_rng(2)
    K, nk, d = 2, 16, 24
    X, y, alpha, mask = dense_block(rng, K, nk, d)
    v = (0.3 * rng.standard_normal(d)).astype(np.float32)
    H, lam, n, sp = int(H_over_nk * nk), 1e-2, 40.0, 2.0
    key = ref.jax.random.PRNGKey(5)
    rngs = [ref.jax.random.fold_in(key, k) for k in range(K)]
    perm = np.stack([np.asarray(ref.jax.random.permutation(r, nk))
                     for r in rngs])
    got = ops.local_sdca_block(*_t(X, y, alpha, mask, v), torch.from_numpy(
        perm), get_loss("hinge"), lam, n, sp, H, reg=get_regularizer(reg))
    for k in range(K):
        want = ref.ops.local_sdca_block(
            *[ref.jnp.asarray(a[k]) for a in (X, y, alpha, mask)],
            ref.jnp.asarray(v), rngs[k], ref.losses.get_loss("hinge"), lam,
            n, sp, H, interpret=True, reg=ref.regs.get_regularizer(reg))
        np.testing.assert_allclose(to_np(got.dalpha[k]), want.dalpha,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(to_np(got.du[k]), want.du, rtol=RTOL,
                                   atol=ATOL)
        assert got.steps == int(want.steps)


@pytest.mark.parametrize("reg", ["l2", "elastic:0.5", "l1s:0.5"])
def test_sparse_block_solver_matches_reference_ops(ref, reg):
    """ops.sparse_local_sdca_block: fused prox for the soft-threshold
    regularizers (u in v-space), hoisted map for L2."""
    rng = np.random.default_rng(3)
    K, nk, d, r_max = 2, 16, 30, 6
    cols, vals, nnz = ell_block(rng, K, nk, d, r_max)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    H, lam, n, sp = 2 * nk, 0.1, 40.0, 2.0
    key = ref.jax.random.PRNGKey(6)
    rngs = [ref.jax.random.fold_in(key, k) for k in range(K)]
    perm = np.stack([np.asarray(ref.jax.random.permutation(r, nk))
                     for r in rngs])
    shard = types.SimpleNamespace(cols=torch.from_numpy(cols),
                                  vals=torch.from_numpy(vals))
    got = ops.sparse_local_sdca_block(
        shard, *_t(y, alpha, mask, v), torch.from_numpy(perm),
        get_loss("smooth_hinge"), lam, n, sp, H, reg=get_regularizer(reg))
    from repro.data.sparse import SparseShards as RefShards
    for k in range(K):
        want = ref.ops.sparse_local_sdca_block(
            RefShards(ref.jnp.asarray(cols[k]), ref.jnp.asarray(vals[k]),
                      ref.jnp.asarray(nnz[k]), d=d),
            *[ref.jnp.asarray(a[k]) for a in (y, alpha, mask)],
            ref.jnp.asarray(v), rngs[k], ref.losses.get_loss("smooth_hinge"),
            lam, n, sp, H, interpret=True, reg=ref.regs.get_regularizer(reg))
        np.testing.assert_allclose(to_np(got.dalpha[k]), want.dalpha,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(to_np(got.du[k]), want.du, rtol=RTOL,
                                   atol=ATOL)


def test_ref_module_reexports_plain_versions():
    assert port_ref.local_sdca_ref is dk.local_sdca_plain
    assert port_ref.sparse_local_sdca_ref is sk.sparse_local_sdca_plain


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(4)
    X, y, alpha, mask = dense_block(rng, 2, 8, 16)
    w = np.zeros(16, np.float32)
    perm = _perm(rng, 2, 8)
    before = (dk.LAUNCHES, sk.LAUNCHES)
    got = dk.local_sdca(*_t(X, y, alpha, mask, w), 0.5, *_t(perm),
                        loss=get_loss("hinge"))
    want = dk.local_sdca_plain(*_t(X, y, alpha, mask, w), 0.5, *_t(perm),
                               loss=get_loss("hinge"))
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    assert (dk.LAUNCHES, sk.LAUNCHES) == before


def test_wrappers_reject_what_the_kernels_cannot_run():
    rng = np.random.default_rng(5)
    X, y, alpha, mask = dense_block(rng, 1, 4, 8)
    args = _t(X, y, alpha, mask, np.zeros(8, np.float32))
    perm = _t(_perm(rng, 1, 4))[0]
    with pytest.raises(ValueError, match="closed-form"):
        dk.local_sdca(*args, 0.5, perm, loss=get_loss("logistic"))
    with pytest.raises(ValueError, match="closed-form"):
        sk.sparse_local_sdca(*_t(np.zeros((1, 4, 2), np.int32),
                                 np.zeros((1, 4, 2), np.float32)),
                             *args[1:], 0.5, perm, loss=get_loss("logistic"))
    with pytest.raises(ValueError, match=r"\(1, 4\)"):
        dk.local_sdca(*args, 0.5, perm[:, :3], loss=get_loss("hinge"))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        dk.local_sdca(*meta, 0.5, perm.to("meta"), loss=get_loss("hinge"))



@pytest.mark.parametrize("bad", [-1, 8])
def test_block_solvers_check_a_host_perm_before_the_copy(bad):
    """The kernels index with perm unchecked; the block solvers range-check
    a host perm before copying it to the kernel's device."""
    rng = np.random.default_rng(7)
    K, nk, d = 2, 8, 6
    X, y, alpha, mask = dense_block(rng, K, nk, d)
    perm = _perm(rng, K, nk)
    perm[1, 3] = bad
    v = np.zeros(d, np.float32)
    with pytest.raises(ValueError, match=r"perm entries must lie in \[0, 8\)"):
        ops.local_sdca_block(*_t(X, y, alpha, mask, v), torch.from_numpy(
            perm), get_loss("hinge"), 1e-2, 16.0, 2.0, nk)
    cols, vals, _ = ell_block(rng, K, nk, d, 3)
    shard = types.SimpleNamespace(cols=torch.from_numpy(cols),
                                  vals=torch.from_numpy(vals))
    with pytest.raises(ValueError, match=r"perm entries must lie in \[0, 8\)"):
        ops.sparse_local_sdca_block(shard, *_t(y, alpha, mask, v),
                                    torch.from_numpy(perm),
                                    get_loss("hinge"), 1e-2, 16.0, 2.0, nk)

def test_u_must_fit_shared_memory():
    dk.check_u_fits(47_236)                 # rcv1: 188,944 B of u
    with pytest.raises(ValueError, match="232448 bytes"):
        dk.check_u_fits(65_536)             # news_sparse does not fit


@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_kernels.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("loss_name", CLOSED_FORM)
def test_cuda_kernels_match_plain_on_the_card(card, loss_name):
    """Kernel vs plain on the card (tolerance rtol 1e-4, atol 1e-5: block
    reductions and shared-memory atomics reorder the float32 sums)."""
    rng = np.random.default_rng(6)
    K, nk, d = 4, 256, 2000
    X, y, alpha, mask = dense_block(rng, K, nk, d, pad_rows=5)
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    perm = _perm(rng, K, nk)
    args = [a.to(card) for a in _t(X, y, alpha, mask, w)]
    p = torch.from_numpy(perm).to(card)
    loss = get_loss(loss_name)
    before = dk.LAUNCHES
    got = dk.local_sdca(*args, 0.3, p, loss=loss, n_passes=2)
    assert dk.LAUNCHES == before + 1
    want = dk.local_sdca_plain(*args, 0.3, p, loss=loss, n_passes=2)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
    cols, vals, _ = ell_block(rng, K, nk, 47_236, 96)
    sargs = [a.to(card) for a in _t(cols, vals, y, alpha, mask,
                                     rng.standard_normal(47_236)
                                     .astype(np.float32))]
    for kappa in (None, 0.5):
        before = sk.LAUNCHES
        got = sk.sparse_local_sdca(*sargs, 0.3, p, loss=loss,
                                   prox_kappa=kappa)
        assert sk.LAUNCHES == before + 1
        want = sk.sparse_local_sdca_plain(*sargs, 0.3, p, loss=loss,
                                          prox_kappa=kappa)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
