"""The dense kernel's windowed lookahead, replayed in plain torch on the CPU.

`csrc/local_sdca.cu` walks the visit order in windows of B rows: from the
window's start u0 it takes z0 = X_B u0 and the Gram G = X_B X_B^T, runs the
B closed-form updates in order with z_j = z0_j + sum_{l<j} c_l G_lj and
q_j = scale G_jj, then applies u = u0 + X_B^T c. Windows never cross a pass
boundary. `window_replay` below is that schedule in plain torch (the kernel
itself runs only on the card), held here to

  * the reference's `local_sdca_ref` and its Pallas `local_sdca_pallas` in
    interpret mode (as tests/test_torch_kernels.py runs them), at rtol 1e-4
    and atol 1e-5, the tolerance chip_smoke.py's phase 3 holds the kernel
    to, for every closed-form loss, B = 1, 3, 8, 16, nk = 44 (a multiple of
    none of them but 1), two passes, zero and masked rows;
  * the port's `local_sdca_plain` bit for bit at B = 1, where the replay
    takes its dots as the plain version does (torch.sum of products);
  * a float64 sequential walk to 1e-12 at B = 8: the algebra alone, without
    float32 rounding;
  * the pass boundary: with nk = 5 < B = 8, windows cut at each pass agree
    with the sequential walk and windows run across passes do not.

The `cuda` tests hold the kernel at every window to `local_sdca_plain` on
the card; run them there with
`python -m pytest -q -m cuda tests/test_torch_dense_window.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.kernels import local_sdca as dk

from torch_parity import to_np

CLOSED_FORM = ["hinge", "smooth_hinge", "squared", "absolute"]
RTOL, ATOL = 1e-4, 1e-5
K, NK, D = 2, 44, 96


def window_replay(X, y, alpha, mask, w, scale, perm, *, loss, n_passes=1,
                  block_rows=8, cut_at_pass=True):
    """The kernel's schedule: windows of `block_rows` visit positions (cut
    at every pass boundary unless `cut_at_pass` is False), each from its
    start u0 and the rows' dalpha as they stand at the start, through z0,
    G and the in-order scalar updates, then the rank-B update of u in
    visit order. Works in X's dtype."""
    Kw, nk, d = X.shape
    dt = X.dtype
    ks = torch.arange(Kw)
    perm = perm.long()
    dalpha = torch.zeros((Kw, nk), dtype=dt)
    u = w.to(dt).expand(Kw, d).clone()
    order = perm.repeat(1, n_passes)                 # (K, n_passes nk)
    total = order.shape[1]
    starts = []
    for p in range(n_passes if cut_at_pass else 1):
        span = nk if cut_at_pass else total
        starts += [(p * nk + s, min(block_rows, span - s))
                   for s in range(0, span, block_rows)]
    for s0, nb in starts:
        rows = order[:, s0:s0 + nb]                  # (K, nb)
        XB = X[ks[:, None], rows]                    # (K, nb, d)
        z = torch.sum(XB * u[:, None, :], dim=-1)    # z0
        G = torch.sum(XB[:, :, None, :] * XB[:, None, :, :], dim=-1)
        dai = dalpha[ks[:, None], rows].clone()      # read at the start
        c = []
        for j in range(nb):
            i = rows[:, j]
            zj = z[:, j]
            for l in range(j):
                zj = zj + c[l] * G[:, l, j]
            q = scale * G[:, j, j]
            abar = alpha[ks, i] + dai[:, j]
            delta = loss.cd_update(abar, zj, q, y[ks, i]) * mask[ks, i]
            dalpha[ks, i] = dai[:, j] + delta
            c.append(scale * delta)
        for j in range(nb):
            u = u + c[j][:, None] * XB[:, j]
    return dalpha, u - w.to(dt)


def sequential_walk(X, y, alpha, mask, w, scale, perm, *, loss, n_passes=1):
    """The walk row after row in X's dtype (the float64 oracle)."""
    Kw, nk, d = X.shape
    ks = torch.arange(Kw)
    dalpha = torch.zeros((Kw, nk), dtype=X.dtype)
    u = w.to(X.dtype).expand(Kw, d).clone()
    for _ in range(n_passes):
        for j in range(nk):
            i = perm[:, j].long()
            x = X[ks, i]
            z = (x * u).sum(-1)
            q = scale * (x * x).sum(-1)
            abar = alpha[ks, i] + dalpha[ks, i]
            delta = loss.cd_update(abar, z, q, y[ks, i]) * mask[ks, i]
            dalpha[ks, i] += delta
            u = u + (scale * delta)[:, None] * x
    return dalpha, u - w.to(X.dtype)


def _case(seed, Kw=K, nk=NK, d=D, dtype=np.float32):
    """Inputs with a zero row (mask 1), a masked row and a zero masked
    row, made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((Kw, nk, d))
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    y = np.where(rng.random((Kw, nk)) < 0.5, -1.0, 1.0)
    alpha = y * rng.random((Kw, nk)) * 0.5
    mask = np.ones((Kw, nk))
    if nk >= 4:
        X[:, 1] = 0.0
        mask[:, 2] = 0.0
        X[:, -1], mask[:, -1], alpha[:, -1] = 0.0, 0.0, 0.0
    w = 0.1 * rng.standard_normal(d)
    perm = np.stack([rng.permutation(nk) for _ in range(Kw)])
    arrays = [a.astype(dtype) for a in (X, y, alpha, mask, w)]
    return arrays, perm.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def reference_runs():
    """`local_sdca_ref` and Pallas `local_sdca_pallas` (interpret mode) on
    `_case(0)`, per loss, worker by worker in visit order; dalpha back at
    the original row index. Computed once for every window."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import losses
    from repro.kernels import ref as rref
    from repro.kernels.local_sdca import local_sdca_pallas

    (X, y, alpha, mask, w), perm = _case(0)
    out = {}
    for name in CLOSED_FORM:
        rloss = losses.get_loss(name)
        runs = {}
        for kind in ("ref", "pallas"):
            das, dus = [], []
            for k in range(K):
                p = perm[k]
                args = [jnp.asarray(a[k][p]) for a in (X, y, alpha, mask)]
                if kind == "ref":
                    da_p, du = rref.local_sdca_ref(*args, jnp.asarray(w), 0.7,
                                                   loss=rloss, n_passes=2)
                else:
                    da_p, du = local_sdca_pallas(*args, jnp.asarray(w), 0.7,
                                                 loss=rloss, n_passes=2,
                                                 block_rows=4, interpret=True)
                da = np.zeros(NK, np.float32)
                da[p] = np.asarray(da_p)
                das.append(da)
                dus.append(np.asarray(du))
            runs[kind] = (np.stack(das), np.stack(dus))
        out[name] = runs
    return out


@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("loss_name", CLOSED_FORM)
def test_window_replay_matches_ref_and_pallas(reference_runs, loss_name, B):
    (X, y, alpha, mask, w), perm = _case(0)
    got = window_replay(*_t(X, y, alpha, mask, w), 0.7, *_t(perm),
                        loss=get_loss(loss_name), n_passes=2, block_rows=B)
    for kind in ("ref", "pallas"):
        for g, r in zip(got, reference_runs[loss_name][kind]):
            np.testing.assert_allclose(to_np(g), r, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{kind} B={B}")
    # masked rows stay exact no-ops; zero rows move nothing in u
    assert np.all(to_np(got[0])[:, [2, NK - 1]] == 0.0)


@pytest.mark.parametrize("loss_name", CLOSED_FORM)
def test_window_of_one_is_the_plain_version_bit_for_bit(loss_name):
    (X, y, alpha, mask, w), perm = _case(1)
    args = (*_t(X, y, alpha, mask, w), 0.7, *_t(perm))
    kw = dict(loss=get_loss(loss_name), n_passes=2)
    got = window_replay(*args, block_rows=1, **kw)
    want = dk.local_sdca_plain(*args, **kw)
    for g, p in zip(got, want):
        assert torch.equal(g, p)


@pytest.mark.parametrize("loss_name", CLOSED_FORM)
def test_window_algebra_in_float64_is_the_sequential_walk(loss_name):
    """Without float32 rounding the windowed schedule is the walk itself:
    B = 8 over nk = 37 (a ragged last window), two passes."""
    (X, y, alpha, mask, w), perm = _case(2, nk=37, dtype=np.float64)
    args = (*_t(X, y, alpha, mask, w), 0.7, *_t(perm))
    kw = dict(loss=get_loss(loss_name), n_passes=2)
    got = window_replay(*args, block_rows=8, **kw)
    want = sequential_walk(*args, **kw)
    for g, p in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(to_np(g), to_np(p), rtol=0, atol=1e-12)


def test_windows_are_cut_at_the_pass_boundary():
    """nk = 5 rows, B = 8, three passes: a window run across the pass
    boundary would hold each row twice and read its dalpha before its own
    first update; cut at each pass it is the walk. (Squared loss: its
    second visit of a row must be a no-op, and with a stale dalpha it is
    not. Hinge's clipped update happens to land on the same point.)"""
    (X, y, alpha, mask, w), perm = _case(3, nk=5, dtype=np.float64)
    mask[:] = 1.0
    args = (*_t(X, y, alpha, mask, w), 0.7, *_t(perm))
    kw = dict(loss=get_loss("squared"), n_passes=3, block_rows=8)
    want = sequential_walk(*args, loss=kw["loss"], n_passes=3)
    cut = window_replay(*args, **kw)
    across = window_replay(*args, cut_at_pass=False, **kw)
    for g, p in zip(cut, want):
        np.testing.assert_allclose(to_np(g), to_np(p), rtol=0, atol=1e-12)
    assert float((across[0] - want[0]).abs().max()) > 1e-3


def test_window_replay_is_the_plain_version_to_float32_rounding():
    """At B = 16 the replay's float32 sums part from the plain version's
    only by rounding."""
    (X, y, alpha, mask, w), perm = _case(4)
    args = (*_t(X, y, alpha, mask, w), 0.7, *_t(perm))
    kw = dict(loss=get_loss("smooth_hinge"), n_passes=2)
    got = window_replay(*args, block_rows=16, **kw)
    want = dk.local_sdca_plain(*args, **kw)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_at_any_window():
    (X, y, alpha, mask, w), perm = _case(5, nk=12)
    args = (*_t(X, y, alpha, mask, w), 0.5, *_t(perm))
    before = dk.LAUNCHES
    want = dk.local_sdca_plain(*args, loss=get_loss("hinge"))
    for B in dk.BLOCK_ROWS:
        got = dk.local_sdca(*args, loss=get_loss("hinge"), block_rows=B)
        assert all(torch.equal(g, p) for g, p in zip(got, want))
    assert dk.LAUNCHES == before
    with pytest.raises(ValueError, match="block_rows must be one of"):
        dk.local_sdca(*args, loss=get_loss("hinge"), block_rows=3)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_dense_window.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("d", [54, 2000, 2001])
def test_cuda_dense_kernel_at_every_window(card, B, d):
    """Kernel vs plain on the card at every window (rtol 1e-4, atol 1e-5:
    the window's dots and Gram sum in another order than torch.sum), nk =
    203 (a multiple of no window but 1), two passes; masked rows stay 0."""
    (X, y, alpha, mask, w), perm = _case(6 + B, Kw=3, nk=203, d=d)
    args = [a.to(card) for a in _t(X, y, alpha, mask, w)]
    p = torch.from_numpy(perm).to(card)
    for loss_name in CLOSED_FORM:
        kw = dict(loss=get_loss(loss_name), n_passes=2)
        before = dk.LAUNCHES
        got = dk.local_sdca(*args, 0.3, p, block_rows=B, **kw)
        assert dk.LAUNCHES == before + 1
        want = dk.local_sdca_plain(*args, 0.3, p, **kw)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)
        assert bool((got[0][:, [2, 202]] == 0).all())


@pytest.mark.cuda
def test_cuda_dense_kernel_refuses_what_does_not_fit(card):
    X = torch.zeros((1, 4, 65_536), device=card)
    v = torch.zeros((1, 4), device=card)
    with pytest.raises(ValueError, match="232448 bytes"):
        dk.local_sdca(X, v, v, v, torch.zeros(65_536, device=card), 0.5,
                      torch.zeros((1, 4), dtype=torch.int32, device=card),
                      loss=get_loss("hinge"))


def test_dense_budget_is_shape_arithmetic():
    """dense_smem_budget takes no card: epsilon's d = 2,000 at every
    window (whole rows up to B = 8, column tiles beyond)."""
    got = {B: dk.dense_smem_budget(2_000, B) for B in dk.BLOCK_ROWS}
    assert [got[B]["chunks"] for B in dk.BLOCK_ROWS] == [1, 1, 1, 1, 2, 3]
    assert all(b["fits"] for b in got.values())
    assert got[8]["d_tile"] == 2_000
