"""The 1-D sparse walk with u in shared memory, split into a walk, a fetch
and a prep warp, and the ring its wrapper runs on the card.

On the CPU: `sparse_sdca.ring_plan`, the ring the card runs for each asked
`buffer_depth` (at least `D_CARD` where u stays in shared memory, clamped
to nk and to what fits beside u; the asked ring where u goes to device
memory), and that the CPU's plain version records no ring. The plain walk
at depth 4 on rows that repeat no id, with a real entry at column 0 beside
the padding, is held to the reference's pipelined kernel in interpret
mode (rtol 1e-5, atol 1e-6, as `test_torch_sparse_pipeline.py`).

The `cuda` tests force each ring (D_CARD read as 1) and hold it to the
one-stage ring bit for bit on rows that repeat no column id (the prep
warp marks them `plain`: a store scatter), and to the plain version within
rtol 1e-4, atol 1e-5 on rows that do (the compare-and-swap scatter), with
rows of both kinds in one launch, a real entry at column 0 beside padding,
every loss with the prox on and off, rows past 128 slots and the 4-byte
copy path; run them on the card with
`python -m pytest -q -m cuda tests/test_torch_sparse_walk_split.py`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.losses import get_loss as ref_get_loss
from repro.kernels.sparse_sdca import sparse_local_sdca as ref_sparse
from repro_torch.core.losses import get_loss
from repro_torch.data import partition_sparse
from repro_torch.data.sparse import CSRMatrix
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_sdca as sk

CLOSED_FORM = ["hinge", "smooth_hinge", "squared", "absolute"]
RING_1040 = 4 * (2 * 124 + 8) + 16      # a stage at r_max 118, its barriers
WIDEST = (232_448 - RING_1040) // 4      # u and one stage fill the limit


# ----------------------------------------------------------------------------
# the ring the card runs (shape arithmetic, on the CPU)
# ----------------------------------------------------------------------------

CARD = lambda asked: min(max(asked, sk.D_CARD), sk.MAX_DEPTH)


@pytest.mark.parametrize("asked,nk,d,r_max,depth,u_in_smem", [
    (1, 84_675, 47_236, 118, CARD(1), True),      # rcv1: row 2 -> D_CARD
    (2, 84_675, 47_236, 118, CARD(2), True),
    (4, 84_675, 47_236, 118, CARD(4), True),
    (8, 84_675, 47_236, 118, 8, True),            # a deeper ask stands
    (1, 3, 47_236, 118, 3, True),                 # clamped to nk
    (1, 1, 47_236, 118, 1, True),
    (8, 5, 47_236, 118, 5, True),
    (1, 84_675, WIDEST, 118, 1, True),   # a second stage would push u out
    (1, 84_675, WIDEST - 260, 118, min(2, CARD(1)), True),  # two fit
    (1, 84_675, WIDEST - 3 * 260, 118, min(4, CARD(1)), True),
    (2, 84_675, WIDEST, 118, 2, False),   # u out at the asked ring: asked
    (1, 2_048, 65_536, 62, 1, False),     # news_sparse: device u, asked
    (4, 2_048, 65_536, 62, 4, False),
    (1, 4_999, 1_355_191, 549, 1, False),
])
def test_ring_plan(asked, nk, d, r_max, depth, u_in_smem):
    plan = sk.ring_plan(asked, nk=nk, d=d, r_max=r_max)
    assert plan == {"depth": depth, "u_in_smem": u_in_smem}
    budget = sk.smem_budget(d=d, r_max=r_max, nk=nk, buffer_depth=depth)
    assert budget["fits"] and budget["u_in_smem"] == u_in_smem


def test_ring_plan_takes_the_deepest_ring_beside_u():
    """Between the asked ring and D_CARD, the deepest whose stages still
    leave u in shared memory: one stage (260 words) less of d, one stage
    more of ring."""
    for extra in range(sk.D_CARD):
        d = WIDEST - 260 * extra
        plan = sk.ring_plan(1, nk=10_000, d=d, r_max=118)
        assert plan == {"depth": extra + 1, "u_in_smem": True}, extra
        deeper = sk.smem_budget(d=d, r_max=118, buffer_depth=extra + 2)
        assert extra + 1 == sk.D_CARD or not deeper["u_in_smem"]


def test_d_card_is_within_the_built_rings():
    assert 1 <= sk.D_CARD <= sk.MAX_DEPTH


def _sorted_rows(rng, K, nk, d, r_max, col0=True):
    """Padded-ELL rows in CSR's form: each row's nonzero slots first, in
    strictly increasing column order, then padding (col 0, val 0); with
    `col0`, every third row has a real entry at column 0."""
    nnz = rng.integers(1, r_max + 1, size=(K, nk))
    cols = np.zeros((K, nk, r_max), np.int32)
    vals = np.zeros((K, nk, r_max), np.float32)
    for k in range(K):
        for i in range(nk):
            n = int(nnz[k, i])
            c = np.sort(rng.choice(np.arange(1, d), n, replace=False))
            if col0 and i % 3 == 0:
                c[0] = 0
            cols[k, i, :n] = c
            vals[k, i, :n] = rng.standard_normal(n) / np.sqrt(n)
    return cols, vals


def _scalars(rng, K, nk, d):
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    mask[:, -1] = 0.0
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    return y, alpha, mask, w, perm


@pytest.mark.parametrize("loss_name,kappa", [
    ("hinge", None), ("smooth_hinge", 0.2), ("squared", 0.2),
    ("absolute", None)])
def test_plain_walk_on_sorted_rows_matches_reference(loss_name, kappa):
    """What the card's store scatter walks (rows CSR builds, a real entry
    at column 0 beside padding) through the CPU's plain version, against
    the reference's pipelined kernel at depth 4 in interpret mode."""
    rng = np.random.default_rng(41)
    K, nk, d, r = 2, 24, 60, 7
    cols, vals = _sorted_rows(rng, K, nk, d, r)
    y, alpha, mask, w, perm = _scalars(rng, K, nk, d)
    das, dus = [], []
    for k in range(K):
        p = perm[k]
        da_p, du = ref_sparse(*(jnp.asarray(a[k][p])
                                for a in (cols, vals, y, alpha, mask)),
                              jnp.asarray(w), 0.4,
                              loss=ref_get_loss(loss_name), n_passes=2,
                              block_rows=8, buffer_depth=4, prox_kappa=kappa,
                              interpret=True)
        da = np.zeros(nk, np.float32)
        da[p] = np.asarray(da_p)
        das.append(da)
        dus.append(np.asarray(du))
    t = [torch.from_numpy(a) for a in (cols, vals, y, alpha, mask, w)]
    got = sk.sparse_local_sdca(*t, 0.4, torch.from_numpy(perm),
                               loss=get_loss(loss_name), n_passes=2,
                               prox_kappa=kappa, buffer_depth=4)
    assert sk.LAST_RING_DEPTH is None       # no ring on the CPU
    np.testing.assert_allclose(got[0].numpy(), np.stack(das), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.stack(dus), rtol=1e-5,
                               atol=1e-6)


def test_dispatch_records_no_ring_on_the_cpu():
    rng = np.random.default_rng(5)
    K, nk, d, r = 2, 12, 30, 4
    cols, vals = _sorted_rows(rng, K, nk, d, r)
    y, alpha, mask, w, perm = _scalars(rng, K, nk, d)
    indptr, idx, data = [0], [], []
    for k in range(K):
        for i in range(nk):
            live = vals[k, i] != 0
            idx.extend(cols[k, i][live])
            data.extend(vals[k, i][live])
            indptr.append(len(idx))
    csr = CSRMatrix(np.asarray(data, np.float32), np.asarray(idx, np.int32),
                    np.asarray(indptr, np.int64), (K * nk, d))
    sh, yp, mk = partition_sparse(csr, y.reshape(-1), K, device="cpu")
    ops.sparse_local_sdca_block(sh, yp, torch.zeros_like(yp), mk,
                                torch.from_numpy(w), torch.from_numpy(perm),
                                get_loss("hinge"), 1e-2, float(K * nk), 1.0,
                                nk, buffer_depth=2)
    cfg = ops.LAST_SPARSE_CONFIG
    assert cfg["buffer_depth"] == 2 and cfg["ring_depth"] is None


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_sparse_walk_split.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.fixture
def raw_rings(monkeypatch):
    """Every asked depth runs as asked (D_CARD read as 1)."""
    monkeypatch.setattr(sk, "D_CARD", 1)


def _repeat_some(rng, cols, vals, every=2):
    """`cols` where every `every`-th row repeats a nonzero slot's id in its
    last nonzero slot (rows of one nonzero slot keep theirs)."""
    cols = cols.copy()
    K, nk, r = cols.shape
    for k in range(K):
        for i in range(0, nk, every):
            n = int((vals[k, i] != 0).sum())
            if n > 1:
                cols[k, i, n - 1] = cols[k, i, rng.integers(0, n - 1)]
    return cols


# (K, nk, r_max): 16-byte bulk copies; 4-byte copies (K nk r_max % 4 != 0);
# rows past the 128 slots a walk lane holds in registers
SHAPES = [(4, 300, 40), (3, 101, 117), (4, 96, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,nk,r", SHAPES)
@pytest.mark.parametrize("n_passes", [1, 2])
def test_cuda_every_ring_equals_one_stage_bit_for_bit(card, raw_rings, K, nk,
                                                      r, n_passes):
    """Rows CSR builds (distinct ids, a real entry at column 0 beside the
    padding): rings 2-8 and rings clamped to nk give ring 1's bits, every
    loss, the prox on and off."""
    rng = np.random.default_rng(K * 1000 + r + n_passes)
    d = 5_000
    cols, vals = _sorted_rows(rng, K, nk, d, r)
    y, alpha, mask, w, perm = _scalars(rng, K, nk, d)
    t = [torch.from_numpy(a).to(card)
         for a in (cols, vals, y, alpha, mask, w)]
    p = torch.from_numpy(perm).to(card)
    for loss_name in CLOSED_FORM:
        for kappa in (None, 0.2):
            kw = dict(loss=get_loss(loss_name), n_passes=n_passes,
                      prox_kappa=kappa)
            one = sk.sparse_local_sdca(*t, 0.3, p, buffer_depth=1, **kw)
            assert sk.LAST_RING_DEPTH == 1
            for depth in (2, 3, 4, 8):
                got = sk.sparse_local_sdca(*t, 0.3, p, buffer_depth=depth,
                                           **kw)
                assert sk.LAST_RING_DEPTH == min(depth, nk)
                torch.cuda.synchronize()
                assert torch.equal(got[0], one[0]), (loss_name, kappa, depth)
                assert torch.equal(got[1], one[1]), (loss_name, kappa, depth)


@pytest.mark.cuda
@pytest.mark.parametrize("K,nk,r", SHAPES)
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_cuda_rows_with_and_without_repeats_match_plain(card, raw_rings, K,
                                                        nk, r, depth):
    """Half the rows repeat an id (the compare-and-swap scatter), half do
    not (the store scatter), in one launch: against the plain version
    (rtol 1e-4, atol 1e-5: warp sums and the compare-and-swaps reorder the
    float32 sums), every loss, the prox on and off, two passes."""
    rng = np.random.default_rng(100 + depth + r)
    d = 3_000
    cols, vals = _sorted_rows(rng, K, nk, d, r)
    cols = _repeat_some(rng, cols, vals)
    y, alpha, mask, w, perm = _scalars(rng, K, nk, d)
    t = [torch.from_numpy(a).to(card)
         for a in (cols, vals, y, alpha, mask, w, perm)]
    for loss_name in CLOSED_FORM:
        for kappa in (None, 0.1):
            kw = dict(loss=get_loss(loss_name), n_passes=2, prox_kappa=kappa)
            got = sk.sparse_local_sdca(*t[:6], 0.3, t[6], buffer_depth=depth,
                                       **kw)
            want = sk.sparse_local_sdca_plain(*t[:6], 0.3, t[6], **kw)
            torch.cuda.synchronize()
            for g, w_ in zip(got, want):
                torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("asked", [1, 2, 4, 8])
def test_cuda_the_card_runs_the_planned_ring(card, asked):
    """Asked depth 1 counts as the depth-1 kernel and >= 2 as the
    pipelined one, whatever ring ran; the ring is `ring_plan`'s, and every
    asked depth gives the same bits."""
    rng = np.random.default_rng(7)
    K, nk, d, r = 4, 200, 4_000, 30
    cols, vals = _sorted_rows(rng, K, nk, d, r)
    y, alpha, mask, w, perm = _scalars(rng, K, nk, d)
    t = [torch.from_numpy(a).to(card)
         for a in (cols, vals, y, alpha, mask, w, perm)]
    kw = dict(loss=get_loss("smooth_hinge"), n_passes=2)
    want = sk.sparse_local_sdca(*t[:6], 0.3, t[6], buffer_depth=8, **kw)
    before = (sk.LAUNCHES, sk.PIPELINED_LAUNCHES)
    got = sk.sparse_local_sdca(*t[:6], 0.3, t[6], buffer_depth=asked, **kw)
    assert (sk.LAUNCHES, sk.PIPELINED_LAUNCHES) == (
        before[0] + (asked == 1), before[1] + (asked > 1))
    assert sk.LAST_RING_DEPTH == sk.ring_plan(asked, nk=nk, d=d,
                                              r_max=r)["depth"]
    assert sk.LAST_RING_DEPTH == max(asked, sk.D_CARD)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
