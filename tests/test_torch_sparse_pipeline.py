"""The prefetching sparse walk (buffer_depth >= 2) and its dispatch.

The port's `sparse_local_sdca` at depth >= 2 is held against the
reference's pipelined Pallas kernel in interpret mode on the same inputs
(tolerance rtol 1e-5, atol 1e-6: the r_max gather-dot is a float32 sum in
another order than XLA's); `resolve_sparse_config` against the reference's
on the same cache entries; the dispatch's `buffer_depth` against depth 1;
`smem_budget` against the 232,448-byte limit.

The `cuda` tests hold the kernel at depth >= 2 to the same kernel at
depth 1 bit for bit on rows without duplicate column ids, and to the plain
version on rows with them; run them on the card with
`python -m pytest -q -m cuda tests/test_torch_sparse_pipeline.py`.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.losses import get_loss as ref_get_loss
from repro.kernels import autotune as ref_autotune
from repro.kernels.sparse_sdca import sparse_local_sdca as ref_sparse
from repro_torch.core import CoCoAConfig, solve
from repro_torch.core.losses import get_loss
from repro_torch.data import load, partition_sparse
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import sparse_sdca as sk

import torch_parity as tp

CLOSED_FORM = ["hinge", "smooth_hinge", "squared", "absolute"]


def _case(rng, K, nk, d, r_max):
    cols, vals, _ = tp.ell_block(rng, K, nk, d, r_max)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    return cols, vals, y, alpha, mask, w, perm


@pytest.mark.parametrize("loss_name,kappa,depth,n_passes", [
    ("hinge", None, 2, 1), ("smooth_hinge", 0.3, 4, 2),
    ("squared", None, 3, 2), ("absolute", 0.3, 2, 1)])
def test_depth_matches_reference_pipelined_kernel(loss_name, kappa, depth,
                                                  n_passes):
    rng = np.random.default_rng(3)
    K, nk, d, r = 2, 24, 40, 6
    cols, vals, y, alpha, mask, w, perm = _case(rng, K, nk, d, r)
    das, dus = [], []
    for k in range(K):
        p = perm[k]
        da_p, du = ref_sparse(*(jnp.asarray(a[k][p])
                                for a in (cols, vals, y, alpha, mask)),
                              jnp.asarray(w), 0.4,
                              loss=ref_get_loss(loss_name),
                              n_passes=n_passes, block_rows=8,
                              buffer_depth=depth, prox_kappa=kappa,
                              interpret=True)
        da = np.zeros(nk, np.float32)
        da[p] = np.asarray(da_p)
        das.append(da)
        dus.append(np.asarray(du))
    t = [torch.from_numpy(a) for a in (cols, vals, y, alpha, mask, w)]
    got = sk.sparse_local_sdca(*t, 0.4, torch.from_numpy(perm),
                               loss=get_loss(loss_name), n_passes=n_passes,
                               prox_kappa=kappa, buffer_depth=depth)
    np.testing.assert_allclose(got[0].numpy(), np.stack(das), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.stack(dus), rtol=1e-5,
                               atol=1e-6)


def test_buffer_depth_range_is_checked():
    rng = np.random.default_rng(0)
    t = [torch.from_numpy(a) for a in _case(rng, 1, 4, 8, 2)]
    for bad in (0, sk.MAX_DEPTH + 1):
        with pytest.raises(ValueError, match="buffer_depth"):
            sk.sparse_local_sdca(*t[:6], 0.5, t[6], loss=get_loss("hinge"),
                                 buffer_depth=bad)


# ----------------------------------------------------------------------------
# resolve_sparse_config against the reference's, on the same cache entries
# ----------------------------------------------------------------------------

ENTRIES = [  # (backend, d, r_max, density, reg, model_shards, config)
    ("cpu", 512, 44, 0.05, "l2", 1, {"block_rows": 64, "buffer_depth": 2,
                                     "slot_unroll": 4}),
    ("cpu", 512, 44, 0.02, "l2", 1, {"block_rows": 32, "buffer_depth": 4,
                                     "slot_unroll": 1}),
    ("cpu", 512, 44, 0.05, "elastic", 1, {"block_rows": 128,
                                          "buffer_depth": 3,
                                          "slot_unroll": 2}),
    ("cpu", 256, 30, 0.05, "l2", 2, {"block_rows": 8, "buffer_depth": 1,
                                     "slot_unroll": 1}),
    ("cuda", 47_236, 118, 0.0016, "l2", 1, {"block_rows": 128,
                                            "buffer_depth": 4,
                                            "slot_unroll": 1}),
]

QUERIES = [  # resolve_sparse_config kwargs
    dict(d=512, r_max=44, block_rows=None, backend="cpu"),         # cache
    dict(d=512, r_max=44, block_rows=16, backend="cpu"),   # explicit+cache
    dict(d=512, r_max=44, block_rows=None, buffer_depth=3,
         backend="cpu"),                                   # explicit+cache
    dict(d=512, r_max=45, block_rows=None, backend="cpu"),       # default
    dict(d=512, r_max=44, block_rows=None, backend="cpu",
         reg_family="elastic"),
    dict(d=512, r_max=44, block_rows=None, backend="cpu",
         reg_family="l1s"),                                      # default
    dict(d=256, r_max=30, block_rows=None, backend="cpu",
         model_shards=2),                                       # zx cache
    dict(d=256, r_max=31, block_rows=None, backend="cpu",
         model_shards=2),                                # zx default, 16
    dict(d=256, r_max=31, block_rows=None, buffer_depth=2, backend="cpu",
         model_shards=4),                               # explicit+default
    dict(d=47_236, r_max=118, block_rows=None,
         backend="cuda"),                                  # the card's key
    dict(d=47_236, r_max=118, block_rows=None,
         backend="cpu"),                                   # not the card's
]


@pytest.fixture
def shared_cache(tmp_path, monkeypatch):
    """One cache file in the reference's format (with its `slot_unroll`),
    written by the reference, named to both packages."""
    path = tmp_path / "autotune_cache.json"
    cache = ref_autotune.AutotuneCache(path)
    for backend, d, r_max, dens, reg, ms, cfg in ENTRIES:
        cache.record("sparse_sdca", backend, d=d, r_max=r_max, density=dens,
                     config=cfg, wall_s=1.0, reg=reg, model_shards=ms)
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    autotune.reset_cache()
    ref_autotune.reset_cache()
    yield path
    autotune.reset_cache()
    ref_autotune.reset_cache()


@pytest.mark.parametrize("query", QUERIES, ids=range(len(QUERIES)))
def test_resolve_matches_reference(shared_cache, query):
    """The same knobs from the same sources as the reference's resolver,
    whose TPU-only `slot_unroll` the port has no counterpart of (left
    unset there, and dropped from its answer)."""
    want = ref_autotune.resolve_sparse_config(**query, slot_unroll=None)
    del want["slot_unroll"]
    assert autotune.resolve_sparse_config(**query) == want


def test_resolve_sources_and_zx_default(shared_cache):
    got = autotune.resolve_sparse_config(d=512, r_max=44, block_rows=None,
                                         backend="cpu")
    assert got["source"] == "cache" and got["buffer_depth"] == 2
    got = autotune.resolve_sparse_config(d=9, r_max=2, block_rows=None,
                                         backend="cpu", model_shards=2)
    assert got["source"] == "default"
    assert got["block_rows"] == autotune.ZX_DEFAULT_BLOCK_ROWS == 16
    assert autotune.get_cache().path == shared_cache
    got = autotune.resolve_sparse_config(d=9, r_max=2, block_rows=8,
                                         buffer_depth=3, backend="cpu")
    assert got == {"block_rows": 8, "buffer_depth": 3, "source": "explicit"}


def test_cache_miss_depth_on_the_card_is_the_measured_best(shared_cache):
    """On a miss the card's ring is 4 deep (PERF.md); elsewhere, where no
    kernel runs, the reference's 1."""
    got = autotune.resolve_sparse_config(d=9, r_max=2, block_rows=None,
                                         backend="cuda")
    assert autotune.CUDA_DEFAULT_BUFFER_DEPTH == 4
    assert got == {"block_rows": 128, "buffer_depth": 4, "source": "default"}
    assert autotune.resolve_sparse_config(
        d=9, r_max=2, block_rows=None, backend="cpu")["buffer_depth"] == 1


def test_checked_in_cache_is_the_ports_own():
    assert autotune.cache_path().name == "autotune_cache.json"
    assert "repro_torch" in autotune.cache_path().parts


def test_dispatch_resolves_depth_from_the_cache(shared_cache, monkeypatch):
    """The solver's buffer_depth comes from the cache entry, and
    LAST_SPARSE_CONFIG records it; the results equal depth 1's."""
    csr, y = load("tiny_sparse")
    sh, yp, mk = partition_sparse(csr, y, 4, device="cpu")
    assert (sh.d, sh.r_max) == (512, 44)           # ENTRIES[0]'s key
    cfg = CoCoAConfig.adding(4, loss="hinge", lam=1e-3, H=256,
                             solver="sdca_sparse_kernel")
    r_cache = solve(cfg, sh, yp, mk, rounds=2, seed=3)
    assert ops.LAST_SPARSE_CONFIG["buffer_depth"] == 2
    assert ops.LAST_SPARSE_CONFIG["source"] == "cache"
    monkeypatch.setenv(autotune.ENV_VAR, str(shared_cache.parent / "no.json"))
    autotune.reset_cache()
    r_default = solve(cfg, sh, yp, mk, rounds=2, seed=3)
    assert ops.LAST_SPARSE_CONFIG["buffer_depth"] == 1
    assert ops.LAST_SPARSE_CONFIG["source"] == "default"
    assert torch.equal(r_cache.state.w, r_default.state.w)
    assert r_cache.history["gap"] == r_default.history["gap"]


def test_dispatch_clamps_the_ring_to_nk():
    rng = np.random.default_rng(2)
    cols, vals, y, alpha, mask, w, perm = _case(rng, 2, 3, 10, 3)
    shard = types.SimpleNamespace(cols=torch.from_numpy(cols),
                                  vals=torch.from_numpy(vals))
    ops.sparse_local_sdca_block(
        shard, *(torch.from_numpy(a) for a in (y, alpha, mask, w, perm)),
        get_loss("hinge"), 1e-2, 6.0, 2.0, 3, buffer_depth=8)
    assert ops.LAST_SPARSE_CONFIG["buffer_depth"] == 3
    assert ops.LAST_SPARSE_CONFIG["block_rows"] == 8       # max(8, nk)
    assert ops.LAST_SPARSE_CONFIG["clamped"] is True


@pytest.mark.parametrize("depth", [2, 4])
def test_buffer_depth_dispatch_equals_depth_one(depth):
    rng = np.random.default_rng(9)
    K, nk, d, r = 3, 30, 50, 5
    cols, vals, y, alpha, mask, w, perm = _case(rng, K, nk, d, r)
    shard = types.SimpleNamespace(cols=torch.from_numpy(cols),
                                  vals=torch.from_numpy(vals))
    args = (shard, *(torch.from_numpy(a) for a in (y, alpha, mask, w)),
            torch.from_numpy(perm), get_loss("smooth_hinge"), 1e-2, 90.0,
            3.0, 2 * nk)
    one = ops.sparse_local_sdca_block(*args, buffer_depth=1)
    deep = ops.sparse_local_sdca_block(*args, buffer_depth=depth)
    assert ops.LAST_SPARSE_CONFIG["buffer_depth"] == depth
    assert ops.LAST_SPARSE_CONFIG["source"] == "explicit+default"
    assert torch.equal(one.dalpha, deep.dalpha)
    assert torch.equal(one.du, deep.du)


def test_smem_budget_rejects_what_does_not_fit():
    ok = sk.smem_budget(d=47_236, r_max=118, buffer_depth=4)
    assert sk.stage_row_words(118) == 124        # 118 + 3, to 16 bytes
    assert ok["fits"] and ok["ring_bytes"] == 4 * (4 * (2 * 124 + 8) + 16)
    assert ok["u_bytes"] == 188_944 and ok["scratch_bytes"] == 0
    assert sk.smem_budget(d=47_236, r_max=118)["ring_bytes"] == 1_040
    assert sk.smem_budget(d=47_236, r_max=118, nk=3,
                          buffer_depth=4)["ring_bytes"] == 3 * 1_040
    # u and a one-row stage with its two mbarriers fill the limit to the
    # last word (no reduction scratch)
    widest = (232_448 - 1_040) // 4
    assert sk.smem_budget(d=widest, r_max=118)["fits"]
    assert not sk.smem_budget(d=widest + 1, r_max=118)["fits"]
    tight = sk.smem_budget(d=widest, r_max=118, buffer_depth=2)
    assert not tight["fits"]
    with pytest.raises(ValueError, match="232448 bytes"):
        sk._enforce_smem(tight, "sparse_local_sdca")
    with pytest.raises(ValueError, match="232448 bytes"):
        sk._enforce_smem(sk.smem_budget(d=65_536, r_max=64), "here")
    zx = sk.smem_budget(d=3_200_000, r_max=500, block_rows=16, zx=True)
    assert zx["fits"] and not zx["u_in_smem"]          # u in device memory
    assert zx["u_bytes"] == 0 and zx["scratch_bytes"] == 12 * 16
    assert zx["total_bytes"] == 12 * 16 + 4 * (4 * 16 + 2 * (2 * 16 * 500
                                                           + 5 * 16))
    assert not sk.smem_budget(d=1, r_max=1, block_rows=40_000,
                              zx=True)["fits"]


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_sparse_pipeline.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


def _unique_case(rng, K, nk, d, r_max):
    """Rows without duplicate column ids (the contract for bit equality)."""
    nnz = rng.integers(1, r_max + 1, size=(K, nk))
    cols = np.stack([[np.sort(rng.choice(d, r_max, replace=False))
                      for _ in range(nk)] for _ in range(K)]).astype(np.int32)
    live = np.arange(r_max)[None, None, :] < nnz[..., None]
    vals = np.where(live, rng.standard_normal((K, nk, r_max)), 0.0)
    vals = (vals / np.linalg.norm(vals, axis=-1, keepdims=True)
            ).astype(np.float32)
    cols = np.where(live, cols, 0).astype(np.int32)
    return cols, vals


def _straddle(cols, vals, slot=128):
    """`cols` with ids repeated across `slot`, the first slot a walk lane
    reads from the stage and not from its registers, in every row live at
    slot + 2: slot -> slot 0 (the same lane), slot + 1 -> slot - 1 and
    slot + 2 -> slot / 2 (other lanes)."""
    cols = cols.copy()
    live = vals[..., slot + 2] != 0
    for dst, src in ((slot, 0), (slot + 1, slot - 1), (slot + 2, slot // 2)):
        cols[..., dst] = np.where(live, cols[..., src], cols[..., dst])
    return cols


# the walk's other branches: 4-byte row copies (K * nk * r_max % 4 != 0)
# and rows wider than the 128 slots a lane keeps in registers
WALK_BRANCHES = [(3, 101, 117), (4, 96, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "depth,nk,n_passes,K,r",
    [(2, 300, 2, 4, 40), (3, 300, 1, 4, 40), (4, 300, 2, 4, 40),
     (8, 97, 2, 4, 40), (4, 3, 2, 4, 40), (4, 1, 3, 4, 40)]
    + [(depth, nk, 2, K, r) for K, nk, r in WALK_BRANCHES
       for depth in (2, 4, 8)])
def test_cuda_pipelined_equals_depth_one_bit_for_bit(card, depth, nk,
                                                     n_passes, K, r):
    rng = np.random.default_rng(depth * 1000 + nk)
    d = 5_000
    cols, vals = _unique_case(rng, K, nk, d, r)
    _, _, y, alpha, mask, w, perm = _case(rng, K, nk, d, 2)
    t = [torch.from_numpy(a).to(card)
         for a in (cols, vals, y, alpha, mask, w)]
    p = torch.from_numpy(perm).to(card)
    for loss_name in CLOSED_FORM:
        for kappa in (None, 0.2):
            kw = dict(loss=get_loss(loss_name), n_passes=n_passes,
                      prox_kappa=kappa)
            # a ring clamped to nk = 1 is the depth-1 walk, and counts so
            before = (sk.LAUNCHES, sk.PIPELINED_LAUNCHES)
            deep = sk.sparse_local_sdca(*t, 0.3, p, buffer_depth=depth, **kw)
            ran = min(depth, nk)
            assert (sk.LAUNCHES, sk.PIPELINED_LAUNCHES) == (
                before[0] + (ran == 1), before[1] + (ran > 1))
            one = sk.sparse_local_sdca(*t, 0.3, p, **kw)
            torch.cuda.synchronize()
            assert torch.equal(deep[0], one[0]), (loss_name, kappa)
            assert torch.equal(deep[1], one[1]), (loss_name, kappa)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "depth,K,nk,r",
    [(2, 4, 256, 48), (4, 4, 256, 48)]
    + [(depth, K, nk, r) for K, nk, r in WALK_BRANCHES
       for depth in (1, 2, 4, 8)])
def test_cuda_pipelined_matches_plain_with_duplicates(card, depth, K, nk, r):
    """Rows with duplicate ids and column 0 next to padding, and at r =
    200 ids repeated across slot 128 (tolerance rtol 1e-4, atol 1e-5:
    warp reductions and shared-memory atomics reorder the float32 sums)."""
    rng = np.random.default_rng(21)
    case = list(_case(rng, K, nk, 3_000, r))
    if r > 130:
        case[0] = _straddle(case[0], case[1])
    t = [torch.from_numpy(a).to(card) for a in case]
    for loss_name in CLOSED_FORM:
        kw = dict(loss=get_loss(loss_name), n_passes=2, prox_kappa=0.1)
        got = sk.sparse_local_sdca(*t[:6], 0.3, t[6], buffer_depth=depth,
                                   **kw)
        want = sk.sparse_local_sdca_plain(*t[:6], 0.3, t[6], **kw)
        torch.cuda.synchronize()
        for g, r_ in zip(got, want):
            torch.testing.assert_close(g, r_, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_passes,kappa", [(1, None), (2, 0.2), (3, None)])
def test_cuda_zx_block1_single_shard_equals_depth_one(card, n_passes, kappa):
    """The one-launch zx kernel at B = 1, M = 1 is the sequential walk:
    against the 1-D kernel at depth 1 on the card, rows with duplicate
    ids (rtol 1e-4, atol 1e-5: the gather is a warp sum in the zx kernel
    and a block sum in the 1-D one, and the shared-memory atomics land in
    no fixed order)."""
    rng = np.random.default_rng(31 + n_passes)
    K, nk, d = 3, 300, 2_000
    cols, vals, y, alpha, mask, w, perm = (
        torch.from_numpy(a).to(card) for a in _case(rng, K, nk, d, 40))
    sq = torch.sum(vals * vals, dim=-1)
    for loss_name in CLOSED_FORM:
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes,
                  prox_kappa=kappa)
        before = (sk.ZX_LAUNCHES, sk.ZX_STEPS)
        zx = sk.sparse_local_sdca_zx(cols[:, None], vals[:, None], y, alpha,
                                     mask, w, 0.3, sq, perm, block_rows=1,
                                     **kw)
        assert (sk.ZX_LAUNCHES, sk.ZX_STEPS) == (before[0] + 1,
                                                 before[1] + n_passes * nk)
        one = sk.sparse_local_sdca(cols, vals, y, alpha, mask, w, 0.3, perm,
                                   **kw)
        torch.cuda.synchronize()
        for g, r_ in zip(zx, one):
            torch.testing.assert_close(g, r_, rtol=1e-4, atol=1e-5)
