"""The SDCA kernels' reach: every width and mesh the reference's take.

The 1-D sparse walk holds u in shared memory where it fits beside its
ring and in device memory past that (`smem_budget`), so the widths of
news_sparse (65,536) and news20.binary (1,355,191) plan a launch, and
only a ring that does not fit is refused; its plain version at d = 65,536
is held to the reference's `sparse_local_sdca` in interpret mode (rtol
1e-5, atol 1e-6, tests/test_torch_sparse_pipeline.py's tolerance).

The z-exchange round beyond one cluster runs as one cooperative launch
where the card holds its K M blocks (`zx_launch_plan`'s "grid" form,
tests/test_torch_zx_grid.py), else, and across processes, one launch per
invocation (the "block" form). Its plain
version is that form's host loop (`zx_block_loop`) over the plain
per-block step: held at M = 17 and 32 to the reference's zx round
(tests/test_torch_mesh2d.py's inputs and tolerance, which also holds it
at M = 2); `sdca_sparse_kernel` on a 2 x 2 process mesh of gloo CPU
ranks against the one-process 2 x 2 mesh, gap per round within 1e-6; a
rank's block priced (`obs.cost.round_stats`) as its own zx round.

The `cuda` tests hold the device-memory instance of the 1-D kernel and
the per-block kernel (the grid's occupancy query read as 0) to their
plain versions, and the per-block kernel to the cluster kernel; run them
on the card with
`python -m pytest -q -m cuda tests/test_torch_kernel_reach.py`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.losses import get_loss as ref_get_loss
from repro.kernels.sparse_sdca import sparse_local_sdca as ref_sparse
from repro_torch.core import CoCoAConfig, solve
from repro_torch.core.losses import get_loss
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_sdca as sk
from repro_torch.launch.mesh import make_test_mesh, spawn_ranks

import torch_parity as tp
from test_torch_mesh2d import _ref_zx, _zx_inputs

SMEM_LIMIT = 232_448
NEWS_SPARSE_D = 65_536          # data/synthetic.py's news_sparse
NEWS20_D = 1_355_191            # LIBSVM's news20.binary features


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ----------------------------------------------------------------------------
# the 1-D walk at any width
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("d,r_max", [(NEWS_SPARSE_D, 64), (NEWS20_D, 600)])
@pytest.mark.parametrize("depth", [1, 4])
def test_wide_d_plans_u_in_device_memory(d, r_max, depth):
    """At news_sparse's and news20's widths u does not fit shared memory:
    the budget keeps the ring there alone, and nothing is refused."""
    budget = sk.smem_budget(d=d, r_max=r_max, nk=2_048, buffer_depth=depth)
    ring = depth * (4 * (2 * sk.stage_row_words(r_max) + 8) + 16)
    assert budget == dict(u_bytes=0, ring_bytes=ring, scratch_bytes=0,
                          total_bytes=ring, fits=True, u_in_smem=False)
    sk._enforce_smem(budget, "sparse_local_sdca")
    assert ring <= SMEM_LIMIT < 4 * d


def test_ring_that_does_not_fit_still_raises():
    """Rows of 30,000 slots: one stage of cols and vals is 240,048 bytes,
    past the limit whatever the width."""
    for d in (10, NEWS_SPARSE_D):
        budget = sk.smem_budget(d=d, r_max=30_000, buffer_depth=1)
        assert not budget["fits"]
        with pytest.raises(ValueError, match="232448 bytes"):
            sk._enforce_smem(budget, "sparse_local_sdca")


def test_dispatch_at_news_width_runs_the_1d_walk():
    """`sdca_sparse_kernel`'s dispatch at d = 65,536 resolves the 1-D walk
    (no z-exchange, the ring at the CPU's depth) and returns a delta of
    the full width."""
    rng = np.random.default_rng(2)
    K, nk = 2, 40
    cols, vals, _ = tp.ell_block(rng, K, nk, NEWS_SPARSE_D, 8)
    shard = type("S", (), dict(cols=torch.from_numpy(cols),
                               vals=torch.from_numpy(vals)))
    y = torch.from_numpy(np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0)
                         .astype(np.float32))
    res = ops.sparse_local_sdca_block(
        shard, y, torch.zeros(K, nk), torch.ones(K, nk),
        torch.zeros(NEWS_SPARSE_D), torch.stack([torch.randperm(nk)
                                                 for _ in range(K)]),
        get_loss("hinge"), 1e-4, 2.0 * nk, 2.0, nk)
    assert ops.LAST_SPARSE_CONFIG["zx"] is False
    assert res.du.shape == (K, NEWS_SPARSE_D)
    assert torch.isfinite(res.du).all() and res.du.abs().sum() > 0


@pytest.mark.parametrize("r_max", [549, 1_100])
def test_plain_walk_at_wide_rows_matches_reference(r_max):
    """Rows of news20's r_max (549: two walk warps of 16 registers a lane,
    9 slots a lane) and of 1,100 (18 slots a lane: 16, then a second
    batch) at d = 65,536, duplicate ids and column 0 next to padding: the
    plain version the card's walk is held to, against the reference's
    kernel."""
    rng = np.random.default_rng(r_max)
    K, nk, d = 2, 12, NEWS_SPARSE_D
    cols, vals, _ = tp.ell_block(rng, K, nk, d, r_max)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    das, dus = [], []
    for k in range(K):
        p = perm[k]
        da_p, du = ref_sparse(*(jnp.asarray(a[k][p])
                                for a in (cols, vals, y, alpha, mask)),
                              jnp.asarray(w), 0.4,
                              loss=ref_get_loss("hinge"), n_passes=2,
                              block_rows=4, buffer_depth=1, prox_kappa=0.05,
                              interpret=True)
        da = np.zeros(nk, np.float32)
        da[p] = np.asarray(da_p)
        das.append(da)
        dus.append(np.asarray(du))
    t = [torch.from_numpy(a) for a in (cols, vals, y, alpha, mask, w)]
    got = sk.sparse_local_sdca(*t, 0.4, torch.from_numpy(perm),
                               loss=get_loss("hinge"), n_passes=2,
                               prox_kappa=0.05, buffer_depth=4)
    np.testing.assert_allclose(got[0].numpy(), np.stack(das), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.stack(dus), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kappa,depth,n_passes", [(None, 1, 1), (0.3, 4, 2),
                                                  (0.3, 1, 1)])
def test_plain_walk_at_news_width_matches_reference(kappa, depth, n_passes):
    """K = 2, nk = 64, r_max = 8 at d = 65,536, rows with duplicate column
    ids and column 0 next to padding, the fused prox on and off."""
    rng = np.random.default_rng(5)
    K, nk, d, r = 2, 64, NEWS_SPARSE_D, 8
    cols, vals, _ = tp.ell_block(rng, K, nk, d, r)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    das, dus = [], []
    for k in range(K):
        p = perm[k]
        da_p, du = ref_sparse(*(jnp.asarray(a[k][p])
                                for a in (cols, vals, y, alpha, mask)),
                              jnp.asarray(w), 0.4,
                              loss=ref_get_loss("smooth_hinge"),
                              n_passes=n_passes, block_rows=8,
                              buffer_depth=depth, prox_kappa=kappa,
                              interpret=True)
        da = np.zeros(nk, np.float32)
        da[p] = np.asarray(da_p)
        das.append(da)
        dus.append(np.asarray(du))
    t = [torch.from_numpy(a) for a in (cols, vals, y, alpha, mask, w)]
    got = sk.sparse_local_sdca(*t, 0.4, torch.from_numpy(perm),
                               loss=get_loss("smooth_hinge"),
                               n_passes=n_passes, prox_kappa=kappa,
                               buffer_depth=depth)
    np.testing.assert_allclose(got[0].numpy(), np.stack(das), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.stack(dus), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# the z-exchange round, one launch per invocation
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("M", [17, 32])
@pytest.mark.parametrize("B,kappa,n_passes,loss_name", [
    (4, None, 2, "hinge"), (5, 0.3, 3, "smooth_hinge"),
    (1, None, 1, "squared")])
def test_zx_plain_beyond_a_cluster_matches_reference(M, B, kappa, n_passes,
                                                     loss_name):
    """The plain zx round, the per-block host loop (`zx_block_loop`) over
    `zx_block_step_plain`, at M = 17 and 32 against the reference's zx
    round (its M shards through jax.vmap with the model axis named), within
    tests/test_torch_mesh2d.py's tolerance (rtol 1e-5, atol 1e-6). nk = 37:
    B = 4 and 5 leave the last block ragged."""
    rng = np.random.default_rng(M + B)
    ins = _zx_inputs(rng, 2, M, 37, 24, 6)
    want = _ref_zx(*ins, 0.4, loss_name, B, n_passes, kappa)
    cols, vals, y, alpha, mask, w, sq, perm = (torch.from_numpy(a)
                                               for a in ins)
    got = sk.sparse_local_sdca_zx_plain(
        cols, vals, y, alpha, mask, w, 0.4, sq, perm,
        loss=get_loss(loss_name), n_passes=n_passes, block_rows=B,
        prox_kappa=kappa)
    for g, r_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r_, rtol=1e-5, atol=1e-6)


def test_round_stats_prices_a_rank_block_as_its_zx_round():
    """On a process mesh (a rank's coordinates, no world needed to price)
    the rank's block costs the zx round of one worker and one shard: its
    nonzeros, its z vectors in and out, its vectors; the wire bytes a
    device are the one-card 2 x 2 mesh's."""
    from repro_torch import comm
    from repro_torch.core.cocoa import place_on_mesh
    from repro_torch.data import SparseShards, load, partition_sparse
    from repro_torch.launch.mesh import Mesh
    from repro_torch.obs import cost
    csr, y = load("tiny_sparse")
    fs, yp, mk = partition_sparse(csr, y, 2, M=2, device="cpu")
    nk = yp.shape[1]
    cfg = CoCoAConfig.adding(2, H=nk, solver="sdca_sparse_kernel",
                             backend="shard_map", model_axis="model")
    rank = Mesh(("data", "model"), (2, 2), torch.device("cpu"), rank=3)
    topo = comm.Topology.from_mesh(rank, "data", "model")
    assert topo.process and (topo.worker, topo.model_index) == (1, 1)
    X = SparseShards(fs.cols[1:2, 1].contiguous(), fs.vals[1:2, 1]
                     .contiguous(), fs.nnz[1:2, 1].contiguous(),
                     d=fs.d_local)
    got = cost.round_stats(cfg, X, mk[1:2], topo)
    plan = ops.sparse_zx_plan(nk, fs.d_local, nk, r_max=fs.r_loc,
                              model_shards=2, backend="cpu")
    want = cost.zx_round(int(X.nnz.sum()), 1, 1, nk, fs.d_local,
                         plan["block_rows"], plan["n_passes"])
    assert (got["flops"], got["hbm_bytes"]) == (want["flops"],
                                                want["hbm_bytes"])
    one = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    Xm, _, mm = place_on_mesh(cfg, one, fs, yp, mk)
    on_card = cost.round_stats(cfg, Xm, mm, comm.Topology.from_mesh(
        one, "data", "model"))
    assert got["collective_wire_bytes"] == on_card["collective_wire_bytes"]
    assert got["collective_wire_bytes"] > 0


# the process mesh: sdca_sparse_kernel with a fused prox (elastic net) and
# two passes a round on 2 x 2 gloo ranks
ZX_JOB = dict(shape=(2, 2), axes=("data", "model"), data="tiny_sparse", K=2,
              M=2, rounds=3, seed=1,
              cfg=dict(backend="shard_map", lam=1e-3, loss="hinge",
                       solver="sdca_sparse_kernel", H=1_024,
                       model_axis="model", reg="elastic:0.5"))


@pytest.fixture(scope="module")
def zx_ranks():
    return spawn_ranks(tp.solve_on_ranks, 4, ([ZX_JOB],), timeout=110)


def test_process_mesh_zx_matches_one_process(zx_ranks):
    ranks = [r[0] for r in zx_ranks]
    for r in ranks:
        assert "error" not in r, r.get("error")
        cfg = r["sparse_config"]
        assert cfg["zx"] and cfg["model_shards"] == 2 and cfg["prox_fused"]
        assert cfg["block_rows"] == 16          # the 2 x 2 mesh's default
        np.testing.assert_array_equal(r["gap"], ranks[0]["gap"])
    X, y, mask = tp.job_data(ZX_JOB)
    one = solve(CoCoAConfig(**ZX_JOB["cfg"]), X, y, mask,
                rounds=ZX_JOB["rounds"], seed=ZX_JOB["seed"],
                mesh=make_test_mesh((2, 2), ("data", "model"), device="cpu"))
    assert ops.LAST_SPARSE_CONFIG["zx"]
    np.testing.assert_allclose(ranks[0]["gap"], one.history["gap"],
                               rtol=1e-6)
    assert list(ranks[0]["comm_floats"]) == one.history["comm_floats"]
    assert ranks[0]["gap"][-1] < ranks[0]["gap"][0]


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_kernel_reach.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [NEWS_SPARSE_D, 200_000])
@pytest.mark.parametrize("depth", [1, 4])
def test_cuda_device_u_walk_matches_plain(card, d, depth):
    """The instance with u in device memory against the plain version,
    rows with duplicate ids and column 0 next to padding (rtol 1e-4, atol
    1e-5: warp reductions and atomics reorder the float32 sums)."""
    rng = np.random.default_rng(d + depth)
    K, nk, r = 3, 300, 40
    cols, vals, _ = tp.ell_block(rng, K, nk, d, r)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    t = [torch.from_numpy(a).to(card)
         for a in (cols, vals, y, alpha, np.ones((K, nk), np.float32), w,
                   perm)]
    assert not sk.smem_budget(d=d, r_max=r, nk=nk,
                              buffer_depth=depth)["u_in_smem"]
    for loss_name in ("hinge", "squared"):
        for kappa in (None, 0.1):
            kw = dict(loss=get_loss(loss_name), n_passes=2, prox_kappa=kappa)
            before = sk.DEVICE_U_LAUNCHES
            got = sk.sparse_local_sdca(*t[:6], 0.3, t[6], buffer_depth=depth,
                                       **kw)
            assert sk.DEVICE_U_LAUNCHES == before + 1
            want = sk.sparse_local_sdca_plain(*t[:6], 0.3, t[6], **kw)
            torch.cuda.synchronize()
            for g, p in zip(got, want):
                torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


def _zx_case(card, M, seed, K=3, nk=203, d_loc=600, r=24):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a).to(card)
            for a in _zx_inputs(rng, K, M, nk, d_loc, r)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 4])
def test_cuda_zx_block_matches_cluster(card, M, monkeypatch):
    """The per-block kernel (a cluster the card cannot hold and no
    resident grid, here made so) against the cluster kernel on the same
    inputs, two passes, B = 16 with a ragged last block (rtol 1e-4, atol
    1e-5)."""
    ins = _zx_case(card, M, 40 + M)
    kw = dict(loss=get_loss("smooth_hinge"), n_passes=2, block_rows=16,
              prox_kappa=0.2)
    fused = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)
    monkeypatch.setattr(sk, "_zx_clusters_fit", lambda *a: 0)
    monkeypatch.setattr(sk, "_zx_grid_resident", lambda *a: 0)
    before = (sk.ZX_LAUNCHES, sk.ZX_BLOCK_LAUNCHES, sk.ZX_STEPS)
    block = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)
    steps = 2 * -(-203 // 16)
    assert (sk.ZX_LAUNCHES, sk.ZX_BLOCK_LAUNCHES, sk.ZX_STEPS) == (
        before[0], before[1] + steps, before[2] + steps)
    torch.cuda.synchronize()
    for g, p in zip(block, fused):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 32])
@pytest.mark.parametrize("B,kappa,n_passes", [(16, None, 2), (1, 0.3, 1),
                                              (128, 0.3, 3)])
def test_cuda_zx_block_matches_plain(card, M, B, kappa, n_passes,
                                    monkeypatch):
    """The per-block kernel (the grid's occupancy query read as 0, so the
    plan takes it) against the plain version."""
    monkeypatch.setattr(sk, "_zx_grid_resident", lambda *a: 0)
    ins = _zx_case(card, M, M + B)
    for loss_name in ("hinge", "squared"):
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes, block_rows=B,
                  prox_kappa=kappa)
        before = sk.ZX_BLOCK_LAUNCHES
        got = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)
        assert sk.ZX_BLOCK_LAUNCHES == before + n_passes * -(-203 // B)
        want = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)
