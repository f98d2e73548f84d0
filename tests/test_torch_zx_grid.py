"""The z-exchange round past one cluster as one cooperative launch (the
grid form), and the 1-D walk with u in device memory at a slot count that
holds a lane's row.

`zx_launch_plan` takes the grid form on one card where the cluster form is
not taken (M > 16, or a cluster the card cannot hold) and the card holds
all K M blocks at once (`resident`, the wrapper's occupancy query; past
that, a block walks several workers in lockstep, tests/
test_torch_zx_turns.py), the per-block form where not even M blocks fit
and on every process mesh, and the cluster form at M <= 16 as before;
`ops.round_libraries` names the library each form launches. The device-u walk gathers a lane's slots into registers
at once (`device_u_walk(r_max)`: 4 slots a lane on one walk warp up to
128 slots a row, 8 or 16 on two walk warps past that, rows past 1,024
slots in batches). These run on the CPU as shape arithmetic; the grid
form's plain version is the zx round's (`sparse_local_sdca_zx_plain`,
held to the reference in tests/test_torch_kernel_reach.py).

The `cuda` tests hold the grid form to the plain version at M 17 and 32,
to the per-block kernel, and (forced) to the cluster kernel at M 2 and 4;
and the device-u walk to its plain version at r_max 250, 549 and past
1,024. Run them on the card with `python -m pytest -q -m cuda
tests/test_torch_zx_grid.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_sdca as sk

import torch_parity as tp

H100_SMS = 132
RCV1_4X32 = dict(K=4, M=32, nk=169_350, d_loc=1_477, B=16, r_loc=15)


def _plan(c, **kw):
    return sk.zx_launch_plan(c["K"], c["M"], c["nk"], c["d_loc"], c["B"],
                             r_loc=c["r_loc"], **kw)


# ----------------------------------------------------------------------------
# the launch plan and the libraries (CPU)
# ----------------------------------------------------------------------------

def test_grid_at_rcv1_4x32_with_132_resident_blocks():
    """128 blocks of the 132 the card holds at one an SM: one cooperative
    launch a round, u (5.9 KB) in shared memory beside the ring."""
    plan = _plan(RCV1_4X32, resident=H100_SMS)
    budget = sk.smem_budget(d=1_477, r_max=15, block_rows=16, zx=True)
    assert plan == dict(form="grid", launches=1, cluster=1, steps=10_585,
                        u_in_smem=True, smem_bytes=budget["total_bytes"],
                        fits=True, workers_per_block=1, groups=4)
    assert budget["u_bytes"] == 5_908


@pytest.mark.parametrize("resident", [0, 31])
def test_block_form_where_the_grid_cannot_be_resident(resident):
    """Fewer resident blocks than M = 32: not even one worker a group of
    M blocks fits, whatever the workers a block."""
    plan = _plan(RCV1_4X32, resident=resident)
    assert plan == dict(form="block", launches=10_585, cluster=1,
                        steps=10_585, u_in_smem=False, smem_bytes=8 * 16,
                        fits=True)


def test_block_form_on_a_process_mesh():
    """A process mesh's rank plans with no cluster and no resident grid
    (`_zx_rank_round`'s call): the per-block kernel, whatever the card."""
    plan = sk.zx_launch_plan(1, 1, 10_240, 4_096, 16, r_loc=30,
                             cluster=False)
    assert plan["form"] == "block"
    assert ops.round_libraries("sdca_sparse_kernel", 2, processes=True) == (
        "sparse_sdca_zx_block",)


@pytest.mark.parametrize("M", [1, 2, 8, 16])
def test_cluster_form_at_m_up_to_16_whatever_is_resident(M):
    plan = sk.zx_launch_plan(4, M, 1_000, 600, 16, r_loc=24,
                             resident=H100_SMS)
    assert (plan["form"], plan["launches"], plan["cluster"]) == (
        "cluster", 1, M)


@pytest.mark.parametrize("M", [2, 4, 16])
def test_grid_where_the_cluster_is_refused(M):
    """A cluster the card cannot hold (the wrapper's query read 0) takes
    the grid form where K M blocks are resident, else the per-block one
    where not even M blocks are."""
    grid = sk.zx_launch_plan(4, M, 1_000, 600, 16, r_loc=24, cluster=False,
                             resident=4 * M)
    assert grid["form"] == "grid" and grid["launches"] == 1
    assert grid["workers_per_block"] == 1
    block = sk.zx_launch_plan(4, M, 1_000, 600, 16, r_loc=24, cluster=False,
                              resident=M - 1)
    assert block["form"] == "block" and block["launches"] == block["steps"]


def test_grid_needs_the_ring_to_fit():
    """Rows whose two stages do not fit a block: no cluster, no grid."""
    plan = sk.zx_launch_plan(2, 32, 1_000, 600, 128, r_loc=120,
                             resident=10_000)
    assert plan["form"] == "block"


# the library each form launches: the grid form is the cluster kernel's
# GRID instance, in the same source
FORM_LIBRARY = {"cluster": "sparse_sdca_zx", "grid": "sparse_sdca_zx",
                "block": "sparse_sdca_zx_block"}


@pytest.mark.parametrize("M,workers,resident,form", [
    (2, 4, None, "cluster"), (16, 4, 64, "cluster"), (17, 3, 132, "grid"),
    (32, 4, 132, "grid"), (32, 4, 31, "block"), (64, 4, 63, "block")])
def test_round_libraries_agree_with_the_plan(M, workers, resident, form):
    plan = sk.zx_launch_plan(workers, M, 1_000, 600, 16, r_loc=24,
                             resident=resident or 0)
    assert plan["form"] == form
    assert FORM_LIBRARY[form] in ops.round_libraries("sdca_sparse_kernel",
                                                     M)


def test_round_libraries_before_the_query_names_both():
    """Past a cluster on one card the round takes the grid form (in the
    cluster kernel's library) or the per-block kernel, as the card's
    occupancy query decides at the launch: both are named."""
    assert ops.round_libraries("sdca_sparse_kernel", 32) == (
        "sparse_sdca_zx", "sparse_sdca_zx_block")
    assert ops.round_libraries("sdca_sparse_kernel", 1) == (
        "sparse_sdca_pipelined",)


@pytest.mark.parametrize("r_max,walk", [(62, (1, 4)), (128, (1, 4)),
                                        (129, (2, 8)), (256, (2, 8)),
                                        (257, (2, 8)), (512, (2, 8)),
                                        (513, (2, 16)), (549, (2, 16)),
                                        (1_024, (2, 16)), (1_100, (2, 16))])
def test_device_u_walk_holds_a_lanes_row(r_max, walk):
    """news_sparse's r_max 62 (2 slots a lane) keeps one warp and 4
    registers; rows of 129 to 512 slots take two walk warps of 8; news20's
    549 takes two of 16 (9 slots a lane); 1,100 (18 a lane) takes 16 and
    walks the rest in a second batch."""
    assert sk.device_u_walk(r_max) == walk
    assert walk in sk.DEVICE_U_WALKS


def test_cpu_zx_records_the_plain_form():
    """On the CPU the dispatch runs the plain version at any M and says
    so in LAST_SPARSE_CONFIG; no launch count moves."""
    rng = np.random.default_rng(3)
    K, M, nk, d_loc, r = 1, 17, 12, 5, 3
    cols, vals, _ = tp.ell_block(rng, K * M, nk, d_loc, r)
    shard = type("F", (), dict(
        cols=torch.from_numpy(cols.reshape(K, M, nk, r)),
        vals=torch.from_numpy(vals.reshape(K, M, nk, r))))
    before = (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES, sk.ZX_BLOCK_LAUNCHES)
    res = ops.sparse_local_sdca_block(
        shard, torch.ones(K, nk), torch.zeros(K, nk), torch.ones(K, nk),
        torch.zeros(M * d_loc), torch.arange(nk)[None], get_loss("hinge"),
        1e-2, float(nk), 1.0, nk, model_axis="model")
    assert ops.LAST_SPARSE_CONFIG["form"] == "plain"
    assert ops.LAST_SPARSE_CONFIG["zx"] and res.du.shape == (K, M * d_loc)
    assert (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES,
            sk.ZX_BLOCK_LAUNCHES) == before


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_zx_grid.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


def _zx_case(card, M, seed, K=3, nk=203, d_loc=600, r=24):
    """tests/test_torch_mesh2d.py's zx inputs: rows with duplicate ids and
    ragged lengths, two masked rows, the global sqnorms, a visit perm."""
    rng = np.random.default_rng(seed)
    cols, vals, _ = tp.ell_block(rng, K * M, nk, d_loc, r)
    cols = cols.reshape(K, M, nk, r)
    vals = (vals.reshape(K, M, nk, r) / np.sqrt(M)).astype(np.float32)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    mask[:, -2:] = 0.0
    alpha[:, -2:] = 0.0
    w = (0.3 * rng.standard_normal(M * d_loc)).astype(np.float32)
    sq = np.sum(vals * vals, axis=(1, 3)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    return [torch.from_numpy(a).to(card)
            for a in (cols, vals, y, alpha, mask, w, sq, perm)]


def _counts():
    return (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES, sk.ZX_BLOCK_LAUNCHES,
            sk.ZX_STEPS)


def _zx(ins, **kw):
    return sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 32])
@pytest.mark.parametrize("B,kappa,n_passes", [(16, None, 2), (1, 0.3, 1),
                                              (128, 0.3, 3)])
def test_cuda_zx_grid_matches_plain(card, M, B, kappa, n_passes):
    """The grid form (K 3 x M blocks, resident on the card) against the
    plain version, test_cuda_zx_block_matches_plain's cases (rtol 1e-4,
    atol 1e-5: atomics reorder the float32 sums), one launch a round."""
    ins = _zx_case(card, M, M + B)
    for loss_name in ("hinge", "squared"):
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes, block_rows=B,
                  prox_kappa=kappa)
        before = _counts()
        got = _zx(ins, **kw)
        steps = n_passes * -(-203 // B)
        assert sk.LAST_ZX_FORM == "grid"
        assert _counts() == (before[0], before[1] + 1, before[2],
                             before[3] + steps)
        want = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 32])
def test_cuda_zx_grid_matches_block(card, M, monkeypatch):
    """The grid form against the per-block kernel (the occupancy query
    read as 0) on the same inputs, two passes, B 16 with a ragged last
    block."""
    ins = _zx_case(card, M, 60 + M)
    kw = dict(loss=get_loss("smooth_hinge"), n_passes=2, block_rows=16,
              prox_kappa=0.2)
    grid = _zx(ins, **kw)
    assert sk.LAST_ZX_FORM == "grid"
    monkeypatch.setattr(sk, "_zx_grid_resident", lambda *a: 0)
    before = _counts()
    block = _zx(ins, **kw)
    steps = 2 * -(-203 // 16)
    assert _counts() == (before[0], before[1], before[2] + steps,
                         before[3] + steps)
    torch.cuda.synchronize()
    for g, p in zip(grid, block):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 4])
def test_cuda_zx_grid_forced_matches_cluster(card, M, monkeypatch):
    """At M 2 and 4 the plan takes the cluster form; with the cluster fit
    read as 0 it takes the grid form, held to the cluster kernel."""
    ins = _zx_case(card, M, 80 + M)
    kw = dict(loss=get_loss("hinge"), n_passes=2, block_rows=16,
              prox_kappa=0.2)
    fused = _zx(ins, **kw)
    assert sk.LAST_ZX_FORM == "cluster"
    monkeypatch.setattr(sk, "_zx_clusters_fit", lambda *a: 0)
    before = _counts()
    grid = _zx(ins, **kw)
    assert sk.LAST_ZX_FORM == "grid"
    assert _counts()[:3] == (before[0], before[1] + 1, before[2])
    torch.cuda.synchronize()
    for g, p in zip(grid, fused):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_zx_grid_with_u_in_device_memory(card, monkeypatch):
    """d_loc 65,536 does not fit shared memory beside the ring: the grid
    form's instance with u in device memory, against the plain version."""
    ins = _zx_case(card, 2, 7, K=2, d_loc=65_536)
    monkeypatch.setattr(sk, "_zx_clusters_fit", lambda *a: 0)
    kw = dict(loss=get_loss("squared"), n_passes=2, block_rows=16)
    got = _zx(ins, **kw)
    assert sk.LAST_ZX_FORM == "grid"
    want = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_zx_grid_refused_launch_raises(card, monkeypatch):
    """A grid the card cannot hold is refused by the cooperative launch
    and raises; no other form stands in (the occupancy read inflated)."""
    ins = _zx_case(card, 32, 5, K=40, nk=20, d_loc=50, r=4)
    monkeypatch.setattr(sk, "_zx_grid_resident", lambda *a: 1 << 20)
    monkeypatch.setattr(sk, "_zx_clusters_fit", lambda *a: 0)
    before = _counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        _zx(ins, loss=get_loss("hinge"), block_rows=8)
    assert _counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("r_max", [250, 549, 1_100])
@pytest.mark.parametrize("depth", [1, 4])
def test_cuda_device_u_walk_wide_rows_matches_plain(card, r_max, depth):
    """Rows of 250 slots (two walk warps of 8), 549 (news20's: two walk
    warps of 16, 9 slots a lane) and 1,100 (two batches of 16) with u in
    device memory, against the plain version
    (test_cuda_device_u_walk_matches_plain's tolerance: rtol 1e-4, atol
    1e-5), rows with duplicate ids and column 0 next to padding."""
    rng = np.random.default_rng(r_max + depth)
    K, nk, d = 2, 60, 200_000
    cols, vals, _ = tp.ell_block(rng, K, nk, d, r_max)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    t = [torch.from_numpy(a).to(card)
         for a in (cols, vals, y, alpha, np.ones((K, nk), np.float32), w,
                   perm)]
    assert not sk.smem_budget(d=d, r_max=r_max, nk=nk,
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
