"""The z-exchange round past what the card holds: one cooperative launch
whose blocks each walk several workers in lockstep (the grid form at
W > 1 workers a block).

`zx_launch_plan` takes the grid form with the smallest W of
`ZX_GRID_WORKERS` for which ceil(K / W) M blocks of W's instance are
resident and its W slabs fit shared memory; W = 1 wherever all K M blocks
are resident (one worker a block), the per-block form where no W fits (M
past the resident count, a ring that does not fit) and on every process
mesh. These run on the CPU as shape arithmetic, with one small plain run:
walking the workers in groups, as the lockstep blocks do, gives the round
of all K workers at once (workers are independent within a round).

The `cuda` tests hold the lockstep kernel at W 2, 3 and 4 (forced through
the occupancy query) to the plain round at M 17 and 32 with a ragged K,
the fused prox, 2 passes and u in device memory; to the W = 1 grid and the
per-block kernel; and count one launch a round through `solve`. Run them
on the card with `python -m pytest -q -m cuda tests/test_torch_zx_turns.py`.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_sdca as sk

import torch_parity as tp

# rcv1 (677,399 x 47,236) as 32 x 32 FeatureShards: phase 28's 4 x 32
# widths with eight times the workers; 528 blocks of W = 1 resident on the
# H100 (4 an SM), and the lockstep instances keep 4 an SM
RCV1_32X32 = dict(K=32, M=32, nk=21_169, d_loc=1_477, B=16, r_loc=15)
RESIDENT_H100 = 528


def _plan(c, **kw):
    return sk.zx_launch_plan(c["K"], c["M"], c["nk"], c["d_loc"], c["B"],
                             r_loc=c["r_loc"], **kw)


# ----------------------------------------------------------------------------
# the plan (CPU)
# ----------------------------------------------------------------------------

def test_lockstep_at_rcv1_32x32():
    """1,024 blocks against 528: W = 2, 16 groups of 32 blocks (512), one
    cooperative launch of 1,324 steps, two u slices in shared memory and
    8 warps' staging rows (4 rows of 33 floats each)."""
    plan = _plan(RCV1_32X32, resident=RESIDENT_H100)
    one = sk.smem_budget(d=1_477, r_max=15, block_rows=16, zx=True)
    assert plan == dict(form="grid", launches=1, cluster=1, steps=1_324,
                        u_in_smem=True,
                        smem_bytes=2 * one["total_bytes"] + 4_224,
                        fits=True, workers_per_block=2, groups=16)


@pytest.mark.parametrize("resident,W,groups", [(528, 1, 4), (128, 1, 4),
                                               (127, 2, 2), (64, 2, 2),
                                               (63, 4, 1), (32, 4, 1)])
def test_residency_read_lower_takes_more_workers_a_block(resident, W,
                                                          groups):
    """rcv1 at 4 x 32 (phase 28): residency read as 64 takes W = 2, as 32
    W = 4 (W = 3 needs the same 2 groups as W = 2); W = 1 wherever the
    128 blocks are resident."""
    plan = _plan(dict(RCV1_32X32, K=4, nk=169_350), resident=resident)
    assert (plan["form"], plan["workers_per_block"], plan["groups"],
            plan["launches"]) == ("grid", W, groups, 1)


@pytest.mark.parametrize("W,groups,last", [(2, 3, 1), (3, 2, 2),
                                           (4, 2, 2)])
def test_ragged_k(W, groups, last):
    """K = 5 with W not dividing it: ceil(5 / W) groups of M blocks; the
    last group's blocks walk fewer workers (block k' holds workers
    k' + j groups below K)."""
    M = 17
    resident = {w: (groups * M if w == W else 0) for w in sk.ZX_GRID_WORKERS}
    plan = sk.zx_launch_plan(5, M, 203, 600, 16, r_loc=24, resident=resident)
    assert (plan["form"], plan["workers_per_block"], plan["groups"]) == (
        "grid", W, groups)
    held = [[k for k in range(g, 5, groups)] for g in range(groups)]
    assert sorted(sum(held, [])) == list(range(5))
    assert max(map(len, held)) <= W and len(held[-1]) == last


@pytest.mark.parametrize("M", [17, 32, 64])
def test_block_where_m_exceeds_the_resident_count(M):
    """Fewer resident blocks than M at every W: no group of M blocks fits,
    the per-block kernel runs."""
    plan = sk.zx_launch_plan(4, M, 1_000, 600, 16, r_loc=24,
                             resident={w: M - 1 for w in sk.ZX_GRID_WORKERS})
    assert (plan["form"], plan["launches"]) == ("block", plan["steps"])
    assert "workers_per_block" not in plan


def test_block_on_a_process_mesh():
    """A process mesh's rank plans with no cluster and no residency
    (`_zx_rank_round`'s call): the per-block kernel."""
    plan = sk.zx_launch_plan(1, 1, 10_240, 4_096, 16, r_loc=30,
                             cluster=False)
    assert plan["form"] == "block"
    assert ops.round_libraries("sdca_sparse_kernel", 32, processes=True) == (
        "sparse_sdca_zx_block",)


@pytest.mark.parametrize("r_loc,form", [(441, "grid"), (460, "block")])
def test_block_where_the_rings_do_not_fit(r_loc, form):
    """B = 16 rows of 460 slots: one worker's two stages fit a block
    (118,848 bytes), two workers' and the staging rows do not, so past
    W = 1's residency no W runs; at 441 slots they fit (232,192 bytes) and
    W = 2 runs."""
    one = sk.smem_budget(d=0, r_max=r_loc, block_rows=16, zx=True)
    two = sk.smem_budget(d=0, r_max=r_loc, block_rows=16, zx=True, workers=2)
    assert one["fits"] and two["fits"] == (form == "grid")
    plan = sk.zx_launch_plan(4, 32, 1_000, 600, 16, r_loc=r_loc,
                             resident=64)
    assert plan["form"] == form


@pytest.mark.parametrize("K,M,resident", [(4, 32, 128), (4, 32, 132),
                                          (3, 17, 51), (1, 64, 64),
                                          (8, 17, 528), (2, 2, 4)])
def test_w1_wherever_k_m_blocks_are_resident(K, M, resident):
    plan = sk.zx_launch_plan(K, M, 1_000, 600, 16, r_loc=24, cluster=False,
                             resident=resident)
    assert (plan["form"], plan["workers_per_block"], plan["groups"]) == (
        "grid", 1, K)


def test_each_w_reads_its_own_residency():
    """A {W: blocks} reading: the smallest W whose own count holds its
    groups, not the smallest W whose groups fit some count."""
    plan = sk.zx_launch_plan(6, 32, 1_000, 600, 16, r_loc=24, resident={
        1: 191, 2: 95, 3: 64, 4: 1_000})
    assert (plan["workers_per_block"], plan["groups"]) == (3, 2)


@pytest.mark.parametrize("W,staging", [(1, 0), (2, 4_224), (3, 3_168),
                                       (4, 4_224)])
def test_u_placement_per_workers(W, staging):
    """W slabs a block: d_loc 20,000 keeps u in shared memory for up to
    two workers (2 x 87,232 bytes) and in device memory for three or four,
    where only the rings and scratch stay (W x 7,232 bytes); past one
    worker, 8 warps' staging rows of 33 floats, 2 a worker up to two
    workers and 1 past that."""
    b = sk.smem_budget(d=20_000, r_max=24, block_rows=16, zx=True,
                       workers=W)
    assert b["u_in_smem"] == (W <= 2) and b["fits"]
    assert b["total_bytes"] == W * (87_232 if W <= 2 else 7_232) + staging
    assert staging == (0 if W == 1 else
                       4 * 8 * W * sk.zx_poll_rows(W) * 33)
    plan = sk.zx_launch_plan(3, 17, 203, 20_000, 16, r_loc=24,
                             resident={W: 17 * -(-3 // W)})
    assert (plan["workers_per_block"], plan["u_in_smem"],
            plan["smem_bytes"]) == (W, b["u_in_smem"], b["total_bytes"])


def test_workers_match_the_cuda_source():
    """`ZX_GRID_WORKERS` are the instances `with_workers` dispatches to in
    csrc/sparse_sdca_zx.cu, every grid instance keeps 4 blocks an SM, and
    the staging rows' constants are the budget's."""
    from repro_torch.kernels import build
    src = (build.CSRC / "sparse_sdca_zx.cu").read_text()
    cases = re.findall(r"case (\d+): return f\(std::integral_constant<int, "
                       r"(\d+)>", src)
    assert all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == sk.ZX_GRID_WORKERS
    assert "constexpr int MIN_BLOCKS = 4;" in src
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in src
    assert re.search(r"constexpr int XS_STRIDE = (\d+);", src).group(1) == \
        str(sk.ZX_XS_STRIDE)
    assert "return W <= 2 ? ZROWS : 1;" in src            # zx_poll_rows
    assert re.search(r"constexpr int ZROWS = (\d+);", src).group(1) == "2"
    assert re.search(r"constexpr int NWARPS = THREADS / 32;", src) and \
        re.search(r"constexpr int THREADS = (\d+);", src).group(1) == \
        str(32 * sk.ZX_WARPS)


def _ins(rng, K, M, nk, d_loc, r):
    """tests/test_torch_zx_grid.py's zx inputs: rows with duplicate ids and
    ragged lengths, two masked rows, the global sqnorms, a visit perm."""
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
    return [torch.from_numpy(a) for a in (cols, vals, y, alpha, mask, w, sq,
                                          perm)]


@pytest.mark.parametrize("W", [2, 3, 4])
def test_workers_in_groups_give_the_round(W):
    """The lockstep design's premise, on the plain round: the workers
    k' + j ceil(K / W) of each group walked together, group by group, give
    the round of all K workers bit for bit (no worker reads another's
    state within a round)."""
    K, M, nk = 5, 3, 37
    ins = _ins(np.random.default_rng(W), K, M, nk, 20, 4)
    kw = dict(loss=get_loss("smooth_hinge"), n_passes=2, block_rows=8,
              prox_kappa=0.1)
    whole = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
    groups = -(-K // W)
    dalpha, du = torch.empty_like(whole[0]), torch.empty_like(whole[1])
    for g in range(groups):
        ks = torch.arange(g, K, groups)
        part = [t[ks] for t in ins[:5]] + [ins[5]] + [t[ks] for t in ins[6:]]
        da, d = sk.sparse_local_sdca_zx_plain(*part[:6], 0.5, *part[6:],
                                              **kw)
        dalpha[ks], du[ks] = da, d
    assert torch.equal(dalpha, whole[0]) and torch.equal(du, whole[1])


def test_cpu_records_no_workers_and_counts_nothing():
    """On the CPU the dispatch runs the plain version: form "plain", no
    workers a block, no launch count moves."""
    K, M, nk, d_loc = 2, 17, 12, 5
    ins = _ins(np.random.default_rng(4), K, M, nk, d_loc, 3)
    shard = type("F", (), dict(cols=ins[0], vals=ins[1]))
    before = (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES, sk.ZX_LOCKSTEP_LAUNCHES,
              sk.ZX_BLOCK_LAUNCHES)
    ops.sparse_local_sdca_block(
        shard, ins[2], torch.zeros(K, nk), ins[4], torch.zeros(M * d_loc),
        ins[7], get_loss("hinge"), 1e-2, float(K * nk), 1.0, nk,
        model_axis="model")
    cfg = ops.LAST_SPARSE_CONFIG
    assert (cfg["form"], cfg["workers_per_block"]) == ("plain", None)
    assert (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES, sk.ZX_LOCKSTEP_LAUNCHES,
            sk.ZX_BLOCK_LAUNCHES) == before


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_zx_turns.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


def _forced(monkeypatch, W):
    """The grid instance of W workers a block: every other instance's
    residency read as 0, W's as the card's."""
    real = sk._zx_grid_resident
    monkeypatch.setattr(
        sk, "_zx_grid_resident",
        lambda lib, B, r, d, u, workers=1:
        real(lib, B, r, d, u, workers) if workers == W else 0)


def _counts():
    return (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES, sk.ZX_LOCKSTEP_LAUNCHES,
            sk.ZX_BLOCK_LAUNCHES, sk.ZX_STEPS)


def _zx(ins, **kw):
    return sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)


def _close(got, want):
    """test_cuda_zx_grid_matches_plain's tolerance (rtol 1e-4, atol 1e-5:
    atomics reorder the float32 sums)."""
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 3, 4])
@pytest.mark.parametrize("M", [17, 32])
@pytest.mark.parametrize("d_loc", [600, 65_536])
def test_cuda_lockstep_matches_plain(card, monkeypatch, M, W, d_loc):
    """K = 5 (ragged at every W), B 16 with a ragged last block, the fused
    prox, 2 passes; d_loc 65,536 keeps u in device memory. One launch a
    round, counted as the lockstep form's."""
    ins = [t.to(card) for t in _ins(np.random.default_rng(M + W), 5, M,
                                    203, d_loc, 24)]
    _forced(monkeypatch, W)
    steps = 2 * -(-203 // 16)
    for loss_name in ("hinge", "squared"):
        kw = dict(loss=get_loss(loss_name), n_passes=2, block_rows=16,
                  prox_kappa=0.3)
        before = _counts()
        got = _zx(ins, **kw)
        assert (sk.LAST_ZX_FORM, sk.LAST_ZX_WORKERS) == ("grid", W)
        assert _counts() == (before[0], before[1], before[2] + 1, before[3],
                             before[4] + steps)
        _close(got, sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:],
                                                  **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 4])
def test_cuda_lockstep_matches_w1_and_block(card, monkeypatch, W):
    """K 5 x M 32 on the same inputs: the lockstep kernel against the
    W = 1 grid (the card's own pick) and the per-block kernel (the
    occupancy read as 0), B 1 (a one-row block a step) and 64."""
    ins = [t.to(card) for t in _ins(np.random.default_rng(40 + W), 5, 32,
                                    203, 600, 24)]
    for B in (1, 64):
        kw = dict(loss=get_loss("smooth_hinge"), n_passes=1, block_rows=B,
                  prox_kappa=0.2)
        one = _zx(ins, **kw)
        assert (sk.LAST_ZX_FORM, sk.LAST_ZX_WORKERS) == ("grid", 1)
        with monkeypatch.context() as mp:
            _forced(mp, W)
            lock = _zx(ins, **kw)
            assert sk.LAST_ZX_WORKERS == W
        with monkeypatch.context() as mp:
            mp.setattr(sk, "_zx_grid_resident", lambda *a: 0)
            block = _zx(ins, **kw)
            assert sk.LAST_ZX_FORM == "block"
        _close(lock, one)
        _close(lock, block)


@pytest.mark.cuda
def test_cuda_lockstep_layout_and_residency(card):
    """The library's W slabs are `smem_budget(workers=W)`'s, and the card
    holds rcv1 32 x 32's 512 blocks of W = 2 (4 an SM, as W = 1)."""
    from repro_torch.kernels import build
    lib = build.load("sparse_sdca_zx")
    for W in sk.ZX_GRID_WORKERS:
        for d_loc in (1_477, 20_000, 65_536):
            b = sk.smem_budget(d=d_loc, r_max=15, block_rows=16, zx=True,
                               workers=W)
            assert lib.sparse_sdca_zx_grid_smem_bytes(
                16, 15, d_loc, int(b["u_in_smem"]), W) == b["total_bytes"]
    one = sk._zx_grid_resident(lib, 16, 15, 1_477, True, 1)
    two = sk._zx_grid_resident(lib, 16, 15, 1_477, True, 2)
    assert two >= 512 and two >= one > 0


@pytest.mark.cuda
def test_cuda_lockstep_one_launch_a_round(card, monkeypatch):
    """`solve` on a 5 x 17 one-card mesh with W = 2 forced: one lockstep
    launch a round and nothing else, LAST_SPARSE_CONFIG's W 2, the gaps
    those of the W = 1 grid within 1e-5."""
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.data import make_sparse_classification
    from repro_torch.data.sparse import shard_features_streaming
    from repro_torch.launch.mesh import make_test_mesh
    K, M, rounds = 5, 17, 3
    csr, y = make_sparse_classification(2_000, 3_400, density=0.01, seed=0)
    fs, yp, mk = shard_features_streaming([(csr, y)], K, M,
                                          n_features=csr.shape[1],
                                          device=card)
    nk = yp.shape[1]
    cfg = CoCoAConfig.adding(K, lam=1e-4, H=nk, backend="shard_map",
                             model_axis="model", solver="sdca_sparse_kernel",
                             loss="hinge")
    mesh = make_test_mesh((K, M), device=card)
    one = solve(cfg, fs, yp, mk, rounds=rounds, gap_every=1, seed=0,
                mesh=mesh)
    _forced(monkeypatch, 2)
    before = _counts()
    lock = solve(cfg, fs, yp, mk, rounds=rounds, gap_every=1, seed=0,
                 mesh=mesh)
    after = _counts()
    assert ops.LAST_SPARSE_CONFIG["form"] == "grid"
    assert ops.LAST_SPARSE_CONFIG["workers_per_block"] == 2
    assert after[:4] == (before[0], before[1], before[2] + rounds, before[3])
    np.testing.assert_allclose(lock.history["gap"], one.history["gap"],
                               rtol=1e-5)
