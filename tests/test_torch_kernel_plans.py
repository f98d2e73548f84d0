"""Launch plans and shared-memory budgets of the port's redesigned kernels,
checked on the CPU (shape arithmetic only; the card-only tests run the
kernels).

The dense walk runs windows of B rows over a cluster of C blocks, each
with its slice of u, a ring of row stages, the window's exchanged partials
and its reduction buffers in shared memory (`dense_smem_budget`; C = 1
here, tests/test_torch_dense_cluster.py checks every C); the 1-D sparse
walk, one walk warp and one fetch warp a worker, holds a ring of one-row
stages and u where it fits beside them (`smem_budget`). The zx kernel runs a round in one launch, one
thread-block cluster of M blocks per worker, with u in shared memory where
it fits beside its buffers (`zx_launch_plan`, `smem_budget(zx=True)`);
beyond a cluster its per-block kernel runs one launch an invocation, u in
device memory (`zx_launch_plan`'s "block" form); flash attention's
bfloat16 instance holds bf16 tiles with padded rows, its float32 instance
float32 tiles (`smem_bytes(hd, dtype)`). The selective scan runs a block
of 32 channels times ceil(N / G) warps, with two stages of its streams
and two sets of y partials in shared memory (`scan_launch_plan`). Every
block must fit the H100's 232,448 bytes of shared memory.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import local_sdca as dk
from repro_torch.kernels import sparse_sdca as sk
from repro_torch.kernels import ssm_scan as ss

SMEM_LIMIT = 232_448


def _zx_bytes(B, r_loc, d_loc=0, M=None, ring=4):
    """The zx block's layout written out, with u. The grid form's (M None):
    two z buffers and a coefficient per row, four id slots and two stages
    of B rows' cols, vals and five scalars. The cluster form's at M
    shards: `ring` stages of B rows, each row's cols and vals in its
    16-byte chunks (r_loc + 6 rounded down to 4 words each), its five
    scalars and its id, two 8-byte mbarriers a stage; two buffers of B
    rows' M partials and their two mbarriers."""
    if M is None:
        return 4 * (d_loc + 3 * B + 4 * B + 2 * (2 * B * r_loc + 5 * B))
    stage = (2 * B * ((r_loc + 6) // 4 * 4) + 6 * B + 3) // 4 * 4
    return ring * (4 * stage + 16) + 8 * B * M + 16 + 4 * d_loc


def test_zx_plan_at_rcv1_4x2_holds_u_in_shared_memory():
    plan = sk.zx_launch_plan(4, 2, 169_350, 23_618, 16, r_loc=70)
    assert plan == dict(form="cluster", launches=1, cluster=2, steps=10_585,
                        u_in_smem=True,
                        smem_bytes=_zx_bytes(16, 70, 23_618, M=2),
                        fits=True)
    assert plan["smem_bytes"] == 135_256 <= SMEM_LIMIT
    budget = sk.smem_budget(d=23_618, r_max=70, block_rows=16, zx=True,
                            cluster=2)
    assert budget["u_bytes"] == 94_472 and budget["u_in_smem"]
    assert budget["total_bytes"] == plan["smem_bytes"]


def test_zx_plan_at_a_wide_slice_keeps_u_in_device_memory():
    plan = sk.zx_launch_plan(8, 1, 2_000, 65_536, 16, r_loc=64,
                             n_passes=2)
    assert not plan["u_in_smem"] and plan["fits"]
    assert plan["smem_bytes"] == _zx_bytes(16, 64, M=1)
    assert (plan["launches"], plan["steps"]) == (1, 2 * 125)


def test_zx_u_placement_switches_at_the_limit():
    B, r = 16, 70
    rest = _zx_bytes(B, r)
    widest = (SMEM_LIMIT - rest) // 4
    at = sk.smem_budget(d=widest, r_max=r, block_rows=B, zx=True)
    past = sk.smem_budget(d=widest + 1, r_max=r, block_rows=B, zx=True)
    assert at["u_in_smem"] and at["total_bytes"] <= SMEM_LIMIT
    assert not past["u_in_smem"] and past["total_bytes"] == rest
    assert widest == 53_360                # B = 16, r_loc = 70


@pytest.mark.parametrize("M", [1, 2, 8, 9, 16])
def test_zx_plan_cluster_sizes(M):
    """Up to 8 blocks a cluster is portable, 9-16 need the non-portable
    attribute (set by the launcher); all run a round in one launch."""
    plan = sk.zx_launch_plan(3, M, 100, 50, 4, r_loc=3)
    assert (plan["launches"], plan["cluster"]) == (1, M)


@pytest.mark.parametrize("M", [0, 17, 32])
def test_zx_plan_beyond_a_cluster_takes_the_block_form(M):
    """M = 17 and 32 are past the largest cluster the card schedules: one
    launch of the per-block kernel per invocation, u in device memory;
    M = 0 is no mesh and still raises."""
    if M < 1:
        with pytest.raises(ValueError, match="M >= 1"):
            sk.zx_launch_plan(4, M, 100, 50, 16, r_loc=4)
        return
    plan = sk.zx_launch_plan(4, M, 100, 50, 16, r_loc=4, n_passes=2)
    assert plan == dict(form="block", launches=14, cluster=1, steps=14,
                        u_in_smem=False, smem_bytes=8 * 16, fits=True)
    # the same shape within a cluster, when the cluster is not to be used
    inside = sk.zx_launch_plan(4, 16, 100, 50, 16, r_loc=4, n_passes=2,
                               cluster=False)
    assert inside == plan


@pytest.mark.parametrize("nk,B,n_passes", [(1, 1, 1), (203, 16, 2),
                                           (203, 128, 3), (100, 128, 1),
                                           (169_350, 16, 1)])
def test_zx_plan_steps_are_the_schedules_invocations(nk, B, n_passes):
    plan = sk.zx_launch_plan(2, 2, nk, 40, B, r_loc=5, n_passes=n_passes)
    assert plan["steps"] == n_passes * (-(-nk // B))
    assert plan["steps"] + 1 == sk.zx_exchanges(nk, B, n_passes)


def test_zx_plan_agrees_with_the_dispatch_plan():
    """`ops.sparse_zx_plan` (the wire plan) and `zx_launch_plan` count the
    same invocations at rcv1's 4 x 2 shape."""
    wire = ops.sparse_zx_plan(169_350, 23_618, 169_350, r_max=70,
                              model_shards=2, backend="cuda")
    plan = sk.zx_launch_plan(4, 2, 169_350, 23_618, wire["block_rows"],
                             r_loc=70, n_passes=wire["n_passes"])
    assert plan["steps"] == wire["n_passes"] * wire["blocks"]
    assert wire["exchanges"] == plan["steps"] + 1


def test_zx_cpu_path_takes_any_m_and_counts_nothing():
    """M = 17 is beyond a cluster, but the CPU plain version runs it; the
    launch and step counts are the card's and do not move."""
    rng = np.random.default_rng(0)
    K, M, nk, d_loc, r = 1, 17, 6, 3, 2
    cols = torch.from_numpy(rng.integers(0, d_loc, (K, M, nk, r))
                            .astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((K, M, nk, r))
                            .astype(np.float32))
    y = torch.ones(K, nk)
    z = torch.zeros(K, nk)
    sq = torch.sum(vals * vals, dim=(1, 3))
    perm = torch.arange(nk, dtype=torch.int32)[None]
    before = (sk.ZX_LAUNCHES, sk.ZX_STEPS)
    da, du = sk.sparse_local_sdca_zx(cols, vals, y, z, torch.ones(K, nk),
                                     torch.zeros(M * d_loc), 0.5, sq, perm,
                                     loss=get_loss("hinge"), block_rows=2)
    assert (sk.ZX_LAUNCHES, sk.ZX_STEPS) == before
    assert da.shape == (K, nk) and du.shape == (K, M * d_loc)
    assert torch.isfinite(da).all() and torch.isfinite(du).all()


@pytest.mark.parametrize("hd,dtype,want", [
    (32, torch.bfloat16, 25_600), (64, torch.bfloat16, 46_080),
    (128, torch.bfloat16, 87_040), (256, torch.bfloat16, 101_376),
    (32, torch.float32, 41_728), (64, torch.float32, 66_304),
    (128, torch.float32, 115_456), (256, torch.float32, 213_760)])
def test_flash_smem_bytes_of_every_instance(hd, dtype, want):
    """bf16: the q tile and two K and two V tiles of (hd + 8) bf16 a row
    (64 keys a tile, 32 at hd 256); float32: q and K padded by a float a
    row, V, and p, all float32. Every instance fits a block."""
    assert fa.smem_bytes(hd, dtype) == want <= SMEM_LIMIT
    tile = 32 if (hd, dtype) == (256, torch.bfloat16) else 64
    assert fa.kv_tile(hd, dtype) == tile


def test_flash_smem_bytes_refuses_other_dtypes():
    with pytest.raises(ValueError, match="flash_attention takes"):
        fa.smem_bytes(64, torch.float16)


def _dense_bytes(d, B, d_tile, ring=2, ahead=False):
    """The dense block's layout written out, a block a worker (C = 1): a
    full and an empty mbarrier a stage, four for the exchange and two for
    c, `ring` stages of B x d_tile floats, u (two with the lookahead), the
    exchange's four buffers of P partials, the block's own and the summed
    partials, c and the row ids in two slots, and two reduction buffers of
    7 x 64 words; P = B (B + 3) / 2, plus B^2 with the lookahead."""
    P = B * (B + 3) // 2 + (B * B if ahead else 0)
    return 4 * (2 * (2 * ring + 6) + ring * B * d_tile
                + (2 if ahead else 1) * ((d + 3) // 4 * 4) + 4 * P + 2 * P
                + 4 * B + 2 * 7 * 64)


@pytest.mark.parametrize("B,chunks,d_tile", [(1, 1, 2_000), (2, 1, 2_000),
                                             (4, 1, 2_000), (8, 1, 2_000),
                                             (16, 2, 1_000), (32, 3, 668)])
def test_dense_budget_at_epsilons_width(B, chunks, d_tile):
    """epsilon's d = 2,000 at a block a worker: whole rows with the
    lookahead up to B = 8 (the default window; a ring of 4 stages, 3 at
    B = 8), rows cut into balanced column tiles beyond (two stages)."""
    ahead = chunks == 1
    ring = {1: 4, 2: 4, 4: 4, 8: 3}.get(B, 2)
    got = dk.dense_smem_budget(2_000, B)
    assert (got["chunks"], got["d_tile"], got["ring"], got["ahead"]) == (
        chunks, d_tile, ring, ahead)
    assert got["total_bytes"] == _dense_bytes(2_000, B, d_tile, ring, ahead)
    assert got["fits"] and got["total_bytes"] <= SMEM_LIMIT
    assert got["u_bytes"] == 8_000 * (2 if ahead else 1)
    assert chunks * d_tile >= 2_000 > (chunks - 1) * d_tile


def test_dense_budget_at_rcv1s_width_tiles_the_rows():
    """d = 47,236 (rcv1's width, were it dense) at a block a worker: u
    takes 188,944 bytes, so the default window's rows are cut into 79 tiles
    of 600 columns."""
    got = dk.dense_smem_budget(47_236)
    assert dk.DEFAULT_BLOCK_ROWS == 8
    assert (got["chunks"], got["d_tile"], got["u_bytes"]) == (79, 600,
                                                               188_944)
    assert got["fits"] and got["total_bytes"] == _dense_bytes(47_236, 8, 600)


def test_dense_budget_at_its_limit():
    """The widest d whose u and a 4-column ring still fit a block, per
    window (at B = 8, 56,836); four columns more are refused by
    check_u_fits, naming the limit."""
    for B in dk.BLOCK_ROWS:
        widest = max(d for d in range(50_000, 58_100, 4)
                     if dk.dense_smem_budget(d, B)["fits"])
        assert dk.dense_smem_budget(widest, B)["total_bytes"] <= SMEM_LIMIT
        assert not dk.dense_smem_budget(widest + 4, B)["fits"]
        with pytest.raises(ValueError, match="232448 bytes"):
            dk.check_u_fits(widest + 4, B)
        assert B != 8 or widest == 56_836
    assert dk.check_u_fits(2_000)["fits"]


@pytest.mark.parametrize("B", [0, 3, 64])
def test_dense_budget_refuses_windows_the_kernel_lacks(B):
    with pytest.raises(ValueError, match="block_rows must be one of"):
        dk.dense_smem_budget(2_000, B)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_sparse_budget_at_rcv1(depth):
    """rcv1's d = 47,236, r_max = 118: u, and per stage two regions of 124
    words (the row from its 16-byte chunk), 8 scalar words and two
    mbarriers; no reduction scratch. Every depth fits."""
    got = sk.smem_budget(d=47_236, r_max=118, nk=84_675, buffer_depth=depth)
    assert got["scratch_bytes"] == 0 and got["u_bytes"] == 188_944
    assert got["ring_bytes"] == depth * (4 * (2 * 124 + 8) + 16)
    assert got["fits"] and got["total_bytes"] <= SMEM_LIMIT


def test_sparse_budget_at_its_limit():
    """At depth 8 and r_max = 118 the widest u in shared memory leaves the
    ring's 8,320 bytes; one float more and u moves to device memory, the
    ring alone in shared memory."""
    widest = (SMEM_LIMIT - 8 * 1_040) // 4
    at = sk.smem_budget(d=widest, r_max=118, buffer_depth=8)
    assert at["fits"] and at["u_in_smem"]
    past = sk.smem_budget(d=widest + 1, r_max=118, buffer_depth=8)
    assert past["fits"] and not past["u_in_smem"]
    assert past["total_bytes"] == past["ring_bytes"] == 8 * 1_040
    # the regions round r_max + 3 up to whole 16-byte chunks
    assert [sk.stage_row_words(r) for r in (1, 2, 4, 5, 118, 125)] == \
        [4, 8, 8, 8, 124, 128]


def test_python_layouts_match_the_cuda_sources():
    """The budgets above restate constants of the .cu files; hold them to
    the sources, so an edit of one side shows here."""
    zx = (build.CSRC / "sparse_sdca_zx.cu").read_text()
    assert re.search(r"constexpr int ID_SLOTS = (\d+);", zx).group(1) == \
        str(sk.ZX_ID_SLOTS)
    assert re.search(r"constexpr int SCALARS = (\d+);", zx).group(1) == \
        str(sk.ZX_SCALARS)
    assert re.search(r"constexpr int MAX_CLUSTER = (\d+);", zx).group(1) == \
        str(sk.ZX_MAX_CLUSTER)
    flash = (build.CSRC / "flash_attention.cu").read_text()
    tc = flash[flash.index("namespace tc {"):]
    assert re.search(r"constexpr int PAD = (\d+);", tc).group(1) == \
        str(fa.PAD)
    assert re.search(r"constexpr int BQ = (\d+);", tc).group(1) == \
        str(fa.TILE)
    assert "HD >= 256 ? 32 : 64" in tc
    dense = (build.CSRC / "local_sdca.cu").read_text()
    assert re.search(r"constexpr int THREADS = (\d+);", dense).group(1) == \
        str(32 * (dk.COL_WARPS + 1))
    assert re.search(r"constexpr int RED_WORDS = (\d+);", dense).group(1) \
        == str(dk.RED_WORDS)
    assert re.search(r"constexpr int XBUFS = (\d+);", dense).group(1) == \
        str(dk.XBUFS)
    assert tuple(int(b) for b in re.findall(
        r"case (\d+): return f\(std::integral_constant<int, \1>", dense)) \
        == dk.BLOCK_ROWS
    walk = (build.CSRC / "sparse_sdca_pipelined.cu").read_text()
    assert re.search(r"constexpr int STAGE_SCALARS = (\d+);", walk).group(1) \
        == str(sk.STAGE_SCALARS)
    assert re.search(r"constexpr int MAX_DEPTH = (\d+);", walk).group(1) == \
        str(sk.MAX_DEPTH)
    assert "return (r_max + 3 + 3) & ~3;" in walk      # stage_row_words
    scan = (build.CSRC / "ssm_scan.cu").read_text()
    assert re.search(r"constexpr int MAX_STATE = (\d+);", scan).group(1) \
        == str(ss.MAX_STATE)
    assert re.search(r"constexpr int CH = (\d+);", scan).group(1) == \
        str(ss.CHANNELS)
    assert re.search(r"constexpr int T = (\d+);", scan).group(1) == \
        str(ss.CHUNK)
    groups = re.search(r"#define SSM_SCAN_GROUPS\(X\) (.*)", scan).group(1)
    assert tuple(int(g) for g in re.findall(r"X\((\d+)\)", groups)) == \
        ss.GROUPS
    assert "__launch_bounds__(CH * (MAX_STATE / G))" in scan   # threads
    assert ("constexpr int STAGE_FLOATS = 2 * T * CH + 2 * T * MAX_STATE;"
            in scan)                                           # a stage
    assert ("return 2LL * STAGE_FLOATS + 2LL * n_groups(N, G) * T * CH;"
            in scan)


def _scan_bytes(N, G, T=64):
    """The scan block's layout written out: two stages of x and dt (T x 32
    floats) and B and C (T x 16), then two sets of ceil(N / G) planes of
    T x 32 y partials (one written while the other is stored)."""
    return 4 * (2 * (2 * T * 32 + 2 * T * 16) + 2 * -(-N // G) * T * 32)


def test_scan_plan_at_the_scoring_shape():
    """falcon-mamba-7b's scoring forward, B 1, S 2,048, di 8,192, N 16: 256
    blocks of 4 warps (G = 4), 32 chunks of 64 steps, 112 KB a block, so
    two blocks share an SM (233,472 bytes, 1 KB reserved a block)."""
    plan = ss.scan_launch_plan(1, 2_048, 8_192, 16)
    assert plan == dict(grid=(256, 1), threads=128, smem_bytes=114_688,
                        group=4, chunks=32)
    assert plan["smem_bytes"] == _scan_bytes(16, 4)
    assert 2 * (plan["smem_bytes"] + 1_024) <= 233_472


@pytest.mark.parametrize("B,S,di,N,G", [
    (1, 100, 256, 1, 4), (1, 100, 256, 5, 4), (1, 100, 256, 8, 4),
    (1, 100, 256, 16, 4), (1, 1, 256, 16, 4), (1, 63, 256, 16, 4),
    (1, 64, 256, 16, 4), (1, 65, 256, 16, 4), (1, 129, 256, 16, 4),
    (3, 70, 256, 16, 4), (2, 70, 200, 16, 4), (1, 70, 203, 5, 4),
    (3, 129, 200, 5, 8), (1, 65, 256, 16, 16), (2, 33, 203, 8, 16)])
def test_scan_plan_at_the_cut_shapes(B, S, di, N, G):
    """chip_smoke.py phase 7's shapes: a block per 32 channels (the last
    one ragged past di) and batch row, one warp per G states up to N."""
    plan = ss.scan_launch_plan(B, S, di, N, group=G)
    assert plan["grid"] == (-(-di // 32), B)
    assert plan["threads"] == 32 * -(-N // G) <= 32 * 16 // G
    assert plan["smem_bytes"] == _scan_bytes(N, G) <= SMEM_LIMIT
    assert plan["chunks"] == -(-S // 64)


def test_scan_instances_all_fit_a_block():
    for G in ss.GROUPS:
        got = ss.scan_launch_plan(1, 1, 1, 16, G)["smem_bytes"]
        assert got == _scan_bytes(16, G) <= SMEM_LIMIT
    assert max(ss.smem_bytes(16, G) for G in ss.GROUPS) == \
        114_688                                  # G = 4
    assert ss.GROUPS == (4, 8, 16) and ss.CHUNK == 64


@pytest.mark.parametrize("kw,match", [
    (dict(N=0), "N=0 not in"), (dict(N=17), "N=17 not in"),
    (dict(group=3), "not an instance"), (dict(di=0), "di=0"),
    (dict(group=2), "not an instance"),
    (dict(B=0), "batch 0"), (dict(B=65_536), "batch 65536"),
    (dict(S=0), "S=0")])
def test_scan_plan_refuses_what_the_kernel_cannot_run(kw, match):
    with pytest.raises(ValueError, match=match):
        ss.scan_launch_plan(**{**dict(B=1, S=8, di=64, N=16), **kw})
