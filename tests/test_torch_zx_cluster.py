"""The z-exchange round's cluster form: one thread-block cluster of M blocks
a worker, each block pushing its partial dots into slot m of every peer's
buffer (`st.async`, completing on the peer's mbarrier), a warp owning its
rows through the exchange, the update and the scatter.

On the CPU: the cluster form's shared-memory layout (`smem_budget(zx=True,
cluster=M)`) against the constants and the layout of
csrc/sparse_sdca_zx.cu, the plan's placement of u at M = 2 and 16, the
step ablation's text replacements against the sources they edit, and the
block-distinct rows (chip_smoke.py's, on which `tools/walk_times.py
--digests` compares bits).

The `cuda` tests hold the cluster kernel to the plain round at M = 1, 2, 4,
8 and 16 (16 the non-portable cluster), B = 1, 16 and 128 with a ragged
last block and with one or two blocks a pass, every loss with the fused
prox on and off, u in device memory; its results on block-distinct rows
the same bits launch after launch; and at B = 1, M = 1 the depth-1 1-D
walk. Run them on the card with `python -m pytest -q -m cuda
tests/test_torch_zx_cluster.py`.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.kernels import build
from repro_torch.kernels import sparse_sdca as sk

import torch_parity as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMEM_LIMIT = 232_448
LOSSES = ("hinge", "smooth_hinge", "squared", "absolute")


def _tool(name, where="tools"):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / where / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stage_words(B, r_loc):
    """A ring stage: B rows' cols and vals, each in the row's 16-byte
    chunks (r_loc + 6 rounded down to a multiple of 4 words), then B rows'
    five scalars and ids, rounded up to 16 bytes."""
    return (2 * B * ((r_loc + 6) // 4 * 4) + 6 * B + 3) // 4 * 4


def _cluster_bytes(B, r_loc, d_loc, M, ring):
    """The cluster block's layout written out: `ring` stages with a full
    and an empty mbarrier each, the exchange's two mbarriers and two
    buffers of B rows' M partials, and u (d_loc floats, 0: in device
    memory)."""
    return ring * (4 * _stage_words(B, r_loc) + 16) + 16 + 8 * B * M \
        + 4 * d_loc


def _ring(B, r_loc, d_loc, M):
    """The layout's rule: u in shared memory where it fits beside two
    stages, then the deepest ring of 4 .. 2 stages that fits."""
    u = _cluster_bytes(B, r_loc, d_loc, M, 2) <= SMEM_LIMIT
    d = d_loc if u else 0
    ring = next((k for k in (4, 3)
                 if _cluster_bytes(B, r_loc, d, M, k) <= SMEM_LIMIT), 2)
    return ring, u


# ----------------------------------------------------------------------------
# the layout and the plan (CPU)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 2, 4, 8, 16])
def test_cluster_budget_matches_the_cuda_source(M):
    """`smem_budget(zx=True, cluster=M)` is the source's
    `cluster_smem_bytes` at its `cluster_ring`: its constants are the
    wrapper's, its layout and its rule the ones written out here, with u
    and without."""
    src = (build.CSRC / "sparse_sdca_zx.cu").read_text()
    const = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = (\d+);",
                            src))
    assert int(const["RING_MAX"]) == sk.ZX_RING_MAX == 4
    assert int(const["SCALARS"]) == sk.ZX_SCALARS == 5
    assert int(const["SMEM_LIMIT"]) == SMEM_LIMIT
    assert "return (r_loc + 3 + 3) & ~3;" in src
    assert ("return (2 * B * ring_row_words(r_loc) + (SCALARS + 1) * B + 3)"
            " & ~3;") in src
    body = src[src.index("size_t cluster_smem_bytes("):]
    body = body[:body.index("}")]
    for term in ("4 * static_cast<size_t>(ring) * ring_stage_words(B, r_loc)",
                 "8 * static_cast<size_t>(2 * ring + 2)",
                 "8 * static_cast<size_t>(B) * M",
                 "(u_smem ? 4 * static_cast<size_t>(d_loc) : 0)"):
        assert term in body
    for B, r, d in ((16, 70, 23_618), (1, 24, 600), (128, 24, 2_000),
                    (128, 70, 23_618), (16, 70, 80_000)):
        got = sk.smem_budget(d=d, r_max=r, block_rows=B, zx=True, cluster=M)
        ring, u = _ring(B, r, d, M)
        assert sk.zx_cluster_ring(d=d, r_max=r, block_rows=B,
                                  cluster=M) == (ring, u)
        assert got["u_in_smem"] == u and got["fits"]
        assert got["total_bytes"] == _cluster_bytes(B, r, d if u else 0, M,
                                                    ring)
        assert got["scratch_bytes"] == 16 + 8 * B * M


def test_cluster_layout_at_rcv1_4x2():
    """Phase 12's shape: 135,256 bytes a block, u (94,472) in shared
    memory beside a ring of four stages; the plan takes the cluster form
    with that layout."""
    plan = sk.zx_launch_plan(4, 2, 169_350, 23_618, 16, r_loc=70)
    assert plan == dict(form="cluster", launches=1, cluster=2, steps=10_585,
                        u_in_smem=True, smem_bytes=135_256, fits=True)
    assert plan["smem_bytes"] == _cluster_bytes(16, 70, 23_618, 2, 4)
    assert sk.zx_cluster_ring(d=23_618, r_max=70, block_rows=16,
                              cluster=2) == (4, True)


@pytest.mark.parametrize("M,widest", [(2, 52_980), (16, 52_532)])
def test_cluster_u_placement_switches_at_the_limit(M, widest):
    """u leaves shared memory one float past what fits beside a ring of
    two stages and the exchange's M-wide buffers (B = 16, r_loc = 70);
    there the ring is two stages deep, past it four."""
    assert widest == (SMEM_LIMIT - _cluster_bytes(16, 70, 0, M, 2)) // 4
    at = sk.zx_launch_plan(4, M, 1_000, widest, 16, r_loc=70)
    past = sk.zx_launch_plan(4, M, 1_000, widest + 1, 16, r_loc=70)
    assert at["form"] == past["form"] == "cluster"
    assert at["u_in_smem"] and at["smem_bytes"] == _cluster_bytes(
        16, 70, widest, M, 2) <= SMEM_LIMIT
    assert not past["u_in_smem"]
    assert past["smem_bytes"] == _cluster_bytes(16, 70, 0, M, 4)


def test_the_grid_layout_is_unchanged():
    """Without `cluster` the zx budget is the grid form's block: two z
    buffers and a coefficient per row a worker, no mbarriers."""
    grid = sk.smem_budget(d=1_477, r_max=15, block_rows=16, zx=True)
    assert grid["scratch_bytes"] == 4 * 3 * 16
    assert grid["total_bytes"] == 4 * (1_477 + 3 * 16 + 4 * 16
                                       + 2 * (2 * 16 * 15 + 5 * 16))


# ----------------------------------------------------------------------------
# the tools (CPU)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["sparse", "wide", "zx", "zxc", "dense"])
def test_ablation_texts_match_the_sources(group):
    """Every replacement of `tools/sdca_step_ablation.py` matches its
    group kernel's sources as often as it says (the tool refuses to run
    otherwise), so an edit of a kernel that moves the text shows here."""
    abl = _tool("sdca_step_ablation")
    texts = abl.kernel_sources(build.CSRC, abl.GROUP_KERNEL[group])
    for name, edits in abl.VARIANTS[group].items():
        for old, _, *count in edits:
            hits = sum(t.count(old) for t in texts)
            assert hits == (count[0] if count else 1), (name, old)


def test_stamp_names_match_the_stamped_phases():
    """The cluster kernel names the phases it stamps: the walk's and the
    fetch warp's, each flushed from its own words; the parent's stamps
    name nine for each of its two warps; the buffer holds both roles'
    phases and steps."""
    src = (build.CSRC / "sparse_sdca_zx.cu").read_text()
    names = "".join(re.findall(r'"([^"]*)"', src[src.index(
        "#define ZX_STAMP_NAMES"):src.index('#include "sdca_zx_stamps')]))
    roles = dict(r.split(":") for r in names.split(";"))
    const = dict(re.findall(r"constexpr int (\w+_PHASES) = (\d+);", src))
    walk, fetch = int(const["WALK_PHASES"]), int(const["FETCH_PHASES"])
    assert list(roles) == ["walk", "fetch"]
    assert len(roles["walk"].split(",")) == walk
    assert len(roles["fetch"].split(",")) == fetch
    assert "ZX_STAMP_FLUSH(0, WALK_PHASES, 0, total)" in src
    assert "ZX_STAMP_FLUSH(WALK_PHASES, FETCH_PHASES, 1, total)" in src
    stamped = set(int(i) for i in re.findall(r"ZX_STAMP\((\d+)\)", src))
    assert stamped == set(range(max(walk, fetch)))
    head = (build.CSRC / "sdca_zx_stamps.cuh").read_text()
    words = int(re.search(r"ZX_STAMP_WORDS = (\d+);", head).group(1))
    assert walk + fetch + 2 <= words
    abl = _tool("sdca_step_ablation")
    assert len(abl.PARENT_PHASES.split(",")) == 9 and 2 * 9 + 2 <= words


def test_block_distinct_rows_repeat_no_id_in_a_block():
    """chip_smoke.py's rows (the digests of `tools/walk_times.py`): within
    each block of B rows of the visit order, every shard's rows share no
    column id; the plain round runs on them."""
    cs = _tool("chip_smoke", where="")
    K, M, nk, d_loc, r, B = 2, 3, 40, 64, 5, 4
    cols, vals, y, sq, perm = cs._block_distinct_rows(K, M, nk, d_loc, r, B)
    assert cols.shape == vals.shape == (K, M, nk, r)
    for k in range(K):
        for b in range(nk // B):
            rows = perm[k, b * B:(b + 1) * B]
            for m in range(M):
                ids = [c for i in rows for c, v in zip(cols[k, m, i],
                                                       vals[k, m, i])
                       if v != 0.0]
                assert len(ids) == len(set(ids))
    np.testing.assert_allclose(sq, np.sum(vals * vals, axis=(1, 3)))
    t = [torch.from_numpy(a) for a in (cols, vals, y, sq, perm)]
    da, du = sk.sparse_local_sdca_zx_plain(
        t[0], t[1], t[2], torch.zeros(K, nk), torch.ones(K, nk),
        torch.zeros(M * d_loc), 0.5, t[3], t[4], loss=get_loss("hinge"),
        block_rows=B)
    assert torch.isfinite(da).all() and torch.isfinite(du).all()
    assert du.abs().sum() > 0


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_zx_cluster.py`")
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


def _ins(rng, K, M, nk, d_loc, r, dev):
    """Rows with duplicate ids and ragged lengths (`tp.ell_block`), two
    masked rows, a nonzero alpha and w, the global sqnorms, a visit
    perm."""
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
    return [torch.from_numpy(a).to(dev)
            for a in (cols, vals, y, alpha, mask, w, sq, perm)]


def _held(M, B, r, d_loc):
    """Skip where the card cannot hold one cluster of M blocks of this
    layout (the wrapper would run another form)."""
    lib = build.load("sparse_sdca_zx")
    b = sk.smem_budget(d=d_loc, r_max=r, block_rows=B, zx=True, cluster=M)
    if sk._zx_clusters_fit(lib, M, B, r, d_loc, b["u_in_smem"]) < 1:
        pytest.skip(f"the card holds no cluster of {M} blocks here")


def _against_plain(ins, B, n_passes, loss_name, kappa):
    kw = dict(loss=get_loss(loss_name), n_passes=n_passes, block_rows=B,
              prox_kappa=kappa)
    before = (sk.ZX_LAUNCHES, sk.ZX_STEPS)
    got = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)
    nk = ins[0].shape[2]
    assert sk.LAST_ZX_FORM == "cluster"
    assert (sk.ZX_LAUNCHES, sk.ZX_STEPS) == (
        before[0] + 1, before[1] + n_passes * -(-nk // B))
    want = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,nk,n_passes,loss_name,kappa", [
    (1, 16, 1_000, 2, "hinge", None),
    (2, 16, 1_000, 2, "smooth_hinge", 0.3),
    (4, 128, 1_000, 3, "squared", None),      # ragged last block
    (8, 1, 203, 1, "absolute", 0.3),
    (16, 16, 1_000, 2, "hinge", 0.3),
    (16, 128, 1_000, 2, "squared", None),
    (16, 1, 203, 2, "smooth_hinge", None),
    (2, 128, 100, 3, "hinge", 0.3),           # one block a pass
    (4, 128, 200, 3, "smooth_hinge", None),   # two blocks a pass
    (8, 1, 1, 3, "squared", None),            # B = 1, one block a pass
    (2, 1, 2, 3, "absolute", 0.3),            # B = 1, two blocks a pass
    (16, 1, 3, 3, "hinge", None),
])
def test_cuda_cluster_against_plain(card, M, B, nk, n_passes, loss_name,
                                    kappa):
    _held(M, B, 24, 600)
    ins = _ins(np.random.default_rng(M * 1_000 + B), 3, M, nk, 600, 24, card)
    _against_plain(ins, B, n_passes, loss_name, kappa)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B", [(1, 16), (2, 1), (1, 128)])
def test_cuda_cluster_rows_without_16_byte_chunks(card, M, B):
    """K M nk r_loc not a multiple of 4 (r_loc 23, nk 203, K 3): the
    arrays end inside a 16-byte chunk, so the fetch warp copies the rows
    4 bytes at a time."""
    assert 3 * M * 203 * 23 % 4
    _held(M, B, 23, 600)
    ins = _ins(np.random.default_rng(20 + M), 3, M, 203, 600, 23, card)
    for loss_name, kappa in (("hinge", 0.3), ("squared", None)):
        _against_plain(ins, B, 2, loss_name, kappa)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 16])
def test_cuda_cluster_every_loss_and_prox(card, M):
    _held(M, 16, 24, 600)
    ins = _ins(np.random.default_rng(M), 2, M, 300, 600, 24, card)
    for loss_name in LOSSES:
        for kappa in (None, 0.3):
            _against_plain(ins, 16, 2, loss_name, kappa)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,kappa", [(1, 16, None), (2, 1, 0.3),
                                       (16, 128, 0.3)])
def test_cuda_cluster_with_u_in_device_memory(card, M, B, kappa):
    """d_loc = 65,536 does not fit shared memory beside the buffers: the
    instance with u in device memory."""
    d_loc = 65_536
    assert not sk.zx_launch_plan(2, M, 203, d_loc, B,
                                 r_loc=24)["u_in_smem"]
    _held(M, B, 24, d_loc)
    ins = _ins(np.random.default_rng(11 + M), 2, M, 203, d_loc, 24, card)
    for loss_name in ("hinge", "squared"):
        _against_plain(ins, B, 2, loss_name, kappa)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 4])
def test_cuda_cluster_on_block_distinct_rows_is_deterministic(card, M):
    """No two atomics of a step land on one entry of u when a block's rows
    repeat no id: two launches give the same bits, and the plain round
    within the tolerance."""
    cs = _tool("chip_smoke", where="")
    cols, vals, y, sq, perm = cs._block_distinct_rows(2, M, 400, 2_000, 30,
                                                      16)
    t = [torch.from_numpy(a).to(card) for a in (cols, vals, y, sq, perm)]
    ins = [t[0], t[1], t[2], torch.zeros((2, 400), device=card),
           torch.ones((2, 400), device=card),
           torch.zeros(M * 2_000, device=card), t[3], t[4]]
    for loss_name in LOSSES:
        for kappa in (None, 1e-3):
            first = _against_plain(ins, 16, 2, loss_name, kappa)
            again = sk.sparse_local_sdca_zx(
                *ins[:6], 0.5, *ins[6:], loss=get_loss(loss_name),
                n_passes=2, block_rows=16, prox_kappa=kappa)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_cuda_cluster_at_b1_against_the_depth1_walk(card):
    """B = 1, M = 1 is sequential SDCA on one shard: the depth-1 1-D walk
    on the same rows, within the kernels' tolerance (their dots reduce in
    another lane order)."""
    ins = _ins(np.random.default_rng(12), 3, 1, 300, 2_000, 24, card)
    kw = dict(loss=get_loss("smooth_hinge"), n_passes=2, prox_kappa=0.3)
    zx = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], block_rows=1,
                                 **kw)
    one = sk.sparse_local_sdca(ins[0][:, 0].contiguous(),
                               ins[1][:, 0].contiguous(), *ins[2:6], 0.5,
                               ins[7], buffer_depth=1, **kw)
    torch.cuda.synchronize()
    assert sk.LAST_ZX_FORM == "cluster"
    for g, p in zip(zx, one):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)
