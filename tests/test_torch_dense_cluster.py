"""The dense kernel's window over a thread-block cluster, replayed in plain
torch on the CPU.

`csrc/local_sdca.cu` runs each worker as a cluster of C blocks, block r
owning the columns [r dc, min(d, (r + 1) dc)), dc = ceil(d / C) rounded up
to 4. Per window each block takes the partial z0 and Gram over its columns,
pushes them to every peer, and every block sums the C partials in rank
order 0..C-1, so each runs the same scalar loop and applies the window's
update to its own columns. `cluster_replay` below is that schedule in plain
torch (the lookahead's too: window s's dots at window s - 1's start u
plus H c_{s-1}, H = X_s X_{s-1}^T), held here to

  * the reference's `local_sdca_ref` and its Pallas `local_sdca_pallas` in
    interpret mode (as tests/test_torch_dense_window.py runs them), at rtol
    1e-4 and atol 1e-5, for every closed-form loss, C = 1, 2, 3, 16, B = 3
    and 8, d = 90 (a multiple of no 4 C) and d = 54 (below 4 C at C = 16:
    slices past d own no columns), nk = 44 (a multiple of neither B), two
    passes, zero and masked rows, with the lookahead and without;
  * `window_replay` (the one-block schedule) bit for bit at C = 1 without
    the lookahead (the kernel's column-tile form), and in float64 to 1e-12
    with it;

and the launch plan and the shared-memory layout against the constants and
the layout the CUDA source states.

The `cuda` tests hold the kernel at every (B, C) to `local_sdca_plain` on
the card; run them there with
`python -m pytest -q -m cuda tests/test_torch_dense_cluster.py`.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.kernels import build
from repro_torch.kernels import local_sdca as dk

from test_torch_dense_window import _case, _t, window_replay
from torch_parity import to_np

CLOSED_FORM = ["hinge", "smooth_hinge", "squared", "absolute"]
RTOL, ATOL = 1e-4, 1e-5
K, NK = 2, 44
WIDTHS = (90, 54)
SMEM_LIMIT = 232_448


def cluster_replay(X, y, alpha, mask, w, scale, perm, *, loss, n_passes=1,
                   block_rows=8, cluster=1, ahead=True):
    """The cluster's schedule: windows of `block_rows` visit positions cut
    at every pass boundary; per window each of the `cluster` column slices'
    partials (torch.sum over its columns; zeros past d), summed in rank
    order, the in-order scalar updates on the sums, then each slice's
    rank-B update of its own columns in visit order. With `ahead` (the
    kernel's lookahead, where whole slices fit) a window's dots are taken
    at the window before's start u, z = X_s u0_{s-1} + H c_{s-1} with
    H = X_s X_{s-1}^T; without it (column tiles) z = X_s u0_s. Works in X's
    dtype."""
    Kw, nk, d = X.shape
    dc = dk.slice_cols(d, cluster)
    slices = [slice(min(d, r * dc), min(d, (r + 1) * dc))
              for r in range(cluster)]

    def summed(part):                                  # in rank order
        out = None
        for cols in slices:
            out = part(cols) if out is None else out + part(cols)
        return out
    ks = torch.arange(Kw)
    perm = perm.long()
    dalpha = torch.zeros((Kw, nk), dtype=X.dtype)
    u = w.to(X.dtype).expand(Kw, d).clone()
    prev = None                                        # (X_B, c, u0) before
    for p in range(n_passes):
        for s0 in range(0, nk, block_rows):
            nb = min(block_rows, nk - s0)
            rows = perm[:, s0:s0 + nb]
            XB = X[ks[:, None], rows]                  # (K, nb, d)
            G = summed(lambda cols: torch.sum(
                XB[:, :, None, cols] * XB[:, None, :, cols], dim=-1))
            if ahead and prev is not None:
                XP, cp, u0p = prev
                z = summed(lambda cols: torch.sum(
                    XB[..., cols] * u0p[:, None, cols], dim=-1))
                H = summed(lambda cols: torch.sum(
                    XB[:, :, None, cols] * XP[:, None, :, cols], dim=-1))
                for l in range(len(cp)):
                    z = z + cp[l][:, None] * H[:, :, l]
            else:
                z = summed(lambda cols: torch.sum(
                    XB[..., cols] * u[:, None, cols], dim=-1))
            dai = dalpha[ks[:, None], rows].clone()
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
            prev = (XB, c, u.clone())
            for cols in slices:
                for j in range(nb):
                    u[:, cols] = u[:, cols] + c[j][:, None] * XB[:, j, cols]
    return dalpha, u - w.to(X.dtype)


@pytest.fixture(scope="module")
def reference_runs():
    """`local_sdca_ref` and Pallas `local_sdca_pallas` (interpret mode) on
    `_case(0, d=...)` for each of WIDTHS, per loss, worker by worker in
    visit order, two passes; dalpha back at the original row index."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import losses
    from repro.kernels import ref as rref
    from repro.kernels.local_sdca import local_sdca_pallas

    out = {}
    for d in WIDTHS:
        (X, y, alpha, mask, w), perm = _case(0, Kw=K, nk=NK, d=d)
        for name in CLOSED_FORM:
            rloss = losses.get_loss(name)
            runs = {}
            for kind in ("ref", "pallas"):
                das, dus = [], []
                for k in range(K):
                    p = perm[k]
                    args = [jnp.asarray(a[k][p]) for a in (X, y, alpha, mask)]
                    if kind == "ref":
                        da_p, du = rref.local_sdca_ref(
                            *args, jnp.asarray(w), 0.7, loss=rloss,
                            n_passes=2)
                    else:
                        da_p, du = local_sdca_pallas(
                            *args, jnp.asarray(w), 0.7, loss=rloss,
                            n_passes=2, block_rows=4, interpret=True)
                    da = np.zeros(NK, np.float32)
                    da[p] = np.asarray(da_p)
                    das.append(da)
                    dus.append(np.asarray(du))
                runs[kind] = (np.stack(das), np.stack(dus))
            out[d, name] = runs
    return out


@pytest.mark.parametrize("ahead", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("C", [1, 2, 3, 16])
@pytest.mark.parametrize("loss_name", CLOSED_FORM)
def test_cluster_replay_matches_ref_and_pallas(reference_runs, loss_name, C,
                                               B, d, ahead):
    assert d % (4 * C) or C == 1
    (X, y, alpha, mask, w), perm = _case(0, Kw=K, nk=NK, d=d)
    got = cluster_replay(*_t(X, y, alpha, mask, w), 0.7, *_t(perm),
                         loss=get_loss(loss_name), n_passes=2, block_rows=B,
                         cluster=C, ahead=ahead)
    for kind in ("ref", "pallas"):
        for g, r in zip(got, reference_runs[d, loss_name][kind]):
            np.testing.assert_allclose(to_np(g), r, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{kind} B={B} C={C} d={d}")
    # masked rows stay exact no-ops
    assert np.all(to_np(got[0])[:, [2, NK - 1]] == 0.0)


@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("loss_name", CLOSED_FORM)
def test_cluster_of_one_is_the_window_replay_bit_for_bit(loss_name, B):
    (X, y, alpha, mask, w), perm = _case(1, d=90)
    args = (*_t(X, y, alpha, mask, w), 0.7, *_t(perm))
    kw = dict(loss=get_loss(loss_name), n_passes=2, block_rows=B)
    got = cluster_replay(*args, cluster=1, ahead=False, **kw)
    want = window_replay(*args, **kw)
    for g, p in zip(got, want):
        assert torch.equal(g, p)


@pytest.mark.parametrize("loss_name", CLOSED_FORM)
def test_lookahead_in_float64_is_the_window_schedule(loss_name):
    """The lookahead's z = X_s u0_{s-1} + H c_{s-1} is X_s u0_s in exact
    arithmetic: in float64, B = 8 over nk = 37 (a ragged last window), two
    passes, it is the one-block schedule to 1e-12 at C = 1 and 3."""
    (X, y, alpha, mask, w), perm = _case(7, nk=37, d=90, dtype=np.float64)
    args = (*_t(X, y, alpha, mask, w), 0.7, *_t(perm))
    kw = dict(loss=get_loss(loss_name), n_passes=2, block_rows=8)
    want = window_replay(*args, **kw)
    for C in (1, 3):
        for g, p in zip(cluster_replay(*args, cluster=C, **kw), want):
            np.testing.assert_allclose(to_np(g), to_np(p), rtol=0,
                                       atol=1e-12)


def test_slices_past_d_own_no_columns():
    """d = 54 at C = 16: dc = 4, so ranks 0-12 own 4 columns, rank 13 two
    and ranks 14-15 none; the replay's sums take zeros from them and agree
    with C = 1 to float32 rounding."""
    assert dk.slice_cols(54, 16) == 4
    owned = [max(0, min(4, 54 - 4 * r)) for r in range(16)]
    assert owned[:13] == [4] * 13 and owned[13:] == [2, 0, 0]
    (X, y, alpha, mask, w), perm = _case(2, d=54)
    args = (*_t(X, y, alpha, mask, w), 0.7, *_t(perm))
    kw = dict(loss=get_loss("smooth_hinge"), n_passes=2, block_rows=8)
    for g, p in zip(cluster_replay(*args, cluster=16, **kw),
                    cluster_replay(*args, cluster=1, **kw)):
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------------
# the layout and the plan against the CUDA source (CPU)
# ----------------------------------------------------------------------------

def _source():
    return (build.CSRC / "local_sdca.cu").read_text()


def _words(dc, B, C, dt, ring, ahead):
    """The block's layout written out, in 4-byte words: a full and an
    empty mbarrier a stage, one an exchange buffer and two for c (8 bytes
    each), the ring, u's slice (two with the lookahead), the exchange's
    four buffers of C partials,
    the block's own partials and the sums, c and the row ids in two slots,
    two reduction buffers of 7 warps x 64 words."""
    P = B * (B + 3) // 2 + (B * B if ahead else 0)
    return (2 * (2 * ring + 4 + 2) + ring * B * dt + (2 if ahead else 1) * dc
            + 4 * C * P + 2 * P + 4 * B + 2 * 7 * 64)


def _layout(d, B, C):
    """The layout's rule: whole slices with the lookahead in the deepest
    ring of 4 .. 2 that fits; else, without it, two stages of the widest
    multiple of 4 columns, evened out over the tiles."""
    dc = -(-(-(-d // C)) // 4) * 4
    for ring in (4, 3, 2):
        if 4 * _words(dc, B, C, dc, ring, True) <= SMEM_LIMIT:
            return dc, dc, ring, 1, True
    widest = (SMEM_LIMIT // 4 - _words(dc, B, C, 0, 2, False)) // (2 * B) \
        // 4 * 4
    if widest < 4:
        return dc, 4, 2, dc // 4, False
    chunks = -(-dc // widest)
    return dc, -(-(-(-dc // chunks)) // 4) * 4, 2, chunks, False


def test_constants_match_the_cuda_source():
    src = _source()
    const = dict(re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);",
                            src))
    assert "constexpr int COL_WARPS = THREADS / 32 - 1;" in src
    assert int(const["THREADS"]) // 32 - 1 == dk.COL_WARPS == 7
    assert int(const["RED_WORDS"]) == dk.RED_WORDS == 64
    assert int(const["RING_MAX"]) == dk.RING_MAX == 4
    assert int(const["XBUFS"]) == dk.XBUFS == 4
    assert int(const["MAX_CLUSTER"]) == dk.MAX_CLUSTER == max(dk.CLUSTERS)
    assert int(const["SMEM_LIMIT"]) == dk.MAX_SMEM_BYTES == SMEM_LIMIT
    assert "return B * (B + 3) / 2 + (ahead ? B * B : 0);" in src
    assert "return round4((d + C - 1) / C);" in src
    body = src[src.index("long long smem_words("):]
    body = body[:body.index("}")]
    for term in ("2LL * (2 * ring + XBUFS + 2)",
                 "static_cast<long long>(ring) * B * dt",
                 "(ahead ? 2LL : 1LL) * dc",
                 "XBUFS * C * P", "2LL * P", "4LL * B",
                 "2LL * COL_WARPS * RED_WORDS;"):
        assert term in body, term
    # the kernel carves its shared memory in the same order
    carve = src[src.index("unsigned long long* full = "):
                src.index("const int r = static_cast<int>(blockIdx.x)")]
    order = [m for m in re.findall(r"(\w+) = (?:reinterpret_cast<[^>]+>\()?"
                                   r"(\w+)", carve)]
    names = ["full", "empty", "xbar", "cbar", "stages", "u", "xb", "part",
             "sums", "cvec", "wid", "red"]
    assert order == list(zip(names, ["smem"] + names[:-1]))


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32])
def test_budget_matches_the_layout(B):
    for d in (1, 54, 90, 2_000, 2_001, 16_384, 20_000, 56_912, 65_536,
              300_000, 2_000_000):
        for C in (1, 2, 3, 4, 8, 16):
            got = dk.dense_smem_budget(d, B, C)
            dc, dt, ring, chunks, ahead = _layout(d, B, C)
            assert (got["dc"], got["d_tile"], got["ring"], got["chunks"],
                    got["ahead"]) == (dc, dt, ring, chunks, ahead), (d, C)
            assert got["total_bytes"] == 4 * _words(dc, B, C, dt, ring,
                                                    ahead)
            assert got["fits"] == (got["total_bytes"] <= SMEM_LIMIT)


def test_the_d_limit_rises_with_the_cluster():
    """B = 8: one block holds d up to 56,9xx (u beside two stages of 4
    columns); sixteen blocks hold sixteen slices, each as wide."""
    def widest(C):
        lo, hi = 1, 1 << 24
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if dk.dense_smem_budget(mid, 8, C)["fits"] \
                else (lo, mid - 1)
        return lo
    one, sixteen = widest(1), widest(16)
    assert 56_000 < one < 57_000
    assert sixteen > 15 * one
    assert not dk.dense_smem_budget(one + 4, 8, 1)["fits"]
    assert dk.dense_smem_budget(65_536, 8, 2)["fits"]


HELD = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("K,nk,d,held,want", [
    (8, 50_000, 2_000, HELD, 8),              # epsilon: 16 not all resident
    (7, 50_000, 2_000, HELD, 8),              # ... or 128 columns for 16
    (4, 20_000, 4_000, HELD, 8),              # 252 columns for 16 peers
    (4, 20_000, 1_000, HELD, 8),              # 128 columns for 8 peers
    (1, 16_384, 16_384, HELD, 16),            # the paper cell's rank block
    (8, 1_000, 54, HELD, 1),                  # covtype: too few columns
    (8, 1_000, 900, HELD, 4),                 # 228 columns at C = 4
    (200, 100, 2_000, HELD, 1),               # K past every cluster
    (200, 100, 65_536, HELD, 2),              # ... where one block is short
    (8, 100, 65_536, HELD, 8),
    (4, 100, 2_000, 0, 1),                    # the card holds no cluster
])
def test_plan_picks_the_cluster(K, nk, d, held, want):
    plan = dk.dense_launch_plan(K, nk, d, 8, resident=held)
    assert plan["cluster"] == want and plan["fits"]
    b = dk.dense_smem_budget(d, 8, want)
    assert (plan["dc"], plan["d_tile"], plan["ring"], plan["smem_bytes"]) \
        == (b["dc"], b["d_tile"], b["ring"], b["total_bytes"])
    assert plan["blocks"] == K * want and plan["windows"] == -(-nk // 8)
    if want > 1:
        assert plan["dc"] >= dk.COLS_PER_PEER * want


def test_plan_forces_and_refuses():
    forced = dk.dense_launch_plan(8, 100, 2_000, 8,
                                  resident={**HELD, 3: 44}, cluster=3)
    assert forced["cluster"] == 3 and forced["dc"] == 668
    with pytest.raises(ValueError, match="holds no cluster of 16"):
        dk.dense_launch_plan(8, 100, 2_000, 8, resident={16: 0}, cluster=16)
    too_wide = dk.dense_launch_plan(8, 100, 65_536, 8, resident=HELD,
                                    cluster=1)
    assert not too_wide["fits"]
    with pytest.raises(ValueError, match="232448 bytes"):
        dk.check_u_fits(65_536, 8, 1)
    with pytest.raises(ValueError, match="cluster must be 1..16"):
        dk.dense_smem_budget(2_000, 8, 17)


def test_cpu_tensors_take_the_plain_version_at_any_cluster():
    (X, y, alpha, mask, w), perm = _case(5, nk=12)
    args = (*_t(X, y, alpha, mask, w), 0.5, *_t(perm))
    before = dk.LAUNCHES
    want = dk.local_sdca_plain(*args, loss=get_loss("hinge"))
    for C in (None, 1, 3, 16):
        got = dk.local_sdca(*args, loss=get_loss("hinge"), cluster=C)
        assert all(torch.equal(g, p) for g, p in zip(got, want))
        assert dk.LAST_DENSE_CONFIG["form"] == "plain"
    assert dk.LAUNCHES == before


def test_ops_records_the_dense_launch():
    from repro_torch.core.losses import get_loss as gl
    from repro_torch.kernels import ops
    (X, y, alpha, mask, w), perm = _case(6, nk=12)
    t = _t(X, y, alpha, mask, w, perm)
    ops.local_sdca_block(t[0], t[1], t[2], t[3], t[4], t[5], gl("hinge"),
                         1e-2, 24, 2.0, 24)
    assert ops.LAST_DENSE_CONFIG == dict(form="plain", block_rows=8,
                                         cluster=None, n_passes=2)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with `python -m "
                    "pytest -m cuda tests/test_torch_dense_cluster.py`")
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32])
def test_cuda_kernel_at_every_window_and_cluster(card, B, C):
    """Kernel vs plain at a forced cluster (rtol 1e-4, atol 1e-5: the
    partials sum in another order than torch.sum): K = 3, nk = 203 (a
    multiple of no window but 1), two passes, d = 2,000 (bulk copies),
    2,001 (4-byte copies) and 54 (slices past d at C = 16); masked rows
    stay 0; the plan that ran is recorded."""
    for d in (2_000, 2_001, 54):
        (X, y, alpha, mask, w), perm = _case(6 + B + C, Kw=3, nk=203, d=d)
        args = [a.to(card) for a in _t(X, y, alpha, mask, w)]
        p = torch.from_numpy(perm).to(card)
        for loss_name in CLOSED_FORM:
            kw = dict(loss=get_loss(loss_name), n_passes=2)
            before = dk.LAUNCHES
            got = dk.local_sdca(*args, 0.3, p, block_rows=B, cluster=C, **kw)
            assert dk.LAUNCHES == before + 1
            assert dk.LAST_DENSE_CONFIG["cluster"] == C
            want = dk.local_sdca_plain(*args, 0.3, p, **kw)
            for g, r in zip(got, want):
                torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)
            assert bool((got[0][:, [2, 202]] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("C,B", [(2, 8), (8, 8), (16, 8), (16, 2)])
def test_cuda_kernel_past_one_blocks_width(card, C, B):
    """d = 65,536: past what one block holds (56,9xx at B = 8); the slices
    fit, in column tiles where C is small."""
    (X, y, alpha, mask, w), perm = _case(40 + C, Kw=2, nk=19, d=65_536)
    args = [a.to(card) for a in _t(X, y, alpha, mask, w)]
    p = torch.from_numpy(perm).to(card)
    kw = dict(loss=get_loss("squared"), n_passes=3)
    got = dk.local_sdca(*args, 0.3, p, block_rows=B, cluster=C, **kw)
    want = dk.local_sdca_plain(*args, 0.3, p, **kw)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="232448 bytes"):
        dk.local_sdca(*args, 0.3, p, block_rows=B, cluster=1, **kw)


@pytest.mark.cuda
def test_cuda_every_cluster_gives_the_same_bits_run_after_run(card):
    """The exchange sums in rank order, never in order of arrival: two
    launches at each C give the same bits."""
    (X, y, alpha, mask, w), perm = _case(50, Kw=4, nk=400, d=2_000)
    args = [a.to(card) for a in _t(X, y, alpha, mask, w)]
    p = torch.from_numpy(perm).to(card)
    for C in (2, 8, 16):
        first = dk.local_sdca(*args, 0.3, p, loss=get_loss("hinge"),
                              cluster=C)
        again = dk.local_sdca(*args, 0.3, p, loss=get_loss("hinge"),
                              cluster=C)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
