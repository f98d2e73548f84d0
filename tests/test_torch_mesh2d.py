"""The port's feature-sharded (data=K, model=M) path against the reference's.

`WSpec`, `FeatureShards` and the certificate are held to the reference on
the same numpy data (arrays equal, sums within float32 rounding); the
z-exchange plain version to `sparse_local_sdca_zx` in interpret mode, at
M = 1 and at M = 2 through `jax.vmap(..., axis_name="model")` (interpret
mode takes the named axis); the 2-D `solve` to the reference's on a (2, 2)
mesh of forced host devices, run in a child process
(`torch_parity.reference_in_child`) with the same visit orders.

The `cuda` tests hold the zx kernel (one launch a round, a cluster of M
blocks per worker) against its plain version on the card, with u in
shared memory and in device memory, and at M = 17 its per-block form;
run them there with `python -m pytest -q -m cuda tests/test_torch_mesh2d.py`.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import comm as ref_comm
from repro.core import duality as ref_duality
from repro.core.losses import get_loss as ref_get_loss
from repro.data import sparse as ref_sp
from repro.kernels.sparse_sdca import sparse_local_sdca_zx as ref_zx
from repro_torch import comm
from repro_torch.core import CoCoAConfig, cocoa, duality, solve
from repro_torch.core.losses import get_loss
from repro_torch.core.solvers import local_sdca_sparse
from repro_torch.data import load, partition, partition_sparse
from repro_torch.data import sparse as sp
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_sdca as sk
from repro_torch.launch.mesh import make_test_mesh

import torch_parity as tp

CLOSED_FORM = ["hinge", "smooth_hinge", "squared", "absolute"]


def _toy(n=96, d=37, K=3, density=0.2, seed=0, M=1):
    csr, y = ref_sp.make_sparse_classification(n, d, density=density,
                                                seed=seed)
    return (ref_sp.partition_sparse(csr, y, K, seed=seed, M=M),
            partition_sparse(csr, y, K, seed=seed, M=M, device="cpu"))


# ----------------------------------------------------------------------------
# WSpec (tests/test_mesh2d.py:29-80)
# ----------------------------------------------------------------------------

def test_wspec_geometry():
    for d, M in ((10, 4), (10, 1), (100, 3), (47_236, 2)):
        axis = "model" if M > 1 else None
        ws, rs = comm.WSpec(d, M, axis), ref_comm.WSpec(d, M, axis)
        assert (ws.sharded, ws.d_local, ws.d_padded) == (
            rs.sharded, rs.d_local, rs.d_padded)
        for m in range(M):
            assert ws.shard_offset(m) == rs.shard_offset(m)
            assert ws.shard_bounds(m) == rs.shard_bounds(m)
        assert ws.spec() == (axis if M > 1 else None)
    ws = comm.WSpec(d=10, M=4, model_axis="model")
    assert ws.shard_bounds(3) == (9, 10)          # the last shard is ragged


def test_wspec_column_map_roundtrip():
    ws = comm.WSpec(d=100, M=3, model_axis="m")
    rs = ref_comm.WSpec(d=100, M=3, model_axis="m")
    cols = torch.tensor([0, 33, 34, 67, 99])
    np.testing.assert_array_equal(
        ws.owner_of(cols).numpy(),
        np.asarray(rs.owner_of(jnp.asarray(cols.numpy()))))
    for m in range(3):
        local = ws.to_local(cols, m)
        np.testing.assert_array_equal(
            local.numpy(), np.asarray(rs.to_local(jnp.asarray(cols.numpy()),
                                                  m)))
        assert torch.equal(ws.to_global(local, m), cols)


def test_wspec_pad_unpad():
    ws = comm.WSpec(d=10, M=4, model_axis="model")
    w = torch.arange(10, dtype=torch.float32)
    wp = ws.pad_w(w)
    assert wp.shape == (12,) and float(wp[10:].abs().sum()) == 0.0
    assert torch.equal(ws.unpad_w(wp), w)
    assert ws.pad_w(wp) is wp
    assert ws.pad_w(np.zeros(10, np.float32)).shape == (12,)
    with pytest.raises(ValueError):
        ws.pad_w(torch.zeros(11))
    with pytest.raises(ValueError):
        comm.WSpec(d=8, M=2)                      # sharded needs an axis
    with pytest.raises(ValueError):
        ws.unpad_w(torch.zeros(11))


def test_topology_from_mesh():
    mesh = make_test_mesh((4, 2), device="cpu")
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    topo = comm.Topology.from_mesh(mesh, "data", "model")
    assert (topo.K, topo.M) == (4, 2)
    assert topo.d_local(47_236) == 23_618
    assert topo.wspec(47_236).d_padded == 47_236
    assert comm.Topology.from_mesh(mesh, "data").M == 1
    hier = comm.Topology.from_mesh(mesh, "data", "model", topology="hier:2")
    assert (hier.reduce, hier.group, hier.M) == ("hier", 2, 2)
    with pytest.raises(ValueError, match="must divide K=4"):
        comm.Topology.from_mesh(mesh, "data", "model", topology="hier:3")
    with pytest.raises(ValueError, match="model axis"):
        comm.Topology.from_mesh(mesh, "data", "feat")
    with pytest.raises(ValueError):
        make_test_mesh((2, 2), ("data",), device="cpu")


# ----------------------------------------------------------------------------
# FeatureShards: arrays equal to the reference's
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 2, 3, 4])
def test_shard_features_equal_to_reference(M):
    (rsh, _, _), (sh, _, _) = _toy()
    rfs, fs = ref_sp.shard_features(rsh, M), sp.shard_features(sh, M)
    assert (fs.d, fs.M, fs.d_local, fs.r_loc) == (rfs.d, rfs.M, rfs.d_local,
                                                  rfs.r_loc)
    for name in ("cols", "vals", "nnz"):
        np.testing.assert_array_equal(getattr(fs, name).numpy(),
                                      np.asarray(getattr(rfs, name)))
    np.testing.assert_array_equal(sp.densify(fs).numpy(),
                                  np.asarray(ref_sp.densify(rfs)))


def test_partition_sparse_model_axis_equal_to_reference():
    (rfs, ry, rm), (fs, y, mk) = _toy(n=64, d=40, K=4, M=2, seed=3)
    assert isinstance(fs, sp.FeatureShards)
    for got, want in ((fs.cols, rfs.cols), (fs.vals, rfs.vals),
                      (fs.nnz, rfs.nnz), (y, ry), (mk, rm)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (_, y1, m1) = partition_sparse(*ref_sp.make_sparse_classification(
        64, 40, density=0.2, seed=3), 4, seed=3, device="cpu")
    assert torch.equal(y1, y) and torch.equal(m1, mk)   # rows M-invariant


def test_feature_shards_matvec_family_matches_reference():
    """float32 sums in another order than XLA's: rtol 1e-5, atol 1e-6."""
    (rsh, ry, rm), (sh, y, mk) = _toy()
    rfs, fs = ref_sp.shard_features(rsh, 3), sp.shard_features(sh, 3)
    rng = np.random.default_rng(1)
    w = rng.standard_normal(fs.d_padded).astype(np.float32)
    coef = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    np.testing.assert_allclose(
        sp.matvec(fs, torch.from_numpy(w)).numpy(),
        np.asarray(ref_sp.matvec(rfs, jnp.asarray(w))), rtol=1e-5, atol=1e-6)
    out = sp.rmatvec(fs, torch.from_numpy(coef)).numpy()
    np.testing.assert_allclose(out, np.asarray(
        ref_sp.rmatvec(rfs, jnp.asarray(coef))), rtol=1e-5, atol=1e-6)
    assert np.all(out[sh.d:] == 0)                # padding never populated
    np.testing.assert_allclose(sp.row_sqnorms(fs).numpy(),
                               np.asarray(ref_sp.row_sqnorms(rfs)),
                               rtol=1e-6)
    np.testing.assert_allclose(sp.matvec(fs, torch.from_numpy(w)).numpy(),
                               sp.matvec(sh, torch.from_numpy(w[:sh.d]))
                               .numpy(), rtol=1e-5, atol=1e-6)


def test_certificate_on_feature_shards_matches_reference():
    """P, D and the gap at dual-feasible hinge duals: float64 sums of
    float32 terms, within 1e-6."""
    (rsh, ry, rm), (sh, y, mk) = _toy()
    rfs, fs = ref_sp.shard_features(rsh, 3), sp.shard_features(sh, 3)
    rng = np.random.default_rng(2)
    alpha = (y.numpy() * rng.random(tuple(y.shape)) * mk.numpy()
             ).astype(np.float32)
    rp, rd, rg = ref_duality.gap_decomposed(jnp.asarray(alpha), rfs, ry, rm,
                                            ref_get_loss("hinge"), 1e-3)
    p, d, g = duality.gap_decomposed(torch.from_numpy(alpha), fs, y, mk,
                                     get_loss("hinge"), 1e-3)
    for got, want in ((p, rp), (d, rd), (g, rg)):
        assert abs(float(got) - float(want)) < 1e-6
    p1, d1, g1 = duality.gap_decomposed(torch.from_numpy(alpha), sh, y, mk,
                                        get_loss("hinge"), 1e-3)
    assert abs(float(g1) - float(g)) < 1e-6
    v = duality.v_of_alpha(fs, torch.from_numpy(alpha), 1e-3,
                           duality.effective_n(mk))
    assert v.shape == (fs.d_padded,) and float(v[sh.d:].abs().sum()) == 0.0


# ----------------------------------------------------------------------------
# the z-exchange schedule's plain version against the reference's kernel
# ----------------------------------------------------------------------------

def _zx_inputs(rng, K, M, nk, d_loc, r_loc):
    """(cols, vals) (K, M, nk, r_loc) with shard-local ids, rows with
    duplicate ids and ragged lengths, plus y, alpha, mask, w (M d_loc,),
    the global sqnorms and the visit perm."""
    cols, vals, _ = tp.ell_block(rng, K * M, nk, d_loc, r_loc)
    cols = cols.reshape(K, M, nk, r_loc)
    vals = (vals.reshape(K, M, nk, r_loc) / np.sqrt(M)).astype(np.float32)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    mask[:, -2:] = 0.0
    alpha[:, -2:] = 0.0
    w = (0.3 * rng.standard_normal(M * d_loc)).astype(np.float32)
    sq = np.sum(vals * vals, axis=(1, 3)).astype(np.float32)
    perm = np.stack([rng.permutation(nk) for _ in range(K)]).astype(np.int32)
    return cols, vals, y, alpha, mask, w, sq, perm


def _ref_zx(cols, vals, y, alpha, mask, w, sq, perm, scale, loss_name, B,
            n_passes, kappa):
    """The reference's zx for each worker: rows in visit order, padded to a
    multiple of B with masked zero rows (as repro.kernels.ops does), the M
    shards through jax.vmap with axis_name="model" when M > 1."""
    K, M, nk, r = cols.shape
    d_loc = w.shape[0] // M
    pad = (-nk) % B
    loss = ref_get_loss(loss_name)
    das, dus = [], []
    for k in range(K):
        p = perm[k]
        padr = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        c = np.stack([padr(cols[k, m][p]) for m in range(M)])
        v = np.stack([padr(vals[k, m][p]) for m in range(M)])
        args = [jnp.asarray(padr(a[k][p])) for a in (y, alpha, mask)]
        sqp = jnp.asarray(padr(sq[k][p]))
        kw = dict(loss=loss, n_passes=n_passes, block_rows=B,
                  prox_kappa=kappa, interpret=True)
        if M == 1:
            da_p, du = ref_zx(jnp.asarray(c[0]), jnp.asarray(v[0]), *args,
                              jnp.asarray(w), scale, sqp, **kw)
            du = np.asarray(du)[None]
            da_p = np.asarray(da_p)
        else:
            f = jax.vmap(lambda cm, vm, wm: ref_zx(
                cm, vm, *args, wm, scale, sqp, model_axis="model", **kw),
                axis_name="model")
            da_m, du = f(jnp.asarray(c), jnp.asarray(v),
                         jnp.asarray(w.reshape(M, d_loc)))
            da_m, du = np.asarray(da_m), np.asarray(du)
            np.testing.assert_array_equal(da_m[0], da_m[1])   # replicated
            da_p = da_m[0]
        da = np.zeros(nk, np.float32)
        da[p] = da_p[:nk]
        das.append(da)
        dus.append(du.reshape(M * d_loc))
    return np.stack(das), np.stack(dus)


ZX_CASES = [  # (loss, kappa, B, n_passes, M); nk = 37 leaves B = 4, 16 ragged
    ("hinge", None, 1, 1, 1), ("hinge", 0.3, 4, 2, 1),
    ("smooth_hinge", None, 16, 1, 1), ("smooth_hinge", 0.3, 1, 2, 1),
    ("squared", None, 4, 1, 1), ("squared", 0.3, 16, 2, 1),
    ("absolute", None, 16, 2, 1), ("absolute", 0.3, 4, 1, 1),
    ("hinge", None, 4, 2, 2), ("smooth_hinge", 0.3, 16, 1, 2),
    ("squared", None, 1, 1, 2),
]


@pytest.mark.parametrize("loss_name,kappa,B,n_passes,M", ZX_CASES)
def test_zx_plain_matches_reference_kernel(loss_name, kappa, B, n_passes, M):
    """Tolerance rtol 1e-5, atol 1e-6: the partial dots are float32 sums
    in another order than the reference's ascending-slot loop."""
    rng = np.random.default_rng(11)
    K, nk, d_loc, r = 2, 37, 24, 6
    ins = _zx_inputs(rng, K, M, nk, d_loc, r)
    scale = 0.4
    want = _ref_zx(*ins, scale, loss_name, B, n_passes, kappa)
    cols, vals, y, alpha, mask, w, sq, perm = (torch.from_numpy(a)
                                               for a in ins)
    got = sk.sparse_local_sdca_zx(cols, vals, y, alpha, mask, w, scale, sq,
                                  perm, loss=get_loss(loss_name),
                                  n_passes=n_passes, block_rows=B,
                                  prox_kappa=kappa)
    for g, r_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r_, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kappa", [None, 0.3])
def test_zx_block1_single_shard_is_sequential_sdca(kappa):
    """At B = 1, M = 1 the schedule is the 1-D walk: equal to the 1-D
    plain version within rtol 1e-6 (q from sqnorms vs the row's own sum)."""
    rng = np.random.default_rng(4)
    K, nk, d, r = 3, 40, 30, 5
    cols, vals, y, alpha, mask, w, sq, perm = (
        torch.from_numpy(a) for a in _zx_inputs(rng, K, 1, nk, d, r))
    loss = get_loss("smooth_hinge")
    got = sk.sparse_local_sdca_zx(cols, vals, y, alpha, mask, w, 0.6, sq,
                                  perm, loss=loss, n_passes=2, block_rows=1,
                                  prox_kappa=kappa)
    want = sk.sparse_local_sdca_plain(cols[:, 0], vals[:, 0], y, alpha, mask,
                                      w, 0.6, perm, loss=loss, n_passes=2,
                                      prox_kappa=kappa)
    for g, r_ in zip(got, want):
        torch.testing.assert_close(g, r_, rtol=1e-6, atol=1e-7)


def test_zx_exchanges_and_plan():
    assert sk.zx_exchanges(128, 16) == 9
    assert sk.zx_exchanges(128, 16, n_passes=3) == 25
    assert sk.zx_exchanges(130, 16) == 10              # ragged last block
    plan = ops.sparse_zx_plan(169_350, 23_618, 169_350, r_max=70,
                              model_shards=2, backend="cpu")
    assert plan == dict(block_rows=16, n_passes=1, blocks=10_585,
                        exchanges=10_586)
    assert ops.sparse_zx_plan(5, 10, 5, r_max=3, model_shards=2,
                              backend="cpu")["block_rows"] == 8


def test_zx_dispatch_rules():
    """The reference's rules: model_axis with zx=False raises; zx=True
    forces the schedule at M = 1 (equal to the depth-1 walk at B = 1)."""
    rng = np.random.default_rng(5)
    K, nk, d = 2, 20, 16
    cols, vals, _ = tp.ell_block(rng, K, nk, d, 4)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    z = np.zeros((K, nk), np.float32)
    shard = types.SimpleNamespace(cols=torch.from_numpy(cols),
                                  vals=torch.from_numpy(vals))
    perm = torch.stack([torch.randperm(nk) for _ in range(K)])
    args = (shard, torch.from_numpy(y), torch.from_numpy(z),
            torch.ones(K, nk), torch.zeros(d), perm, get_loss("hinge"),
            1e-2, 40.0, 2.0, nk)
    with pytest.raises(ValueError, match="zx=False"):
        ops.sparse_local_sdca_block(*args, model_axis="model", zx=False)
    got = ops.sparse_local_sdca_block(*args, zx=True, block_rows=1)
    assert ops.LAST_SPARSE_CONFIG["zx"] is True
    assert ops.LAST_SPARSE_CONFIG["model_shards"] == 1
    want = ops.sparse_local_sdca_block(*args)
    assert ops.LAST_SPARSE_CONFIG["zx"] is False
    torch.testing.assert_close(got.dalpha, want.dalpha, rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(got.du, want.du, rtol=1e-6, atol=1e-7)


def test_feature_sharded_guards():
    with pytest.raises(ValueError, match="feature-sharded"):
        cocoa.resolve_solver("sdca_kernel", sparse=False,
                             feature_sharded=True)
    assert cocoa.resolve_solver("sdca_kernel", sparse=True,
                                feature_sharded=True) == "sdca_sparse_kernel"
    assert cocoa.resolve_solver("sdca", sparse=True,
                                feature_sharded=True) == "sdca_sparse"
    (_, _, _), (fs, y, mk) = _toy(M=2)
    with pytest.raises(ValueError, match="global sqnorms"):
        local_sdca_sparse(fs, y, torch.zeros_like(y), mk,
                          torch.zeros(fs.d_padded), torch.zeros(3, 4),
                          get_loss("hinge"), 1e-3, 96.0, 3.0, 4,
                          model_axis="model")
    kw = dict(loss="hinge", H=8, lam=1e-3)
    with pytest.raises(ValueError, match="shard_map"):
        solve(CoCoAConfig.adding(3, **kw), fs, y, mk, rounds=1)
    shard_map = dict(backend="shard_map", model_axis="model", **kw)
    with pytest.raises(ValueError, match="needs a mesh"):
        solve(CoCoAConfig.adding(3, **shard_map), fs, y, mk, rounds=1)
    with pytest.raises(ValueError, match="M=2 but"):
        solve(CoCoAConfig.adding(3, **shard_map), fs, y, mk, rounds=1,
              mesh=make_test_mesh((3, 3), device="cpu"))
    with pytest.raises(ValueError, match="K=3 workers"):
        solve(CoCoAConfig.adding(3, **shard_map), fs, y, mk, rounds=1,
              mesh=make_test_mesh((2, 2), device="cpu"))
    (_, _, _), (sh, y1, mk1) = _toy()
    with pytest.raises(ValueError, match="FeatureShards"):
        solve(CoCoAConfig.adding(3, **shard_map), sh, y1, mk1, rounds=1,
              mesh=make_test_mesh((3, 2), device="cpu"))
    # dense rows at M > 1 run on the eager solver; the dense kernel keeps
    # the reference's refusal
    X, yd = load("tiny")
    Xp, yp, mkp = partition(X, yd, 2, device="cpu")
    r = solve(CoCoAConfig.adding(2, **shard_map), Xp, yp, mkp, rounds=2,
              mesh=make_test_mesh((2, 2), device="cpu"))
    assert len(r.history["gap"]) == 2 and r.state.w.shape == (64,)
    assert r.history["gap"][1] < r.history["gap"][0]
    with pytest.raises(ValueError, match="cannot run feature-sharded"):
        solve(CoCoAConfig.adding(2, solver="sdca_kernel", **shard_map), Xp,
              yp, mkp, rounds=1, mesh=make_test_mesh((2, 2), device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        solve(CoCoAConfig.adding(3, backend="pmap", **kw), sh, y1, mk1,
              rounds=1)


# ----------------------------------------------------------------------------
# the 2-D solve against the reference's on a (2, 2) mesh
# ----------------------------------------------------------------------------

K2, M2, ROUNDS = 2, 2, 4
REF_KW = dict(loss="hinge", lam=1e-3, H=128, backend="shard_map",
              model_axis="model")


@pytest.fixture(scope="module")
def ref2d():
    """The reference's 2-D solves on tiny_sparse, (2, 2) mesh, seed 2:
    the eager `sdca` and the kernel `sdca_kernel` (its zx schedule), plus
    the 1-D vmap run the reference's own parity test holds them to."""
    return tp.reference_in_child(f"""
        import jax
        from repro.core import CoCoAConfig, solve
        from repro.data import load
        from repro.data.sparse import partition_sparse
        csr, y = load("tiny_sparse")
        fs, yp, mk = partition_sparse(csr, y, {K2}, seed=0, M={M2})
        # Auto axes, the reference's meshes' semantics: jax 0.9 makes
        # Explicit ones by default, and its certificate's scatter then
        # cannot resolve an output sharding
        mesh = jax.make_mesh(({K2}, {M2}), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        kw = {REF_KW!r}
        for solver in ("sdca", "sdca_kernel"):
            r = solve(CoCoAConfig.adding({K2}, solver=solver, **kw), fs, yp,
                      mk, rounds={ROUNDS}, gap_every=1, seed=2, mesh=mesh)
            out[solver + "_gap"] = np.asarray(r.history["gap"])
            out[solver + "_floats"] = np.asarray(r.history["comm_floats"])
            out[solver + "_w"] = np.asarray(r.state.w)
            out[solver + "_alpha"] = np.asarray(r.state.alpha)
    """)


@pytest.fixture(scope="module")
def tiny2d():
    csr, y = load("tiny_sparse")
    return partition_sparse(csr, y, K2, seed=0, M=M2, device="cpu")


@pytest.mark.parametrize("solver,kind", [("sdca", "draws"),
                                         ("sdca_kernel", "permutation")])
def test_2d_solve_matches_reference(ref2d, tiny2d, solver, kind):
    """Per-round gaps within 1e-4 relative (tests/test_torch_cocoa.py's
    bar); the eager path's w and alpha within 1e-6; the wire plan equal."""
    fs, y, mk = tiny2d
    nk = y.shape[1]
    hook = tp.reference_visit_orders(2, ROUNDS, K2, nk, REF_KW["H"], kind)
    r = solve(CoCoAConfig.adding(K2, solver=solver, **REF_KW), fs, y, mk,
              rounds=ROUNDS, seed=2, visit_orders=hook,
              mesh=make_test_mesh((K2, M2), device="cpu"))
    np.testing.assert_allclose(r.history["gap"], ref2d[solver + "_gap"],
                               rtol=1e-4)
    assert r.history["comm_floats"] == list(ref2d[solver + "_floats"])
    assert float(r.state.w[fs.d:].abs().sum()) == 0.0
    if solver == "sdca":
        np.testing.assert_allclose(r.state.w.numpy(), ref2d["sdca_w"],
                                   atol=1e-6)
        np.testing.assert_allclose(r.state.alpha.numpy(),
                                   ref2d["sdca_alpha"], atol=1e-6)
    else:
        assert ops.LAST_SPARSE_CONFIG["zx"] is True
        assert ops.LAST_SPARSE_CONFIG["model_shards"] == 2


def test_2d_kernel_path_gap_matches_eager_path():
    """tests/test_mesh2d.py:747-782 on the port: after 40 rounds the zx
    kernel path's certified gap lies within 1e-5 of the eager path's (the
    schedule's stale z is a Theta knob, the gap the certificate), with the
    fused prox in the launch."""
    csr, y = sp.make_sparse_classification(256, 512, density=0.02, seed=0)
    sh, yp, mk = partition_sparse(csr, y, 2, seed=1, device="cpu")
    fs = sp.shard_features(sh, 2)
    mesh = make_test_mesh((2, 2), device="cpu")
    kw = dict(loss="smooth_hinge", lam=1e-3, H=256, reg="elastic:0.5",
              backend="shard_map", model_axis="model")
    gaps = {}
    for solver in ("sdca", "sdca_kernel"):
        r = solve(CoCoAConfig.adding(2, solver=solver, **kw), fs, yp, mk,
                  rounds=40, gap_every=40, seed=2, mesh=mesh)
        gaps[solver] = r.history["gap"][-1]
    cfg = ops.LAST_SPARSE_CONFIG
    assert cfg["zx"] is True and cfg["model_shards"] == 2
    assert cfg["prox_fused"] is True
    assert gaps["sdca_kernel"] >= -1e-7
    assert abs(gaps["sdca"] - gaps["sdca_kernel"]) < 1e-5, gaps


def test_2d_history_prices_the_model_hop(tiny2d):
    """comm_floats per round: K d_local for the reduce, plus K M exchanges
    block_rows on the kernel path (tests/test_mesh2d.py:785-820) or K M H
    on the eager one."""
    fs, y, mk = tiny2d
    nk, r_loc = y.shape[1], fs.r_loc
    mesh = make_test_mesh((K2, M2), device="cpu")
    plan = ops.sparse_zx_plan(nk, fs.d_local, 32, r_max=r_loc,
                              model_shards=M2, backend="cpu")
    assert plan["exchanges"] == plan["n_passes"] * plan["blocks"] + 1
    for solver, model in (("sdca_kernel", K2 * M2 * plan["exchanges"]
                           * plan["block_rows"]), ("sdca", K2 * M2 * 32)):
        r = solve(CoCoAConfig.adding(K2, solver=solver,
                                     **{**REF_KW, "H": 32}),
                  fs, y, mk, rounds=2, mesh=mesh)
        per_round = K2 * fs.d_local + model
        assert r.history["comm_floats"] == [per_round, 2 * per_round]


def test_model_axis_solver_must_price_its_hop():
    """`solve` prices the model hop through `LocalSolver.model_hop`, so a
    solver flagged `model_axis` without one is refused at registration."""
    from repro_torch.core.solvers import LocalSolver, register_solver
    with pytest.raises(ValueError, match="model_hop"):
        register_solver(LocalSolver("no_hop", local_sdca_sparse, dense=False,
                                    sparse=True, model_axis=True))


def test_2d_solve_computes_the_row_norms_once(tiny2d, monkeypatch):
    """The global row norms are fixed for a run: `solve` computes them
    once, not every round, and gives the rounds the same tensor."""
    fs, y, mk = tiny2d
    calls, seen = [], []
    real = cocoa.sparse_data.row_sqnorms
    monkeypatch.setattr(cocoa.sparse_data, "row_sqnorms",
                        lambda X: calls.append(1) or real(X))
    kernel = ops.sparse_local_sdca_block

    def spy(*a, sqnorms=None, **kw):
        seen.append(sqnorms)
        return kernel(*a, sqnorms=sqnorms, **kw)
    monkeypatch.setattr(ops, "sparse_local_sdca_block", spy)
    r = solve(CoCoAConfig.adding(K2, solver="sdca_kernel", **REF_KW), fs, y,
              mk, rounds=3, mesh=make_test_mesh((K2, M2), device="cpu"))
    assert len(r.history["gap"]) == 3
    assert len(calls) == 1 and len(seen) == 3
    assert seen[0] is seen[1] is seen[2]
    torch.testing.assert_close(seen[0], real(fs) * mk, rtol=0, atol=0)


def test_2d_m1_is_bit_for_bit_the_1d_backend():
    """M = 1 on the 2-D path runs the 1-D kernel on the same tensors."""
    csr, y = load("tiny_sparse")
    sh, yp, mk = partition_sparse(csr, y, 4, seed=0, device="cpu")
    fs1 = sp.shard_features(sh, 1)
    kw = dict(loss="hinge", lam=1e-3, H=128, solver="sdca_kernel")
    r1 = solve(CoCoAConfig.adding(4, **kw), sh, yp, mk, rounds=3, seed=1)
    r2 = solve(CoCoAConfig.adding(4, backend="shard_map", model_axis="model",
                                  **kw), fs1, yp, mk, rounds=3, seed=1,
               mesh=make_test_mesh((4, 1), device="cpu"))
    assert ops.LAST_SPARSE_CONFIG["zx"] is False
    assert torch.equal(r1.state.w, r2.state.w)
    assert torch.equal(r1.state.alpha, r2.state.alpha)
    assert torch.equal(r1.state.ef, r2.state.ef)
    assert r1.history["gap"] == r2.history["gap"]
    assert r1.history["comm_floats"] == r2.history["comm_floats"]


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_mesh2d.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("K,M,B,kappa,n_passes,nk", [
    (3, 1, 1, None, 2, 203), (3, 1, 16, 0.3, 2, 203),
    (3, 2, 16, None, 2, 203), (3, 2, 1, 0.3, 2, 203),
    (3, 4, 16, None, 3, 203), (3, 4, 5, 0.3, 2, 203),
    (3, 1, 1, None, 1, 203), (3, 2, 1, 0.3, 1, 203),    # one pass
    (3, 8, 16, 0.3, 2, 203), (3, 8, 1, None, 1, 203),
    (3, 8, 1, 0.3, 2, 203), (3, 4, 1, None, 3, 203),
    (3, 8, 128, None, 3, 203),               # nb = 2, the last block ragged
    (3, 4, 128, 0.3, 2, 203), (3, 2, 128, None, 2, 100),   # nb = 1
    (3, 2, 1, 0.3, 3, 3), (3, 4, 2, None, 3, 4),     # nb = 3, 2: dalpha
    (3, 2, 3, None, 3, 5), (3, 8, 3, 0.3, 3, 3),     # prefetched across
    (1, 4, 16, None, 2, 203), (1, 1, 1, 0.3, 1, 203)])     # one worker
def test_cuda_zx_kernel_matches_plain(card, K, M, B, kappa, n_passes, nk):
    """Kernel vs plain on the card, u in shared memory (tolerance rtol
    1e-4, atol 1e-5: warp reductions and shared-memory atomics reorder the
    float32 sums). One launch a round, its steps the schedule's
    invocations; the caller's w is left as it was (at K = 1 too)."""
    rng = np.random.default_rng(8)
    d_loc, r = 600, 24
    ins = [torch.from_numpy(a).to(card)
           for a in _zx_inputs(rng, K, M, nk, d_loc, r)]
    w0 = ins[5].clone()
    assert sk.zx_launch_plan(K, M, nk, d_loc, B, r_loc=r)["u_in_smem"]
    for loss_name in CLOSED_FORM:
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes, block_rows=B,
                  prox_kappa=kappa)
        before = (sk.ZX_LAUNCHES, sk.ZX_STEPS)
        got = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)
        assert (sk.ZX_LAUNCHES, sk.ZX_STEPS) == (
            before[0] + 1, before[1] + n_passes * (-(-nk // B)))
        torch.cuda.synchronize()
        assert torch.equal(ins[5], w0)
        want = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,kappa,n_passes", [(1, 16, None, 2),
                                                (1, 1, 0.3, 1),
                                                (2, 128, 0.3, 3)])
def test_cuda_zx_kernel_with_u_in_device_memory(card, M, B, kappa, n_passes):
    """d_loc = 65,536 (news_sparse's width at M = 1) does not fit shared
    memory beside the buffers: the instance with u in device memory, held
    to the plain version under the same tolerance."""
    rng = np.random.default_rng(9)
    K, nk, d_loc, r = 2, 203, 65_536, 24
    ins = [torch.from_numpy(a).to(card)
           for a in _zx_inputs(rng, K, M, nk, d_loc, r)]
    assert not sk.zx_launch_plan(K, M, nk, d_loc, B, r_loc=r)["u_in_smem"]
    for loss_name in ("hinge", "squared"):
        kw = dict(loss=get_loss(loss_name), n_passes=n_passes, block_rows=B,
                  prox_kappa=kappa)
        got = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)
        want = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_zx_cluster_limits_and_layout(card):
    """The library's shared-memory layout is `smem_budget`'s; M = 16 runs
    the cluster kernel where the card holds the cluster; M = 17, and a
    cluster the card cannot hold, run the grid form (one cooperative
    launch) where the card holds the K M blocks, else the per-block
    kernel, one launch an invocation; each against the plain version."""
    from repro_torch.kernels import build
    lib = build.load("sparse_sdca_zx")
    for B, r, d_loc in ((16, 70, 23_618), (1, 24, 600), (128, 24, 65_536)):
        plan = sk.zx_launch_plan(4, 2, 1_000, d_loc, B, r_loc=r)
        assert lib.sparse_sdca_zx_smem_bytes(
            B, r, d_loc, int(plan["u_in_smem"]), 2) == plan["smem_bytes"]
    rng = np.random.default_rng(10)
    for M in (16, 17):
        ins = [torch.from_numpy(a).to(card)
               for a in _zx_inputs(rng, 1, M, 40, 30, 4)]
        kw = dict(loss=get_loss("hinge"), block_rows=8)
        cluster = M <= 16 and sk._zx_clusters_fit(lib, M, 8, 4, 30, True) > 0
        grid = not cluster and sk._zx_grid_resident(lib, 8, 4, 30, True) >= M
        before = (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES, sk.ZX_BLOCK_LAUNCHES)
        got = sk.sparse_local_sdca_zx(*ins[:6], 0.5, *ins[6:], **kw)
        assert (sk.ZX_LAUNCHES, sk.ZX_GRID_LAUNCHES, sk.ZX_BLOCK_LAUNCHES) == (
            (before[0] + 1, before[1], before[2]) if cluster
            else (before[0], before[1] + 1, before[2]) if grid
            else (before[0], before[1], before[2] + 5))  # ceil(40 / 8) steps
        want = sk.sparse_local_sdca_zx_plain(*ins[:6], 0.5, *ins[6:], **kw)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)
