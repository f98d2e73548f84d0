"""Dense feature sharding (M > 1) and `reshard_w_state` against the
reference.

The dense (data=K, model=M) mesh on one card runs the eager `sdca` with
its partial dots summed over the M slices each step: held to the
reference's 2-D `solve` on a forced-host-device mesh in a child process
(`torch_parity.reference_in_child`, as tests/test_torch_mesh2d.py does
for the sparse mesh), with the reference's visit orders -- per-round
gaps within 1e-4 relative, w and alpha within 1e-6, the wire plan
equal. The solver itself is held to the reference's `local_sdca` with a
named model axis (`jax.vmap(..., axis_name="model")` stands in for the
mesh) step for step, and `reshard_w_state` to the reference's on the
same arrays. The `cuda` test holds the dense mesh on the card to the
CPU's (`python -m pytest -m cuda tests/test_torch_mesh_dense.py`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import comm as ref_comm
from repro.core.cocoa import (CoCoAState as RefState,
                              reshard_w_state as ref_reshard)
from repro.core.losses import get_loss as ref_get_loss
from repro.core.regularizers import get_regularizer as ref_get_reg
from repro.core.solvers import local_sdca as ref_local_sdca
from repro_torch import comm
from repro_torch.core import CoCoAConfig, cocoa, solve
from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.core.solvers import local_sdca, per_step_model_hops
from repro_torch.data import load, partition
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh

import torch_parity as tp

K, ROUNDS, H, SEED = 2, 3, 64, 2
KW = dict(loss="hinge", lam=1e-3, H=H, solver="sdca", backend="shard_map",
          model_axis="model")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    X, y = load("tiny")
    return partition(X, y, K, seed=0, device="cpu")


def _reference_2d(M):
    """The reference's dense 2-D solve on tiny, (K, M) mesh, in a child
    with K M forced host devices."""
    return tp.reference_in_child(f"""
        import jax
        from repro.core import CoCoAConfig, solve
        from repro.data import load, partition
        X, y = load("tiny")
        Xp, yp, mk = partition(X, y, {K}, seed=0)
        # Auto axes: jax 0.9's default Explicit axes break the certificate
        mesh = jax.make_mesh(({K}, {M}), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        r = solve(CoCoAConfig.adding({K}, **{KW!r}), Xp, yp, mk,
                  rounds={ROUNDS}, gap_every=1, seed={SEED}, mesh=mesh)
        out["gap"] = np.asarray(r.history["gap"])
        out["floats"] = np.asarray(r.history["comm_floats"])
        out["w"] = np.asarray(r.state.w)
        out["alpha"] = np.asarray(r.state.alpha)
    """, devices=K * M)


@pytest.mark.parametrize("M", [2, 3])
def test_dense_mesh_matches_reference_2d_solve(tiny, M):
    """M = 2 divides d = 64; M = 3 pads it to 66 columns, and the padded
    coordinates of w stay exactly zero."""
    ref = _reference_2d(M)
    X, y, mask = tiny
    nk = y.shape[1]
    hook = tp.reference_visit_orders(SEED, ROUNDS, K, nk, H, "draws")
    r = solve(CoCoAConfig.adding(K, **KW), X, y, mask, rounds=ROUNDS,
              seed=SEED, visit_orders=hook,
              mesh=make_test_mesh((K, M), device="cpu"))
    np.testing.assert_allclose(r.history["gap"], ref["gap"], rtol=1e-4)
    assert r.history["comm_floats"] == list(ref["floats"])
    d_pad = M * -(-64 // M)
    assert r.state.w.shape == (d_pad,) and ref["w"].shape == (d_pad,)
    assert float(r.state.w[64:].abs().sum()) == 0.0
    np.testing.assert_allclose(r.state.w.numpy(), ref["w"], atol=1e-6)
    np.testing.assert_allclose(r.state.alpha.numpy(), ref["alpha"],
                               atol=1e-6)


def test_dense_mesh_m1_is_the_vmap_run(tiny):
    """At M = 1 the mesh round is the simulated round on the same
    tensors, bit for bit."""
    X, y, mask = tiny
    kw = {k: v for k, v in KW.items() if k not in ("backend", "model_axis")}
    a = solve(CoCoAConfig.adding(K, **kw), X, y, mask, rounds=2, seed=3)
    b = solve(CoCoAConfig.adding(K, backend="shard_map", **kw), X, y, mask,
              rounds=2, seed=3, mesh=make_test_mesh((K,), ("data",),
                                                    device="cpu"))
    assert torch.equal(a.state.w, b.state.w)
    assert a.history["gap"] == b.history["gap"]


# ----------------------------------------------------------------------------
# the solver with a model axis, step for step
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("loss_name,reg_spec", [("hinge", "l2"),
                                                ("squared", "elastic:0.5")])
@pytest.mark.parametrize("steps", [1, 5, 64])
def test_model_axis_sdca_matches_reference(loss_name, reg_spec, steps):
    rng = np.random.default_rng(7)
    M, nk, d_loc = 3, 40, 11
    Xg, y, alpha, mask = tp.dense_block(rng, 1, nk, M * d_loc, pad_rows=3)
    v = (0.1 * rng.standard_normal(M * d_loc)).astype(np.float32)
    sq = (np.sum(Xg * Xg, -1) * mask).astype(np.float32)
    lam, n, sigma_p = 1e-2, 40.0, 3.0
    key = jax.random.PRNGKey(11)
    idxs = np.array(jax.random.randint(key, (steps,), 0, nk))
    ref_loss, ref_reg = ref_get_loss(loss_name), ref_get_reg(reg_spec)
    Xm = Xg[0].reshape(nk, M, d_loc).transpose(1, 0, 2)
    run = jax.vmap(lambda Xk, vk: ref_local_sdca(
        Xk, jnp.asarray(y[0]), jnp.asarray(alpha[0]), jnp.asarray(mask[0]),
        vk, key, ref_loss, lam, n, sigma_p, steps, sqnorms=jnp.asarray(sq[0]),
        model_axis="model", reg=ref_reg), axis_name="model")
    want = run(jnp.asarray(Xm), jnp.asarray(v.reshape(M, d_loc)))
    got = local_sdca(torch.from_numpy(Xg).view(1, nk, M, d_loc),
                     torch.from_numpy(y), torch.from_numpy(alpha),
                     torch.from_numpy(mask), torch.from_numpy(v),
                     torch.from_numpy(idxs[None]), get_loss(loss_name), lam,
                     n, sigma_p, steps, reg=get_regularizer(reg_spec),
                     sqnorms=torch.from_numpy(sq), model_axis="model")
    for m in range(1, M):      # every shard took the same decisions
        np.testing.assert_array_equal(np.asarray(want.dalpha[m]),
                                      np.asarray(want.dalpha[0]))
    np.testing.assert_allclose(got.dalpha[0].numpy(),
                               np.asarray(want.dalpha[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.du[0].numpy(),
                               np.asarray(want.du).reshape(-1), rtol=1e-5,
                               atol=1e-6)


def test_model_axis_sdca_needs_global_sqnorms():
    X = torch.zeros(1, 4, 2, 3)
    with pytest.raises(ValueError, match="global sqnorms"):
        local_sdca(X, torch.ones(1, 4), torch.zeros(1, 4), torch.ones(1, 4),
                   torch.zeros(6), torch.zeros(1, 2, dtype=torch.long),
                   get_loss("hinge"), 1e-3, 4.0, 1.0, 2, model_axis="model")


def test_dense_kernel_keeps_the_references_refusal(tiny):
    X, y, mask = tiny
    with pytest.raises(ValueError, match="cannot run feature-sharded"):
        solve(CoCoAConfig.adding(K, **{**KW, "solver": "sdca_kernel"}), X,
              y, mask, rounds=1, mesh=make_test_mesh((K, 2), device="cpu"))
    with pytest.raises(NotImplementedError, match="no model-axis"):
        ops.local_sdca_block(X, y, torch.zeros_like(y), mask,
                             torch.zeros(64), torch.zeros(K, 512),
                             get_loss("hinge"), 1e-3, 1024.0, 2.0, 8,
                             model_axis="model")


# ----------------------------------------------------------------------------
# the model hop, the column slicing and reshard_w_state
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("M", [2, 3])
def test_model_hop_floats(tiny, M):
    """comm_floats a round: K d_local for the reduce plus K M H partial
    dots, priced as the reference's `model_hops`."""
    X, y, mask = tiny
    r = solve(CoCoAConfig.adding(K, **KW), X, y, mask, rounds=2,
              mesh=make_test_mesh((K, M), device="cpu"))
    d_loc = -(-64 // M)
    per_round = K * d_loc + K * M * H
    assert r.history["comm_floats"] == [per_round, 2 * per_round]
    want = ref_comm.model_hops(ref_comm.WSpec(64, M, "model"), K, H)
    got = per_step_model_hops(X, H, K=K, M=M)
    assert [(h.name, h.messages, h.floats_per_message, h.axis)
            for h in got] == [(h.name, h.messages, h.floats_per_message,
                               h.axis) for h in want]


@pytest.mark.parametrize("d,M", [(64, 2), (64, 3), (10, 4), (5, 4)])
def test_column_slices_match_the_references_padding(d, M):
    X = np.random.default_rng(d * M).standard_normal((2, 3, d)).astype(
        np.float32)
    ws = comm.WSpec(d, M, "model")
    want = np.asarray(jnp.pad(jnp.asarray(X),
                              ((0, 0), (0, 0), (0, ws.d_padded - d))))
    padded = ws.pad_cols(torch.from_numpy(X))
    np.testing.assert_array_equal(padded.numpy(), want)
    got = torch.cat([ws.slice_cols(torch.from_numpy(X), m)
                     for m in range(M)], dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ws.pad_cols(padded) is padded


@pytest.mark.parametrize("d,old_M,new_M", [(10, 1, 4), (10, 4, 2),
                                           (47, 3, 1), (9, 2, 3)])
def test_reshard_w_state_matches_reference(d, old_M, new_M):
    rng = np.random.default_rng(d + old_M)
    old_r = ref_comm.WSpec(d, old_M, "model" if old_M > 1 else None)
    new_r = ref_comm.WSpec(d, new_M, "model" if new_M > 1 else None)
    old_t = comm.WSpec(d, old_M, "model" if old_M > 1 else None)
    new_t = comm.WSpec(d, new_M, "model" if new_M > 1 else None)
    w = np.zeros(old_r.d_padded, np.float32)
    w[:d] = rng.standard_normal(d)
    ef = rng.standard_normal((3, old_r.d_padded)).astype(np.float32)
    ef[:, d:] = 0.0
    alpha = rng.standard_normal((3, 5)).astype(np.float32)
    params = (0.5, 6.0)
    ref = ref_reshard(RefState(jnp.asarray(w), jnp.asarray(alpha),
                               jax.random.PRNGKey(0), jnp.zeros((), jnp.int32),
                               jnp.asarray(alpha), jnp.asarray(ef)),
                      old_r, new_r, ref_comm.AggParams(*params))
    st = cocoa.init_state(old_t.d_padded, 3, 5, device="cpu")._replace(
        w=torch.from_numpy(w), alpha=torch.from_numpy(alpha),
        ef=torch.from_numpy(ef))
    got = cocoa.reshard_w_state(st, old_t, new_t, comm.AggParams(*params))
    assert got.w.shape == (new_t.d_padded,)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=1e-6,
                               atol=1e-7)
    assert got.ef.shape == (3, new_t.d_padded) and not got.ef.any()
    assert np.asarray(ref.ef).shape == tuple(got.ef.shape)
    assert torch.equal(got.alpha, st.alpha)
    with pytest.raises(ValueError, match="feature count"):
        cocoa.reshard_w_state(st, old_t, comm.WSpec(d + 1), comm.AggParams(
            *params))


@pytest.fixture
def card():
    """A CUDA device, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_mesh_dense.py`")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 3])
def test_cuda_dense_mesh_matches_cpu(tiny, card, M):
    X, y, mask = tiny
    gaps = {}
    for where, data in (("cpu", tiny), ("cuda", (X.to(card), y.to(card),
                                                 mask.to(card)))):
        r = solve(CoCoAConfig.adding(K, **KW), *data, rounds=ROUNDS,
                  seed=SEED, mesh=make_test_mesh((K, M), device=data[0].device))
        gaps[where] = r.history["gap"]
    np.testing.assert_allclose(gaps["cuda"], gaps["cpu"], rtol=1e-5)
