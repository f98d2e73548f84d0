"""The port's optimizers (`repro_torch.optim`) against `tests/test_optim.py`'s
contracts and against the reference on the same numpy inputs: AdamW with
float32 masters, CoCoA-DP rounds (adding, averaging, compressed, on 2 gloo
ranks), and the deprecated compress shim."""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import localdp as ref_localdp
from repro_torch.comm import compress as C
from repro_torch.launch.mesh import make_test_mesh, spawn_ranks
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.localdp import (LocalDPConfig, init_state,
                                       make_round_fn, make_round_sharded)

import torch_parity as tp


# ----------------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(16)
                              .astype(np.float32))
    params = {"w": torch.zeros(16)}
    opt = adamw_init(params)
    loss = lambda p: torch.sum((p["w"] - target) ** 2)
    for _ in range(300):
        w = params["w"].clone().requires_grad_()
        g, = torch.autograd.grad(loss({"w": w}), [w])
        params, opt, _ = adamw_update({"w": g}, opt, params, lr=3e-2,
                                      weight_decay=0.0)
    assert float(loss(params)) < 1e-2


def test_adamw_master_weights_dtype():
    params = {"w": torch.zeros(8, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt.master["w"].dtype == torch.float32
    g = {"w": torch.ones(8, dtype=torch.bfloat16)}
    params, opt, gn = adamw_update(g, opt, params)
    assert params["w"].dtype == torch.bfloat16
    assert float(gn) > 0
    assert int(opt.step) == 1


def test_adamw_masters_never_alias_float32_params():
    params = {"w": torch.ones(4)}
    opt = adamw_init(params)
    new, opt, _ = adamw_update({"w": torch.ones(4)}, opt, params)
    assert opt.master["w"].data_ptr() != params["w"].data_ptr()
    assert new["w"].data_ptr() != opt.master["w"].data_ptr()
    assert torch.equal(params["w"], torch.ones(4))


SHAPES = {"emb": ((24, 8), "bfloat16"), "w": ((8, 16), "float32"),
          "g": ((16,), "bfloat16"), "b": ((16,), "float32")}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_matches_reference(clip):
    """5 steps on a seeded tree of float32 and bfloat16 leaves, grads drawn
    with numpy each step (clip 1 clips every step, 100 never)."""
    rng = np.random.default_rng(11)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, (s, _) in SHAPES.items()}
    rp = {k: jnp.asarray(init[k], getattr(jnp, dt))
          for k, (_, dt) in SHAPES.items()}
    tp_ = {k: torch.from_numpy(init[k]).to(getattr(torch, dt))
           for k, (_, dt) in SHAPES.items()}
    ropt, topt = ref_adamw_init(rp), adamw_init(tp_)
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, (s, _) in SHAPES.items()}
        rg = {k: jnp.asarray(g[k], getattr(jnp, SHAPES[k][1])) for k in g}
        tg = {k: torch.from_numpy(g[k]).to(getattr(torch, SHAPES[k][1]))
              for k in g}
        rp, ropt, rn = ref_adamw_update(rg, ropt, rp, lr=1e-2,
                                        grad_clip=clip)
        tp_, topt, tn = adamw_update(tg, topt, tp_, lr=1e-2, grad_clip=clip)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    assert int(topt.step) == int(ropt.step) == 5
    for k in SHAPES:
        for leaf in ("master", "m", "v"):
            np.testing.assert_allclose(
                tp.to_np(getattr(topt, leaf)[k]),
                np.asarray(getattr(ropt, leaf)[k]), rtol=1e-6, atol=1e-7,
                err_msg=f"{leaf}[{k}]")
        got = tp.to_np(tp_[k].float())
        want = np.asarray(rp[k].astype(jnp.float32))
        assert tp_[k].dtype == getattr(torch, SHAPES[k][1])
        if SHAPES[k][1] == "bfloat16":
            assert np.all(np.abs(got - want) <= _bf16_ulp(want)), k
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------------
# CoCoA-DP
# ----------------------------------------------------------------------------

def _mlp_problem(K=4, seed=0):
    params, Xs, ys = tp.mlp_problem(K=K, seed=seed)
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            tp.mlp_loss, (torch.from_numpy(Xs), torch.from_numpy(ys)))


def _global_loss(loss_fn, params, batches):
    return float(np.mean([float(loss_fn(params, (batches[0][k],
                                                  batches[1][k])))
                          for k in range(batches[0].shape[0])]))


def test_localdp_adding_converges():
    params, loss_fn, batches = _mlp_problem()
    cfg = LocalDPConfig.adding(K=4, H=8, inner_lr=5e-2)
    rf = make_round_fn(loss_fn, cfg)
    st = init_state(params, cfg)
    l0 = _global_loss(loss_fn, st.params, batches)
    for _ in range(30):
        st = rf(st, batches)
    l1 = _global_loss(loss_fn, st.params, batches)
    assert np.isfinite(l1)
    assert l1 < 0.5 * l0
    assert int(st.rounds) == 30


def test_localdp_adding_at_least_matches_averaging():
    params, loss_fn, batches = _mlp_problem(seed=1)
    radd = make_round_fn(loss_fn, LocalDPConfig.adding(K=4, H=8,
                                                       inner_lr=5e-2))
    ravg = make_round_fn(loss_fn, LocalDPConfig.averaging(K=4, H=8,
                                                          inner_lr=5e-2))
    sa = init_state(params, LocalDPConfig.adding(K=4))
    sv = init_state(params, LocalDPConfig.averaging(K=4))
    for _ in range(25):
        sa, sv = radd(sa, batches), ravg(sv, batches)
    la = _global_loss(loss_fn, sa.params, batches)
    lv = _global_loss(loss_fn, sv.params, batches)
    assert la <= lv * 1.5          # adding must not blow up vs averaging


@pytest.mark.parametrize("method", ["int8", "topk:0.25"])
def test_compression_error_feedback_converges(method):
    params, loss_fn, batches = _mlp_problem(seed=2)
    cfg = LocalDPConfig.adding(K=4, H=8, inner_lr=5e-2, compress=method)
    rf = make_round_fn(loss_fn, cfg)
    st = init_state(params, cfg)
    l0 = _global_loss(loss_fn, st.params, batches)
    for _ in range(40):
        st = rf(st, batches)
    l1 = _global_loss(loss_fn, st.params, batches)
    assert l1 < 0.6 * l0


def test_localdp_config_resolves_as_the_reference():
    for K in (1, 4, 8):
        for make in ("adding", "averaging"):
            got = getattr(LocalDPConfig, make)(K, H=3)
            want = getattr(ref_localdp.LocalDPConfig, make)(K, H=3)
            assert got.resolved_sigma() == want.resolved_sigma()
            assert (got.gamma, got.prox0, got.H) == (want.gamma, want.prox0,
                                                     want.H)


def _ref_mlp_loss(p, batch):
    X, y = batch
    h = jnp.tanh(X @ p["w1"])
    return jnp.mean((h @ p["w2"] - y) ** 2)


@pytest.mark.parametrize("make,compress", [("adding", "none"),
                                           ("averaging", "none"),
                                           ("adding", "int8")])
def test_localdp_round_matches_reference(make, compress):
    """3 rounds of `make_round_fn` on the same numpy problem, float32."""
    params, Xs, ys = tp.mlp_problem(seed=3)
    kw = dict(H=4, inner_lr=5e-2, compress=compress)
    rcfg = getattr(ref_localdp.LocalDPConfig, make)(4, **kw)
    tcfg = getattr(LocalDPConfig, make)(4, **kw)
    rf = jax.jit(ref_localdp.make_round_fn(_ref_mlp_loss, rcfg))
    rs = ref_localdp.init_state({k: jnp.asarray(v)
                                 for k, v in params.items()}, rcfg)
    tf = make_round_fn(tp.mlp_loss, tcfg)
    ts = init_state({k: torch.from_numpy(v) for k, v in params.items()},
                    tcfg)
    rb = (jnp.asarray(Xs), jnp.asarray(ys))
    tb = (torch.from_numpy(Xs), torch.from_numpy(ys))
    for _ in range(3):
        rs, ts = rf(rs, rb), tf(ts, tb)
    for k in params:
        np.testing.assert_allclose(tp.to_np(ts.params[k]),
                                   np.asarray(rs.params[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if compress != "none":
        for k in params:
            np.testing.assert_allclose(tp.to_np(ts.ef.residual[k]),
                                       np.asarray(rs.ef.residual[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_localdp_round_leaves_its_input_state_as_it_was():
    params, loss_fn, batches = _mlp_problem(seed=4)
    before = {k: v.clone() for k, v in params.items()}
    cfg = LocalDPConfig.adding(K=4, H=2)
    st = make_round_fn(loss_fn, cfg)(init_state(params, cfg), batches)
    for k in params:
        assert torch.equal(params[k], before[k])
        assert not torch.equal(st.params[k], before[k])
        assert not st.params[k].requires_grad


def test_localdp_sharded_on_two_ranks_matches_one_process():
    """`make_round_sharded` on 2 gloo CPU ranks (one all_reduce of the
    delta per leaf a round) against `make_round_fn` in one process."""
    params, Xs, ys = tp.mlp_problem(K=2, seed=5)
    cfg = dict(K=2, H=4, gamma=1.0, sigma_p=2.0, inner_lr=5e-2)
    ranks = spawn_ranks(tp.localdp_on_ranks, 2,
                        (params, Xs, ys, cfg, 3), timeout=120)
    one = make_round_fn(tp.mlp_loss, LocalDPConfig(**cfg))
    st = init_state({k: torch.from_numpy(v) for k, v in params.items()},
                    LocalDPConfig(**cfg))
    for _ in range(3):
        st = one(st, (torch.from_numpy(Xs), torch.from_numpy(ys)))
    for got in ranks:
        for k in params:
            np.testing.assert_allclose(got[k], tp.to_np(st.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_make_round_sharded_needs_a_process_mesh():
    with pytest.raises(ValueError, match="process mesh"):
        make_round_sharded(tp.mlp_loss, LocalDPConfig(K=2),
                           make_test_mesh((2, 1), device="cpu"))


# ----------------------------------------------------------------------------
# the compress shim
# ----------------------------------------------------------------------------

def test_optim_compress_shim_warns_and_reexports():
    with pytest.warns(DeprecationWarning, match="repro_torch.comm.compress"):
        import repro_torch.optim.compress as legacy
        legacy = importlib.reload(legacy)
    assert legacy.compress is C.compress
    assert legacy.ef_init is C.ef_init
    assert legacy.EFState is C.EFState
    assert legacy.compressed_bytes is C.compressed_bytes


def test_optim_package_does_not_import_the_shim():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        import repro_torch.optim as optim
        importlib.reload(optim)
        import repro_torch.optim.localdp as localdp
        importlib.reload(localdp)
