"""The port's other local solvers (`sdca_deadline`, `sdca_importance`,
`gd`), sigma, the subproblem and the rest of the duality module, held
against the reference on the same numpy inputs.

The solvers are held to tests/test_solver_conformance.py's contract (du
is the sigma'-scaled image of dalpha, padded rows are exact no-ops, the
steps are reported honestly) and to their reference counterparts, fed the
reference's own index streams: `randint` for the deadline solver (the
eager twin's stream), `choice(..., p=)` for the importance solver; gd
takes none. Per-worker results within rtol 1e-5, atol 1e-6 (float32 dot
order); `solve` per-round gaps within 1e-4 relative, as
tests/test_torch_cocoa.py. sigma and the subproblem within 1e-5 relative,
with the power iterations' start vectors fed from the reference's keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.core import duality as rdual, sigma as rsigma
from repro.core import solvers as rsolvers, subproblem as rsub
from repro.core.losses import get_loss as ref_loss
from repro.core.regularizers import get_regularizer as ref_reg
from repro.data import load, partition as ref_partition
from repro_torch.core import CoCoAConfig, duality, sigma, solve, solvers
from repro_torch.core import subproblem
from repro_torch.core.cocoa import draw_visit_orders, visit_shape
from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.data import partition

import torch_parity as tp

K, NK, D = 3, 64, 96
MASKED = 9          # trailing padded rows per worker
LAM, SIGMA_P, H = 1e-3, 4.0, 128
RTOL, ATOL = 1e-5, 1e-6
NEW = ("sdca_deadline", "sdca_importance", "gd")


def _inputs(seed=0):
    """Worker blocks as in tests/test_solver_conformance.py, K of them."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, NK, D)).astype(np.float32)
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    mask = np.ones((K, NK), np.float32)
    mask[:, NK - MASKED:] = 0.0
    X *= mask[..., None]
    y = np.sign(rng.standard_normal((K, NK))).astype(np.float32)
    alpha = (0.1 * rng.standard_normal((K, NK))).astype(np.float32) * mask
    v = (0.2 * rng.standard_normal(D)).astype(np.float32)
    return X, y, alpha, mask, v


def _ref_stream(name, X, mask, keys):
    """The (K, H) row stream each reference solver draws from its key."""
    rows = []
    for k, key in enumerate(keys):
        if name == "sdca_importance":
            Xk, mk = jnp.asarray(X[k]), jnp.asarray(mask[k])
            sq = jnp.sum(Xk * Xk, axis=-1) * mk
            mean_sq = jnp.sum(sq) / jnp.maximum(jnp.sum(mk), 1.0)
            probs = (sq + mean_sq) * mk
            rows.append(np.asarray(jax.random.choice(
                key, NK, (H,), p=probs / jnp.sum(probs))))
        else:
            rows.append(np.asarray(jax.random.randint(key, (H,), 0, NK)))
    return torch.as_tensor(np.stack(rows).astype(np.int64))


def _run_pair(name, budget=None, loss="smooth_hinge", seed=0):
    X, y, alpha, mask, v = _inputs(seed)
    n = float(K * (NK - MASKED))
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    ref_fn = rsolvers.get_solver(name).fn
    want = []
    for k in range(K):
        extra = ((budget[k] if budget is not None else H,)
                 if name == "sdca_deadline" else ())
        want.append(ref_fn(jnp.asarray(X[k]), jnp.asarray(y[k]),
                           jnp.asarray(alpha[k]), jnp.asarray(mask[k]),
                           jnp.asarray(v), keys[k], ref_loss(loss), LAM, n,
                           SIGMA_P, H, *extra))
    ls = solvers.get_solver(name)
    order = None if ls.visit == "none" else _ref_stream(name, X, mask, keys)
    kw = {}
    if ls.deadline and budget is not None:
        kw["budget"] = torch.as_tensor(np.asarray(budget))
    got = ls.fn(*map(torch.from_numpy, (X, y, alpha, mask, v)), order,
                get_loss(loss), LAM, n, SIGMA_P, H, **kw)
    return got, want, (X, n)


@pytest.mark.parametrize("name", NEW)
def test_solver_matches_reference(name):
    budget = [H, 37, 1] if name == "sdca_deadline" else None
    got, want, _ = _run_pair(name, budget)
    np.testing.assert_allclose(tp.to_np(got.dalpha),
                               np.stack([np.asarray(w.dalpha) for w in want]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.to_np(got.du),
                               np.stack([np.asarray(w.du) for w in want]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        np.broadcast_to(tp.to_np(torch.as_tensor(got.steps)), (K,)),
        [int(w.steps) for w in want])


@pytest.mark.parametrize("name", NEW)
def test_du_consistent_with_dalpha(name):
    got, _, (X, n) = _run_pair(name)
    scale = SIGMA_P / (LAM * n)
    want = scale * np.einsum("kid,ki->kd", X, tp.to_np(got.dalpha))
    np.testing.assert_allclose(tp.to_np(got.du), want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("name", NEW)
def test_masked_rows_are_exact_noops(name):
    got, _, _ = _run_pair(name)
    assert float(got.dalpha[:, NK - MASKED:].abs().max()) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_steps_honestly_reported(name):
    ls = solvers.get_solver(name)
    budget = [37, 37, 37] if ls.deadline else None
    got, _, _ = _run_pair(name, budget)
    steps = np.broadcast_to(tp.to_np(torch.as_tensor(got.steps)), (K,))
    assert steps.tolist() == ([37] * K if ls.deadline else [H] * K)


@pytest.mark.parametrize("name", NEW)
def test_capability_flags_match_reference(name):
    ref, port = rsolvers.get_solver(name), solvers.get_solver(name)
    for flag in ("dense", "sparse", "deadline", "sqnorms", "sparse_name",
                 "model_axis"):
        assert getattr(port, flag) == getattr(ref, flag), flag
    want_visit = {"sdca_deadline": "draws", "sdca_importance": "importance",
                  "gd": "none"}[name]
    assert port.visit == want_visit


@pytest.mark.parametrize("b", [1, 17, 50, H, H + 40])
def test_deadline_per_worker_budget_equals_static(b):
    """A (K,) budget and a static int budget give the same result bit for
    bit (the reference's traced vs static budget pin); steps min(H, b)."""
    X, y, alpha, mask, v = map(torch.from_numpy, _inputs(3))
    idxs = torch.randint(0, NK, (K, H), generator=torch.Generator()
                         .manual_seed(3))
    args = (X, y, alpha, mask, v, idxs, get_loss("smooth_hinge"), LAM,
            float(K * (NK - MASKED)), SIGMA_P, H)
    static = solvers.local_sdca_deadline(*args, budget=b)
    vector = solvers.local_sdca_deadline(*args, budget=torch.full((K,), b))
    assert torch.equal(static.dalpha, vector.dalpha)
    assert torch.equal(static.du, vector.du)
    assert static.steps == min(b, H)
    assert vector.steps.tolist() == [min(b, H)] * K
    full = solvers.local_sdca(*args)
    if b >= H:                      # no deadline: the eager twin's steps
        assert torch.equal(full.dalpha, static.dalpha)


def test_deadline_cuts_one_worker_only():
    """Worker 1 at H/10: its dalpha is the static H/10 run's; the others
    take all H steps."""
    X, y, alpha, mask, v = map(torch.from_numpy, _inputs(4))
    idxs = torch.randint(0, NK, (K, H), generator=torch.Generator()
                         .manual_seed(4))
    args = (X, y, alpha, mask, v, idxs, get_loss("hinge"), LAM,
            float(K * (NK - MASKED)), SIGMA_P, H)
    cut = solvers.local_sdca_deadline(*args,
                                      budget=torch.tensor([H, H // 10, H]))
    short = solvers.local_sdca_deadline(*args, budget=H // 10)
    full = solvers.local_sdca_deadline(*args)
    assert cut.steps.tolist() == [H, H // 10, H]
    assert torch.equal(cut.dalpha[1], short.dalpha[1])
    assert torch.equal(cut.dalpha[0], full.dalpha[0])
    assert torch.equal(cut.dalpha[2], full.dalpha[2])


def test_visit_kinds():
    gd = solvers.get_solver("gd")
    imp = solvers.get_solver("sdca_importance")
    assert visit_shape(gd, K, NK, H) is None
    assert draw_visit_orders(gd, K, NK, H, 0, 0) is None
    X, _, _, mask, _ = map(torch.from_numpy, _inputs(5))
    probs = solvers.importance_probs(X, mask)
    torch.testing.assert_close(probs.sum(-1), torch.ones(K))
    assert float(probs[:, NK - MASKED:].abs().max()) == 0.0
    order = draw_visit_orders(imp, K, NK, H, 0, 0, probs)
    assert tuple(order.shape) == visit_shape(imp, K, NK, H) == (K, H)
    assert int(order.max()) < NK - MASKED      # masked rows have p = 0
    again = draw_visit_orders(imp, K, NK, H, 0, 0, probs)
    assert torch.equal(order, again)
    with pytest.raises(ValueError, match="pass probs"):
        draw_visit_orders(imp, K, NK, H, 0, 0)


def test_gd_needs_conj_grad_and_project():
    from repro_torch.core.losses import Loss
    bare = get_loss("hinge")
    import dataclasses
    loss = dataclasses.replace(bare, project=None)
    assert isinstance(loss, Loss)
    X, y, alpha, mask, v = map(torch.from_numpy, _inputs(6))
    with pytest.raises(ValueError, match="conj_grad and project"):
        solvers.local_gd(X, y, alpha, mask, v, None, loss, LAM, 100.0,
                         SIGMA_P, 4)


# ----------------------------------------------------------------------------
# solve with the new solvers
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    X, y = load("tiny")
    return ref_partition(X, y, 8), partition(X, y, 8, device="cpu")


def _importance_hook(ref_data, seed, rounds, H_):
    Xr, _, mk = ref_data
    Xn, mn = np.asarray(Xr), np.asarray(mk)
    subs = tp.round_keys(jax.random.PRNGKey(seed), rounds)
    out = []
    for sub in subs:
        keys = [jax.random.fold_in(sub, k) for k in range(Xn.shape[0])]
        rows = []
        for k, key in enumerate(keys):
            Xk, m = jnp.asarray(Xn[k]), jnp.asarray(mn[k])
            sq = jnp.sum(Xk * Xk, axis=-1) * m
            probs = (sq + jnp.sum(sq) / jnp.maximum(jnp.sum(m), 1.0)) * m
            rows.append(np.asarray(jax.random.choice(
                key, Xn.shape[1], (H_,), p=probs / jnp.sum(probs))))
        out.append(torch.as_tensor(np.stack(rows).astype(np.int64)))
    return lambda t: out[t]


@pytest.mark.parametrize("name", NEW)
def test_solve_matches_reference(tiny, name):
    ref_data, port_data = tiny
    rounds, H_ = 4, 64
    cfg = dict(solver=name, lam=1e-3, H=H_, loss="smooth_hinge")
    budgets = np.array([H_, 6, H_, H_, 20, H_, H_, H_])
    kw = {}
    if name == "sdca_deadline":
        kw["budget_fn"] = lambda t: budgets
    ref = ref_solve(RefConfig.adding(8, **cfg), *ref_data, rounds=rounds,
                    seed=0, **kw)
    nk = port_data[1].shape[1]
    if name == "sdca_importance":
        hook = _importance_hook(ref_data, 0, rounds, H_)
    elif name == "gd":
        hook = None
    else:
        hook = tp.reference_visit_orders(0, rounds, 8, nk, H_, "draws")
    port = solve(CoCoAConfig.adding(8, **cfg), *port_data, rounds=rounds,
                 seed=0, visit_orders=hook, **kw)
    np.testing.assert_allclose(port.history["gap"], ref.history["gap"],
                               rtol=1e-4)
    assert port.history["comm_floats"] == ref.history["comm_floats"]
    assert port.history["gap"][-1] < port.history["gap"][0]


# ----------------------------------------------------------------------------
# sigma, the subproblem, duality
# ----------------------------------------------------------------------------

def _rel(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(tp.to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _sigma_starts(seed, Kb, nk, d):
    rngs = jax.random.split(jax.random.PRNGKey(seed), Kb)
    v0 = np.stack([np.asarray(jax.random.normal(r, (d,))) for r in rngs])
    a0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (Kb, nk)))
    return torch.from_numpy(v0), torch.from_numpy(a0)


def test_sigma_k_and_table1_ratio_match_reference(tiny):
    (Xr, _, mr), (Xp, _, mp) = tiny
    v0, _ = _sigma_starts(0, Xp.shape[0], Xp.shape[1], Xp.shape[2])
    _rel(sigma.sigma_k(Xp, mp, v0=v0), rsigma.sigma_k(Xr, mr))
    _rel(sigma.sigma_total(Xp, mp, v0=v0), rsigma.sigma_total(Xr, mr))
    _rel(sigma.table1_ratio(Xp, mp, v0=v0), rsigma.table1_ratio(Xr, mr))
    v0, _ = _sigma_starts(3, Xp.shape[0], Xp.shape[1], Xp.shape[2])
    _rel(sigma.sigma_k(Xp, mp, iters=20, v0=v0),
         rsigma.sigma_k(Xr, mr, iters=20, seed=3))


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_sigma_prime_min_and_lemma4_match_reference(gamma):
    X, _, _, mask, _ = _inputs(7)
    X, mask = X[:, :24, :40], mask[:, :24]       # the (nk, nk) pinvs: cut
    _, a0 = _sigma_starts(0, K, 24, 40)
    got = sigma.sigma_prime_min(torch.from_numpy(X), torch.from_numpy(mask),
                                gamma, a0=a0)
    want = rsigma.sigma_prime_min(jnp.asarray(X), jnp.asarray(mask), gamma)
    _rel(got, want)
    smin, bound, holds = sigma.check_lemma4(
        torch.from_numpy(X), torch.from_numpy(mask), gamma, a0=a0)
    rsmin, rbound, rholds = rsigma.check_lemma4(jnp.asarray(X),
                                                jnp.asarray(mask), gamma)
    _rel(smin, rsmin)
    assert bound == rbound and holds == bool(rholds) and holds


@pytest.mark.parametrize("reg_name", ["l2", "elastic:0.5"])
@pytest.mark.parametrize("loss_name", ["hinge", "smooth_hinge", "squared"])
def test_subproblem_matches_reference(loss_name, reg_name):
    X, y, alpha, mask, v = _inputs(8)
    rng = np.random.default_rng(8)
    dalpha = (0.05 * rng.standard_normal((K, NK))).astype(np.float32) * mask
    if loss_name != "squared":          # stay in the conjugate's domain
        alpha = np.clip(alpha * y, 0.0, 0.5) * y
        dalpha = np.clip((alpha + dalpha) * y, 0.0, 1.0) * y - alpha
    args = (X, y, alpha, mask, v, dalpha)
    n, Kw = float(K * (NK - MASKED)), K
    jX, jy, ja, jm, jv, jd = map(jnp.asarray, args)
    tX, ty, ta, tm, tv, td = map(torch.from_numpy, args)
    want_one = rsub.subproblem_value(jd[0], jv, ja[0], jX[0], jy[0], jm[0],
                                     ref_loss(loss_name), LAM, n, Kw,
                                     SIGMA_P, ref_reg(reg_name))
    got_one = subproblem.subproblem_value(
        td[0], tv, ta[0], tX[0], ty[0], tm[0], get_loss(loss_name), LAM, n,
        Kw, SIGMA_P, get_regularizer(reg_name))
    _rel(got_one, want_one)
    want = rsub.subproblem_sum(jd, jv, ja, jX, jy, jm, ref_loss(loss_name),
                               LAM, n, Kw, SIGMA_P, ref_reg(reg_name))
    got = subproblem.subproblem_sum(td, tv, ta, tX, ty, tm,
                                    get_loss(loss_name), LAM, n, Kw, SIGMA_P,
                                    get_regularizer(reg_name))
    _rel(got, want)


@pytest.mark.parametrize("reg_name", ["l2", "l1s:0.5"])
def test_duality_functions_match_reference(tiny, reg_name):
    (Xr, yr, mr), (Xp, yp, mp) = tiny
    rng = np.random.default_rng(9)
    alpha = (np.asarray(yr) * rng.random(np.asarray(yr).shape) * 0.5
             * np.asarray(mr)).astype(np.float32)
    w = (0.1 * rng.standard_normal(Xp.shape[-1])).astype(np.float32)
    ja, jw, ta, tw = (jnp.asarray(alpha), jnp.asarray(w),
                      torch.from_numpy(alpha), torch.from_numpy(w))
    rl, rr = ref_loss("hinge"), ref_reg(reg_name)
    pl, pr = get_loss("hinge"), get_regularizer(reg_name)
    n = float(np.asarray(mr).sum())
    # the soft threshold of l1s cancels |v| - kappa: absolute error at the
    # float32 resolution of v, ~1e-6 of its largest entry
    want_w = rdual.w_of_alpha(Xr, ja, 1e-3, n, rr)
    _rel(duality.w_of_alpha(Xp, ta, 1e-3, n, pr), want_w,
         atol=1e-6 * float(jnp.max(jnp.abs(rdual.v_of_alpha(Xr, ja, 1e-3,
                                                            n, rr)))))
    _rel(duality.dual(ta, Xp, yp, mp, pl, 1e-3, pr),
         rdual.dual(ja, Xr, yr, mr, rl, 1e-3, rr))
    _rel(duality.duality_gap(ta, Xp, yp, mp, pl, 1e-3, pr),
         rdual.duality_gap(ja, Xr, yr, mr, rl, 1e-3, rr), rtol=1e-4)
    for got, want in zip(duality.gap_at_w(tw, ta, Xp, yp, mp, pl, 1e-3, pr),
                         rdual.gap_at_w(jw, ja, Xr, yr, mr, rl, 1e-3, rr)):
        _rel(got, want, rtol=1e-4)
    _rel(duality.u_vector(tw, Xp, yp, pl), rdual.u_vector(jw, Xr, yr, rl))
