"""The paper's baselines (Figure 2) in the port against the reference's.

The port draws from a torch.Generator; here every function is fed the
reference's own `jax.random` draws through its hook, so both sides take
the same rows: SGD step / CD round t the (K, b_local) ids of
`randint(split(key)[1], ...)` with the key carried from `PRNGKey(seed)`,
the one-shot solve worker k's (H,) ids of `randint(split(PRNGKey(seed),
K)[k], ...)`. Every value within 1e-5 (float32 sums in another order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_b
from repro.core.losses import get_loss as ref_loss
from repro.data import make_classification, partition as ref_partition
from repro_torch.core import baselines
from repro_torch.core.losses import get_loss
from repro_torch.data import partition

import torch_parity as tp

TOL = 1e-5
K, B = 6, 8


@pytest.fixture(scope="module")
def data():
    """n = 1,000 rows over K = 6 workers: 2 padded rows, so the workers'
    nk_eff differ."""
    X, y = make_classification(1000, 24, seed=4)
    return ref_partition(X, y, K, seed=1), partition(X, y, K, seed=1,
                                                     device="cpu")


def _step_draws(seed: int, steps: int, nk: int, b: int = B):
    """The (K, b) row ids the reference's steps draw from PRNGKey(seed)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.asarray(
            jax.random.randint(sub, (K, b), 0, nk)).astype(np.int64)))
    return out


def _close(got, want, what):
    np.testing.assert_allclose(tp.to_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_sgd_step_matches_reference(data, loss):
    (rX, ry, rm), (X, y, m) = data
    w0 = np.random.default_rng(1).standard_normal(24).astype(np.float32)
    ref = ref_b.SGDState(jax.numpy.asarray(w0), jax.random.PRNGKey(3),
                         jax.numpy.asarray(4, jax.numpy.int32))
    ref_out = ref_b.minibatch_sgd_step(ref, rX, ry, rm, loss=ref_loss(loss),
                                       lam=1e-3, b_local=B, lr0=0.5)
    idx = _step_draws(3, 1, y.shape[1])[0]
    st = baselines.SGDState(torch.from_numpy(w0), torch.Generator(), 4)
    out = baselines.minibatch_sgd_step(st, X, y, m, loss=get_loss(loss),
                                       lam=1e-3, b_local=B, lr0=0.5, idx=idx)
    assert out.step == 5
    _close(out.w, ref_out.w, "w")


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge"])
def test_cd_round_matches_reference(data, loss):
    (rX, ry, rm), (X, y, m) = data
    rng = np.random.default_rng(2)
    w0 = (0.1 * rng.standard_normal(24)).astype(np.float32)
    a0 = (tp.to_np(y) * rng.random(y.shape) * 0.5 * tp.to_np(m)).astype(
        np.float32)
    rw, ra, _ = ref_b.minibatch_cd_round(
        jax.numpy.asarray(w0), jax.numpy.asarray(a0), jax.random.PRNGKey(9),
        rX, ry, rm, loss=ref_loss(loss), lam=1e-3, b_local=B)
    idx = _step_draws(9, 1, y.shape[1])[0]
    w, a, _ = baselines.minibatch_cd_round(
        torch.from_numpy(w0), torch.from_numpy(a0), None, X, y, m,
        loss=get_loss(loss), lam=1e-3, b_local=B, idx=idx)
    _close(w, rw, "w")
    _close(a, ra, "alpha")


def test_cd_duplicate_rows_add():
    """Two draws of one row in a batch both land (scatter add)."""
    X = torch.eye(3).reshape(1, 3, 3)
    y = torch.ones(1, 3)
    m = torch.ones(1, 3)
    idx = torch.tensor([[1, 1]])
    _, a, _ = baselines.minibatch_cd_round(
        torch.zeros(3), torch.zeros(1, 3), None, X, y, m,
        loss=get_loss("hinge"), lam=1.0, b_local=2, idx=idx)
    single = baselines.minibatch_cd_round(
        torch.zeros(3), torch.zeros(1, 3), None, X, y, m,
        loss=get_loss("hinge"), lam=1.0, b_local=2,
        idx=torch.tensor([[1, 0]]))[1]
    assert float(a[0, 1]) == pytest.approx(2 * float(single[0, 1]))


def test_run_minibatch_sgd_history_matches_reference(data):
    (rX, ry, rm), (X, y, m) = data
    ref_st, ref_h = ref_b.run_minibatch_sgd(
        rX, ry, rm, loss_name="hinge", lam=1e-3, steps=12, b_local=B,
        lr0=1.0, seed=5, eval_every=4)
    draws = _step_draws(5, 12, y.shape[1])
    st, h = baselines.run_minibatch_sgd(
        X, y, m, loss_name="hinge", lam=1e-3, steps=12, b_local=B, lr0=1.0,
        seed=5, eval_every=4, draws=lambda t: draws[t])
    assert h["step"] == ref_h["step"] == [4, 8, 12]
    assert h["comm_vectors"] == ref_h["comm_vectors"]
    _close(h["primal"], ref_h["primal"], "primal")
    _close(st.w, ref_st.w, "w")
    assert st.step == 12


def test_run_minibatch_cd_history_matches_reference(data):
    (rX, ry, rm), (X, y, m) = data
    (rw, ra), ref_h = ref_b.run_minibatch_cd(
        rX, ry, rm, loss_name="hinge", lam=1e-3, rounds=9, b_local=B,
        seed=2, eval_every=3)
    draws = _step_draws(2, 9, y.shape[1])
    (w, a), h = baselines.run_minibatch_cd(
        X, y, m, loss_name="hinge", lam=1e-3, rounds=9, b_local=B, seed=2,
        eval_every=3, draws=lambda t: draws[t])
    assert h["round"] == ref_h["round"] == [3, 6, 9]
    assert h["comm_vectors"] == ref_h["comm_vectors"]
    _close(h["gap"], ref_h["gap"], "gap")
    _close(h["primal"], ref_h["primal"], "primal")
    _close(w, rw, "w")
    _close(a, ra, "alpha")
    assert h["gap"][-1] < h["gap"][0]


def test_own_draws_run_and_repeat(data):
    """Without the hooks the port draws from its seeded generators: the
    same seed, the same result."""
    _, (X, y, m) = data
    runs = [baselines.run_minibatch_cd(X, y, m, loss_name="hinge", lam=1e-3,
                                       rounds=3, b_local=B, seed=1,
                                       eval_every=1) for _ in range(2)]
    assert runs[0][1]["gap"] == runs[1][1]["gap"]
    sgd = baselines.run_minibatch_sgd(X, y, m, loss_name="hinge", lam=1e-3,
                                      steps=3, b_local=B, seed=1)
    assert np.isfinite(sgd[1]["primal"]).all()
    w = baselines.one_shot_average(X, y, m, loss_name="hinge", lam=1e-3,
                                   H=64, seed=1)
    assert torch.equal(w, baselines.one_shot_average(
        X, y, m, loss_name="hinge", lam=1e-3, H=64, seed=1))


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_one_shot_average_matches_reference(data, loss):
    (rX, ry, rm), (X, y, m) = data
    H, nk = 200, y.shape[1]
    assert len(set(tp.to_np(m).sum(axis=1).tolist())) > 1  # unequal nk_eff
    ref_w = ref_b.one_shot_average(rX, ry, rm, loss_name=loss, lam=1e-2, H=H,
                                   seed=3)
    keys = jax.random.split(jax.random.PRNGKey(3), K)
    rows = torch.as_tensor(np.stack([
        np.asarray(jax.random.randint(k, (H,), 0, nk)) for k in keys
    ]).astype(np.int64))
    w = baselines.one_shot_average(X, y, m, loss_name=loss, lam=1e-2, H=H,
                                   rows=rows)
    _close(w, ref_w, "w")
