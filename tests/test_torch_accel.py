"""The port's accelerated outer rounds (`core.accel`) against the
reference's `tests/test_accel.py` contract.

The schedules are held to the reference's functions value for value. The
pinned ill-conditioned problem (make_classification(2048, 128, cond=100),
K = 8, squared loss, lambda = 5e-4, H = 128, add) is solved with the
reference's own visit orders fed through `solve(visit_orders=)`: the
rounds to gap 1e-4 must equal the reference's for none / nesterov:16 /
catalyst:20. tests/test_accel.py's docstring quotes 125 / 45 / 45; the
reference's own solve takes 125 / 46 / 46 on jax 0.9, and so does the
port, so those are pinned.

Every round's primal is held within 1e-6 relative of the reference's,
and its gap within 1e-4 relative (tests/test_torch_cocoa.py's bar) plus
the float32 rounding the reference's certificate carries: it sums P and
D in float32, so its gap P - D is resolved to about eps32 (|P| + |D|)
(~1e-7 here, with P ~ 0.39); once the gap falls under ~1e-3 that
rounding is more than 1e-4 of it (the port sums in float64).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.core import accel as ref_accel
from repro.data import make_classification as ref_make, \
    partition as ref_partition
from repro_torch import comm
from repro_torch.core import CoCoAConfig, solve, state_from_reference
from repro_torch.core.accel import (AccelSpec, catalyst_step,
                                    init_accel_state, momentum_coeffs,
                                    nesterov_beta, parse_accel, wrap_round)
from repro_torch.core.cocoa import init_state
from repro_torch.data import load, make_classification, partition, \
    partition_sparse
from repro_torch.launch.mesh import make_test_mesh

import torch_parity as tp

EPS_GAP = 1e-4
PIN = dict(n=2048, d=128, cond=100.0, K=8, seed=0)
PIN_CFG = dict(loss="squared", lam=5e-4, H=128, solver="sdca",
               aggregator="add")
PIN_ROUNDS = 300
REF_ROUNDS = {"none": 125, "nesterov:16": 46, "catalyst:20": 46}
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def illcond():
    X, y = make_classification(PIN["n"], PIN["d"], seed=PIN["seed"],
                               cond=PIN["cond"])
    return partition(X, y, PIN["K"], seed=PIN["seed"], device="cpu")


@pytest.fixture(scope="module")
def ref_orders():
    """The reference's (K, H) draws of the pinned solve, every round it
    takes and a few past the last (a run that needed more reads them)."""
    nk = PIN["n"] // PIN["K"]
    return tp.reference_visit_orders(0, REF_ROUNDS["none"] + 10, PIN["K"],
                                     nk, PIN_CFG["H"], "draws")


def _solve(data, accel, rounds=PIN_ROUNDS, eps=EPS_GAP, **kw):
    cfg = CoCoAConfig(accel=accel, **{**PIN_CFG, **kw})
    return solve(cfg, *data, rounds=rounds, eps_gap=eps, seed=0)


# ----------------------------------------------------------------------------
# parse_accel and the schedules, value for value
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "", "none", "nesterov", "nesterov:16",
                                  "catalyst:10", "catalyst:20", "catalyst:0.5"])
def test_parse_accel_matches_reference(spec):
    got, want = parse_accel(spec), ref_accel.parse_accel(spec)
    assert (got.kind, got.kappa, got.restart, got.enabled) == (
        want.kind, want.kappa, want.restart, want.enabled)
    assert got.q == pytest.approx(want.q) and got.a0 == pytest.approx(want.a0)
    assert got.beta_limit() == pytest.approx(want.beta_limit())


@pytest.mark.parametrize("bad", ["catalyst", "catalyst:0", "catalyst:-3",
                                 "nesterov:0", "nesterov:-1", "heavyball",
                                 "nesterov:x"])
def test_parse_accel_rejects(bad):
    with pytest.raises(ValueError):
        ref_accel.parse_accel(bad)
    with pytest.raises(ValueError):
        parse_accel(bad)


def test_nesterov_schedule_matches_reference():
    assert float(nesterov_beta(0)) == 0.0             # first round plain
    for t in (1, 2, 3, 10, 77, 10_000):
        assert float(nesterov_beta(t)) == float(ref_accel.nesterov_beta(t))
    spec, rspec = parse_accel("nesterov:4"), ref_accel.parse_accel(
        "nesterov:4")
    betas = [float(momentum_coeffs(spec, t, 0.0)[1]) for t in range(9)]
    assert betas == [float(ref_accel.momentum_coeffs(rspec, t, 0.0)[1])
                     for t in range(9)]
    assert betas[0] == betas[4] == betas[8] == 0.0 and betas[1] > 0.0


def test_catalyst_recursion_matches_reference():
    """200 steps of the alpha-recursion, float32 on both sides: the same
    values, inside (0, 1), converging to the limit momentum."""
    spec = parse_accel("catalyst:20")
    a, ra = torch.tensor(spec.a0), jnp.asarray(spec.a0, jnp.float32)
    for _ in range(200):
        a, beta = catalyst_step(a, spec.q)
        ra, rbeta = ref_accel.catalyst_step(ra, spec.q)
        assert float(a) == pytest.approx(float(ra), rel=1e-6)
        assert float(beta) == pytest.approx(float(rbeta), rel=1e-6)
        assert 0.0 < float(a) < 1.0
    assert float(beta) == pytest.approx(spec.beta_limit(), abs=1e-4)


def test_wrap_round_none_returns_the_round_itself():
    fn = lambda s: s
    assert wrap_round(fn, AccelSpec("none")) is fn
    assert wrap_round(fn, parse_accel(None)) is fn


def test_wrap_round_needs_the_momentum_leaves():
    st = init_state(4, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="init_accel_state"):
        wrap_round(lambda s: s, parse_accel("nesterov"))(st)


def test_init_accel_state_is_idempotent():
    spec = parse_accel("catalyst:20")
    st = init_state(PIN["d"], PIN["K"], 256, device="cpu")
    st1 = init_accel_state(st, spec)
    st2 = init_accel_state(st1, spec)
    assert st2.v_prev is st1.v_prev and st2.accel_a is st1.accel_a
    assert st1.v_prev is st.w and st1.alpha_prev is st.alpha
    assert float(st1.accel_a) == pytest.approx(spec.a0)
    assert init_accel_state(st, AccelSpec("none")) is st


# ----------------------------------------------------------------------------
# solve under momentum
# ----------------------------------------------------------------------------

def test_accel_none_leaves_the_momentum_leaves_unset(illcond):
    r = _solve(illcond, "none", rounds=2, eps=0.0)
    st = r.state
    assert st.v_prev is None and st.alpha_prev is None and st.accel_a is None
    r_default = solve(CoCoAConfig(**PIN_CFG), *illcond, rounds=2, seed=0)
    assert r.history["gap"] == r_default.history["gap"]
    assert torch.equal(r.state.w, r_default.state.w)


@pytest.mark.parametrize("accel", ["nesterov", "catalyst:20"])
def test_first_accelerated_round_is_exactly_plain(illcond, accel):
    r_none = _solve(illcond, "none", rounds=1, eps=0.0)
    r_acc = _solve(illcond, accel, rounds=1, eps=0.0)
    assert torch.equal(r_none.state.w, r_acc.state.w)
    assert torch.equal(r_none.state.alpha, r_acc.state.alpha)
    assert r_acc.state.v_prev is not None
    r_none3 = _solve(illcond, "none", rounds=3, eps=0.0)
    r_acc3 = _solve(illcond, accel, rounds=3, eps=0.0)
    assert float((r_none3.state.w - r_acc3.state.w).abs().max()) > 0


@pytest.fixture(scope="module")
def pinned(illcond, ref_orders):
    """The pinned solves, port and reference, on the reference's orders."""
    X, y = ref_make(PIN["n"], PIN["d"], seed=PIN["seed"], cond=PIN["cond"])
    ref_data = ref_partition(X, y, PIN["K"], seed=PIN["seed"])
    out = {}
    for accel in REF_ROUNDS:
        ref = ref_solve(RefConfig(accel=accel, **PIN_CFG), *ref_data,
                        rounds=PIN_ROUNDS, eps_gap=EPS_GAP, gap_every=1,
                        seed=0)
        cfg = CoCoAConfig(accel=accel, **PIN_CFG)
        port = solve(cfg, *illcond, rounds=PIN_ROUNDS, eps_gap=EPS_GAP,
                     seed=0, visit_orders=ref_orders)
        out[accel] = (ref.history, port)
    return out


@pytest.mark.parametrize("accel", list(REF_ROUNDS))
def test_rounds_to_gap_match_reference(pinned, accel):
    ref, port = pinned[accel]
    assert ref["round"][-1] == REF_ROUNDS[accel]
    assert port.history["round"][-1] == REF_ROUNDS[accel]
    assert port.history["gap"][-1] <= EPS_GAP
    np.testing.assert_allclose(port.history["primal"], ref["primal"],
                               rtol=1e-6)
    gap, want = np.asarray(port.history["gap"]), np.asarray(ref["gap"])
    # the reference sums P and D in float32, so a gap near 1e-4 carries
    # their rounding: 4 ulps of |P| + |D|. Measured on the CPU where the
    # gaps leave 1e-4 relative: the largest |gap - ref| is 1.219e-7 (none,
    # round 72), 1.445e-7 (nesterov:16, round 43), 1.248e-7 (catalyst:20,
    # round 45), against this term's 3.71e-7 there (|P| + |D| ~ 0.78: one
    # to two float32 ulps); no round uses more than 0.37 of the limit
    f32 = 4 * EPS32 * (np.abs(ref["primal"]) + np.abs(ref["dual"]))
    bad = np.abs(gap - want) > 1e-4 * np.abs(want) + f32
    assert not bad.any(), (np.flatnonzero(bad) + 1, gap[bad], want[bad])
    assert all(g >= -1e-6 for g in port.history["gap"])


@pytest.mark.parametrize("accel", ["nesterov:16", "catalyst:20"])
def test_accel_beats_plain_rounds_to_gap(pinned, accel):
    plain = pinned["none"][1].history["round"][-1]
    fast = pinned[accel][1].history["round"][-1]
    assert plain >= 1.3 * fast, (accel, fast, plain)


@pytest.mark.parametrize("accel", ["nesterov:16", "catalyst:20"])
def test_accel_moves_zero_extra_floats(illcond, accel):
    r_none = _solve(illcond, "none", rounds=6, eps=0.0)
    r_acc = _solve(illcond, accel, rounds=6, eps=0.0)
    for key in ("comm_floats", "comm_vectors", "comm_bytes", "comm_psums"):
        assert r_none.history[key] == r_acc.history[key], key
    assert comm.accel_hops(accel) == ()


def test_accel_composes_with_ef_compression(illcond):
    r = _solve(illcond, "nesterov:16", rounds=60, compress="topk",
               compress_k=16)
    gaps = r.history["gap"]
    assert all(g >= -1e-6 for g in gaps) and gaps[-1] < gaps[0]
    assert float(r.state.ef.abs().max()) > 0
    assert r.state.v_prev is not None


def test_accel_composes_with_the_kernel_solver(illcond):
    cfg = CoCoAConfig(accel="nesterov:16",
                      **{**PIN_CFG, "solver": "sdca_kernel"})
    r = solve(cfg, *illcond, rounds=12, gap_every=4, seed=0)
    gaps = r.history["gap"]
    assert all(np.isfinite(g) and g >= -1e-6 for g in gaps)
    assert gaps[-1] < gaps[0]


def test_accel_on_the_2d_mesh():
    """Momentum on a (2, 2) one-card mesh: v_prev is the padded w, the
    z-exchange schedule runs underneath, and the run certifies."""
    csr, y = load("tiny_sparse")
    fs, yp, mk = partition_sparse(csr, y, 2, seed=0, M=2, device="cpu")
    r = solve(CoCoAConfig.adding(2, loss="hinge", lam=1e-3, H=128,
                                 backend="shard_map", model_axis="model",
                                 solver="sdca_kernel", accel="nesterov:16"),
              fs, yp, mk, rounds=6, gap_every=2,
              mesh=make_test_mesh((2, 2), device="cpu"))
    gaps = r.history["gap"]
    assert all(np.isfinite(g) and g >= -1e-6 for g in gaps)
    assert gaps[-1] < gaps[0] and r.state.v_prev.shape == (fs.d_padded,)


def test_state_from_reference_carries_the_momentum(illcond):
    """A reference state three accelerated rounds in comes across with
    its momentum leaves; the next round, on the draws its carried key
    makes, matches the reference's own next round."""
    X, y = ref_make(PIN["n"], PIN["d"], seed=PIN["seed"], cond=PIN["cond"])
    ref_data = ref_partition(X, y, PIN["K"], seed=PIN["seed"])
    cfg = dict(PIN_CFG, accel="catalyst:20")
    mid = ref_solve(RefConfig(**cfg), *ref_data, rounds=3, seed=0)
    nxt = ref_solve(RefConfig(**cfg), *ref_data, rounds=1, state=mid.state)
    st = state_from_reference(tp.state_arrays(mid.state), device="cpu")
    np.testing.assert_array_equal(st.v_prev.numpy(),
                                  np.asarray(mid.state.v_prev))
    assert float(st.accel_a) == float(mid.state.accel_a)
    hook = tp.reference_visit_orders(mid.state.rng, 1, PIN["K"],
                                     PIN["n"] // PIN["K"], PIN_CFG["H"],
                                     "draws")
    port = solve(CoCoAConfig(**cfg), *illcond, rounds=1, state=st,
                 visit_orders=hook)
    np.testing.assert_allclose(port.history["gap"], nxt.history["gap"],
                               rtol=1e-4)
    np.testing.assert_allclose(port.state.w.numpy(),
                               np.asarray(nxt.state.w), rtol=1e-4,
                               atol=1e-6)


@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_accel.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("accel", ["nesterov:16", "catalyst:20"])
def test_cuda_kernel_first_accelerated_round_is_plain(card, accel):
    """Through the dense kernel on the card: the first accelerated round
    is the plain round bit for bit, and the run then falls as the CPU's."""
    X, y = make_classification(PIN["n"], PIN["d"], seed=PIN["seed"],
                               cond=PIN["cond"])
    data = partition(X, y, PIN["K"], seed=PIN["seed"], device=card)
    kw = {**PIN_CFG, "solver": "sdca_kernel"}
    plain = solve(CoCoAConfig(**kw), *data, rounds=1, seed=0)
    first = solve(CoCoAConfig(accel=accel, **kw), *data, rounds=1, seed=0)
    assert torch.equal(plain.state.w, first.state.w)
    assert torch.equal(plain.state.alpha, first.state.alpha)
    card_run = solve(CoCoAConfig(accel=accel, **kw), *data, rounds=8,
                     seed=0)
    cpu = partition(X, y, PIN["K"], seed=PIN["seed"], device="cpu")
    cpu_run = solve(CoCoAConfig(accel=accel, **kw), *cpu, rounds=8, seed=0)
    np.testing.assert_allclose(card_run.history["gap"],
                               cpu_run.history["gap"], rtol=1e-4)
