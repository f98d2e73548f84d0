"""The port's CoCoA+ driver against the reference's, round by round.

Both sides run on the same numpy data with the same visit orders: the
reference draws them from its threefry keys, and the port is fed those
draws through `solve(visit_orders=...)`. Per-round gaps must match within
1e-4 relative: float32 dot order differs between XLA and torch, and the
difference compounds over 10 rounds.
"""
import numpy as np
import pytest
import torch

from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.data import load, partition as ref_partition
from repro.data.sparse import partition_sparse as ref_partition_sparse
from repro_torch.core import CoCoAConfig, solve, state_from_reference
from repro_torch.data import partition, partition_sparse

import torch_parity as tp

K = 8
GAP_RTOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    X, y = load("tiny")
    return ref_partition(X, y, K), partition(X, y, K, device="cpu")


@pytest.fixture(scope="module")
def tiny_sparse():
    csr, y = load("tiny_sparse")
    return (ref_partition_sparse(csr, y, K),
            partition_sparse(csr, y, K, device="cpu"))


def _gaps_match(ref_hist, port_hist):
    assert port_hist["round"] == ref_hist["round"]
    np.testing.assert_allclose(port_hist["gap"], ref_hist["gap"],
                               rtol=GAP_RTOL)
    np.testing.assert_allclose(port_hist["primal"], ref_hist["primal"],
                               rtol=GAP_RTOL)
    assert port_hist["comm_floats"] == ref_hist["comm_floats"]


def _parity(ref_data, port_data, kind, rounds, **cfg):
    ref = ref_solve(RefConfig.adding(K, **cfg), *ref_data, rounds=rounds,
                    seed=0)
    nk = port_data[1].shape[1]
    hook = tp.reference_visit_orders(0, rounds, K, nk, cfg["H"], kind)
    port = solve(CoCoAConfig.adding(K, **cfg), *port_data, rounds=rounds,
                 seed=0, visit_orders=hook)
    _gaps_match(ref.history, port.history)
    return ref, port


def test_dense_kernel_solver_matches_reference(tiny):
    _, port = _parity(*tiny, "permutation", 10, solver="sdca_kernel",
                      lam=1e-3, H=128)
    assert port.history["gap"][-1] < port.history["gap"][0]
    assert all(t > 0 for t in port.history["execute_s"])


@pytest.mark.parametrize("reg", ["l2", "elastic:0.5"])
def test_sparse_kernel_solver_matches_reference(tiny_sparse, reg):
    _, port = _parity(*tiny_sparse, "permutation", 10,
                      solver="sdca_sparse_kernel", lam=1e-3, H=128, reg=reg)
    assert port.history["gap"][-1] < port.history["gap"][0]


def test_sparse_kernel_two_passes_smooth_hinge(tiny_sparse):
    # H = 2 nk -> two passes per round; the smooth loss takes every row
    _parity(*tiny_sparse, "permutation", 4, solver="sdca_kernel",
            loss="smooth_hinge", lam=1e-3, H=256)


def test_eager_dense_solver_matches_reference(tiny):
    _parity(*tiny, "draws", 5, solver="sdca", lam=1e-3, H=64)


@pytest.mark.parametrize("reg", ["l2", "l1s:0.5"])
def test_eager_sparse_solver_matches_reference(tiny_sparse, reg):
    _parity(*tiny_sparse, "draws", 5, solver="sdca", lam=1e-3, H=64,
            reg=reg)


def test_average_iterates_and_averaging_match_reference(tiny_sparse):
    ref_data, port_data = tiny_sparse
    cfg = dict(solver="sdca_kernel", lam=1e-3, H=128, average_iterates=True)
    ref = ref_solve(RefConfig.averaging(K, **cfg), *ref_data, rounds=4,
                    seed=0)
    hook = tp.reference_visit_orders(0, 4, K, 128, 128, "permutation")
    port = solve(CoCoAConfig.averaging(K, **cfg), *port_data, rounds=4,
                 seed=0, visit_orders=hook)
    _gaps_match(ref.history, port.history)


@pytest.mark.parametrize("solver,kind", [("sdca_kernel", "permutation"),
                                         ("sdca", "draws")])
def test_resume_from_reference_state(tiny_sparse, solver, kind):
    """state_from_reference carries a JAX mid-run state across: the next
    round, fed the permutations the reference's carried key draws,
    matches the reference's own next round."""
    ref_data, port_data = tiny_sparse
    cfg = dict(solver=solver, lam=1e-3, H=128)
    mid = ref_solve(RefConfig.adding(K, **cfg), *ref_data, rounds=3, seed=0)
    nxt = ref_solve(RefConfig.adding(K, **cfg), *ref_data, rounds=1,
                    state=mid.state)
    arrays = tp.state_arrays(mid.state)
    state = state_from_reference(arrays, device="cpu")
    assert state.rounds == 3
    hook = tp.reference_visit_orders(mid.state.rng, 1, K, 128, 128, kind)
    port = solve(CoCoAConfig.adding(K, **cfg), *port_data, rounds=1,
                 state=state, visit_orders=hook)
    np.testing.assert_allclose(port.history["gap"], nxt.history["gap"],
                               rtol=GAP_RTOL)
    np.testing.assert_allclose(tp.to_np(port.state.w),
                               np.asarray(nxt.state.w), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tp.to_np(port.state.alpha),
                               np.asarray(nxt.state.alpha), rtol=1e-4,
                               atol=1e-6)
    assert port.state.rounds == 4


def test_adding_beats_averaging_with_the_ports_generator(tiny_sparse):
    """The Fig. 1 ordering (tests/test_convergence_paper.py:44), with the
    port's own visit draws: add reaches gap 1e-4 in >= 1.3x fewer rounds."""
    _, (sh, yp, mk) = tiny_sparse
    rounds = {}
    for agg in ("add", "average"):
        cfg = CoCoAConfig(aggregator=agg, loss="smooth_hinge", lam=1e-3,
                          H=256)
        r = solve(cfg, sh, yp, mk, rounds=120, eps_gap=1e-4, seed=0)
        assert r.history["gap"][-1] <= 1e-4, (agg, r.history["gap"][-1])
        assert all(g >= -1e-6 for g in r.history["gap"])
        rounds[agg] = r.history["round"][-1]
    assert rounds["average"] >= 1.3 * rounds["add"], rounds


def test_visit_orders_hook_shape_is_checked(tiny):
    _, port_data = tiny
    cfg = CoCoAConfig.adding(K, solver="sdca_kernel", lam=1e-3, H=128)
    with pytest.raises(ValueError, match=r"takes \(8, 128\)"):
        solve(cfg, *port_data, rounds=1,
              visit_orders=lambda t: torch.zeros((K, 64), dtype=torch.long))


def test_default_draws_are_seeded_per_round(tiny_sparse):
    """Same seed, same run; a run resumed mid-way draws what the
    uninterrupted run drew (round r's draws depend on (seed, r) only)."""
    _, port_data = tiny_sparse
    cfg = CoCoAConfig.adding(K, solver="sdca_kernel", lam=1e-3, H=128)
    full = solve(cfg, *port_data, rounds=4, seed=7)
    again = solve(cfg, *port_data, rounds=4, seed=7)
    assert full.history["gap"] == again.history["gap"]
    half = solve(cfg, *port_data, rounds=2, seed=7)
    rest = solve(cfg, *port_data, rounds=2, seed=7, state=half.state)
    np.testing.assert_allclose(rest.history["gap"], full.history["gap"][2:],
                               rtol=1e-6)
