"""The port's checkpoints against the reference's: the same keys and
on-disk format both ways, the async manager, and a resumed run.

Either package must restore the other's files: the reference's
`save_tree` read by the port's `restore_tree` and the other way round,
every dtype equal (bfloat16 and float8 as their bits), and a port
`CoCoAState` checkpoint through the reference trainer's restore template
(`init_state(...)._asdict()`, which asks for the threefry `rng`). A
resumed port run must equal an uninterrupted one bit for bit on the CPU
(its visit orders come from (seed, rounds)), and the reference's own
resumed run within its test's 1e-5 on the reference's orders
(tests/test_runtime.py::test_cocoa_checkpoint_restart_equivalence).
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as ref_restore, save_tree as ref_save
from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.core.cocoa import CoCoAState as RefState, init_state as ref_init
from repro.data import make_classification, partition as ref_partition
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.core import (CoCoAConfig, init_state, solve,
                              state_from_tree, state_to_tree)
from repro_torch.data import partition

import torch_parity as tp

# name -> (torch dtype, numpy dtype of the reference's array)
DTYPES = {"float32": (torch.float32, np.float32),
          "int32": (torch.int32, np.int32),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
          "float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
          "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2)}


def _tree(torch_side: bool):
    """The reference test's tree (a nested dict and list, bfloat16, a 0-d
    int32) plus a None leaf, as tensors or as jax arrays."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    if torch_side:
        return {"a": torch.from_numpy(a),
                "b": [torch.ones(4, dtype=torch.bfloat16),
                      torch.zeros((), dtype=torch.int32)], "c": None}
    return {"a": jnp.asarray(a), "b": [jnp.ones(4, jnp.bfloat16),
                                       jnp.zeros((), jnp.int32)], "c": None}


def _manifest(path, step):
    return json.loads((path / f"step_{step}" / "manifest.json").read_text())


def test_checkpoint_roundtrip_with_the_reference_keys(tmp_path):
    save_tree(tmp_path / "port", 7, _tree(True), {"note": "x"})
    ref_save(tmp_path / "ref", 7, _tree(False), {"note": "x"})
    mine, theirs = _manifest(tmp_path / "port", 7), _manifest(
        tmp_path / "ref", 7)
    assert list(mine["keys"]) == list(theirs["keys"]) == ["a", "b/0", "b/1"]
    assert mine["keys"] == theirs["keys"] and mine["extra"] == {"note": "x"}
    out, manifest = restore_tree(tmp_path / "port", _tree(True))
    assert manifest["step"] == 7 and out["c"] is None
    assert torch.equal(out["a"], _tree(True)["a"])
    assert out["b"][0].dtype == torch.bfloat16 and torch.equal(
        out["b"][0], torch.ones(4, dtype=torch.bfloat16))
    assert out["b"][1].dtype == torch.int32 and out["b"][1].dim() == 0


def test_namedtuple_and_tuple_leaves_keep_the_reference_paths(tmp_path):
    st = init_state(5, 2, 3, device="cpu")
    save_tree(tmp_path / "port", 1, {"s": st, "t": (st.w,)})
    ref_save(tmp_path / "ref", 1, {"s": ref_init(5, 2, 3),
                                   "t": (jnp.zeros(5),)})
    ref_keys = set(_manifest(tmp_path / "ref", 1)["keys"])
    # the reference state has `rng`, the port's a Python int for `rounds`
    assert set(_manifest(tmp_path / "port", 1)["keys"]) == (
        ref_keys - {"s/rng"})


def test_manager_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    w = torch.ones(8)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": w * s})
    mgr.wait()
    assert mgr.latest_step() == 4
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert not list(tmp_path.glob(".tmp_step_*"))
    out, _ = mgr.restore({"w": w})
    assert torch.equal(out["w"], torch.full((8,), 4.0))


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The writer thread writes the state as of `save`, not a later
    in-place edit of the caller's tensor."""
    mgr = CheckpointManager(tmp_path, keep=3, async_write=True)
    w = torch.zeros(4)
    mgr.save(1, {"w": w})
    w += 5.0
    mgr.wait()
    out, _ = mgr.restore({"w": w})
    assert torch.equal(out["w"], torch.zeros(4))


def test_sync_manager_and_no_temp_dirs(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, async_write=False)
    for s in (3, 5):
        mgr.save(s, {"x": torch.arange(3)})
    assert [p.name for p in tmp_path.iterdir()] == ["step_5"]
    with pytest.raises(FileNotFoundError):
        restore_tree(tmp_path / "empty", {"x": 0})


def test_restore_reads_only_the_template_keys(tmp_path):
    save_tree(tmp_path, 2, {"w": torch.ones(3), "extra": torch.zeros(2)})
    out, _ = restore_tree(tmp_path, {"w": 0})
    assert list(out) == ["w"] and torch.equal(out["w"], torch.ones(3))
    with pytest.raises(KeyError):
        restore_tree(tmp_path, {"w": 0, "ef": 0})


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_reference_checkpoint_restores_in_the_port(tmp_path, name):
    tdt, ndt = DTYPES[name]
    vals = np.linspace(-3, 3, 12).reshape(3, 4)
    ref_save(tmp_path, 4, {"x": jnp.asarray(vals.astype(ndt)),
                           "n": {"k": jnp.arange(5)}})
    out, man = restore_tree(tmp_path, {"x": 0, "n": {"k": 0}})
    assert man["keys"]["x"]["dtype"] == name
    assert out["x"].dtype == tdt
    want = torch.from_numpy(vals.astype(ndt).astype(np.float32))
    assert torch.equal(out["x"].float(), want)
    assert torch.equal(out["n"]["k"], torch.arange(5, dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_checkpoint_restores_in_the_reference(tmp_path, name):
    tdt, ndt = DTYPES[name]
    x = torch.linspace(-3, 3, 12).reshape(3, 4).to(tdt)
    save_tree(tmp_path, 4, {"x": x, "n": {"k": torch.arange(5)}})
    out, man = ref_restore(tmp_path, {"x": jnp.zeros(1), "n": {"k": 0}})
    assert man["keys"]["x"]["dtype"] == name
    assert out["x"].dtype == np.dtype(ndt)
    np.testing.assert_array_equal(np.asarray(out["x"]).astype(np.float32),
                                  x.float().numpy())
    np.testing.assert_array_equal(np.asarray(out["n"]["k"]), np.arange(5))


@pytest.mark.parametrize("seed", [0, 7])
def test_port_state_restores_through_the_reference_cli_template(tmp_path,
                                                                 seed):
    """The reference trainer restores `init_state(...)._asdict()`, which
    asks for every leaf of its state, the threefry key included."""
    rng = np.random.default_rng(seed)
    st = init_state(6, 2, 3, device="cpu")._replace(
        w=torch.from_numpy(rng.standard_normal(6).astype(np.float32)),
        alpha=torch.from_numpy(rng.random((2, 3)).astype(np.float32)),
        rounds=9)
    save_tree(tmp_path, 9, state_to_tree(st, seed=seed))
    loaded, man = ref_restore(tmp_path, ref_init(6, 2, 3)._asdict())
    ref = RefState(**loaded)
    np.testing.assert_array_equal(np.asarray(ref.rng),
                                  np.asarray(jax.random.PRNGKey(seed)))
    assert int(ref.rounds) == 9 and np.asarray(ref.rounds).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(ref.w), st.w.numpy())
    np.testing.assert_array_equal(np.asarray(ref.alpha), st.alpha.numpy())
    back = state_from_tree(loaded, "cpu")
    assert back.rounds == 9 and torch.equal(back.alpha, st.alpha)


def test_checkpoint_without_ef_reads_under_a_template_without_it(tmp_path):
    """A checkpoint from before the wire stack has no `ef` leaf: a template
    that asks for it raises KeyError (the trainer then retries without it
    and starts from zero residuals, test_torch_boundaries)."""
    tree = state_to_tree(init_state(4, 2, 3, device="cpu"))
    tree.pop("ef")
    save_tree(tmp_path, 3, tree)
    like = dict.fromkeys(("w", "alpha", "rounds", "alpha_bar", "ef"), 0)
    with pytest.raises(KeyError):
        restore_tree(tmp_path, like)
    like.pop("ef")
    out, _ = restore_tree(tmp_path, like)
    assert set(out) == {"w", "alpha", "rounds", "alpha_bar"}


@pytest.fixture(scope="module")
def problem():
    X, y = make_classification(1024, 32, seed=0)
    return ref_partition(X, y, 8, seed=1), partition(X, y, 8, seed=1,
                                                     device="cpu")


def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path, problem):
    _, (Xp, yp, mk) = problem
    cfg = CoCoAConfig.adding(8, loss="hinge", lam=1e-3, H=128)
    full = solve(cfg, Xp, yp, mk, rounds=20, gap_every=20, seed=5)
    half = solve(cfg, Xp, yp, mk, rounds=10, gap_every=10, seed=5)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(10, state_to_tree(half.state, seed=5))
    mgr.wait()
    del half
    loaded, man = mgr.restore(dict.fromkeys(
        ("w", "alpha", "rounds", "alpha_bar", "ef"), 0))
    st = state_from_tree(loaded, "cpu")
    assert man["step"] == st.rounds == 10
    resumed = solve(cfg, Xp, yp, mk, rounds=10, gap_every=10, seed=5,
                    state=st)
    for leaf in ("w", "alpha", "alpha_bar", "ef"):
        assert torch.equal(getattr(resumed.state, leaf),
                           getattr(full.state, leaf)), leaf
    assert resumed.state.rounds == 20
    assert resumed.history["gap"][-1] == full.history["gap"][-1]


def test_resumed_run_matches_the_reference_resumed_run(tmp_path, problem):
    """Both packages stop at round 10, checkpoint, restart; the port runs
    the reference's visit orders (the resumed half from the key the
    reference's checkpoint carries) and lands within 1e-5."""
    (rX, ry, rm), (Xp, yp, mk) = problem
    K, nk, H = 8, yp.shape[1], 128
    ref_half = ref_solve(RefConfig.adding(K, loss="hinge", lam=1e-3, H=H),
                         rX, ry, rm, rounds=10, gap_every=10, seed=5)
    ref_save(tmp_path / "ref", 10, ref_half.state._asdict())
    loaded, _ = ref_restore(tmp_path / "ref", ref_half.state._asdict())
    ref_st = RefState(**loaded)
    ref_res = ref_solve(RefConfig.adding(K, loss="hinge", lam=1e-3, H=H),
                        rX, ry, rm, rounds=10, gap_every=10, state=ref_st)

    cfg = CoCoAConfig.adding(K, loss="hinge", lam=1e-3, H=H)
    half = solve(cfg, Xp, yp, mk, rounds=10, gap_every=10, seed=5,
                 visit_orders=tp.reference_visit_orders(5, 10, K, nk, H,
                                                        "draws"))
    save_tree(tmp_path / "port", 10, state_to_tree(half.state, seed=5))
    loaded, _ = restore_tree(tmp_path / "port", dict.fromkeys(
        ("w", "alpha", "rounds", "alpha_bar", "ef"), 0))
    resumed = solve(cfg, Xp, yp, mk, rounds=10, gap_every=10,
                    state=state_from_tree(loaded, "cpu"),
                    visit_orders=tp.reference_visit_orders(
                        ref_st.rng, 10, K, nk, H, "draws"))
    assert abs(resumed.history["gap"][-1] - ref_res.history["gap"][-1]) < 1e-5
    np.testing.assert_allclose(resumed.state.w.numpy(),
                               np.asarray(ref_res.state.w), atol=1e-5)
