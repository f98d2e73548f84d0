"""The port's multi-process backend against its one-process rounds and the
reference's.

Ranks are spawned on the CPU (`launch.mesh.spawn_ranks`: gloo, a file
store in a temporary directory, no fixed port) and run `solve` on a
process mesh (`tests/torch_parity.py::solve_on_ranks`), every job fed the
reference's visit orders. Each run is held to:

  * the port's one-process run on the same orders -- the vmap backend at
    M = 1, the one-card mesh of the same shape at M > 1 -- per round
    within 1e-6 relative (the reference's shard_map-vs-vmap tolerance,
    tests/test_sharded.py), with the same wire volume; gloo sums in an
    order of its own, so not bit for bit;
  * the reference's vmap run on those orders within 1e-4 relative
    (tests/test_torch_cocoa.py's bar);
  * every rank's history being the same.

Each spawn has a time limit of 110 s; a rank that fails or overruns
fails the test with its traceback. The `cuda` test puts the ranks on one
card (`python -m pytest -m cuda tests/test_torch_dist.py` there).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.data import load as ref_load, partition as ref_partition
from repro.data.sparse import partition_sparse as ref_partition_sparse
from repro_torch.core import CoCoAConfig, solve
from repro_torch.launch import cocoa_train
from repro_torch.launch.mesh import (Mesh, initialize_distributed,
                                     make_test_mesh, spawn_ranks)

import torch_parity as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANK_RTOL = 1e-6          # process mesh vs the one-process run
REF_RTOL = 1e-4           # vs the reference's vmap run
SPAWN_TIMEOUT = 110
ROUNDS = 4
SEED = 1
LAM = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _job(shape, axes, data, cfg, M=1, rounds=ROUNDS, orders=True, **extra):
    """A job: the mesh, the data, the config and the reference's visit
    orders for it (the eager solvers walk (K, H) draws, the kernels (K,
    nk) permutations; `orders=False`: the port's own draws, which the
    one-process run draws too). `extra` goes into the job: `budgets`,
    and `reference=False` for a run the reference does not make."""
    K = int(np.prod([s for s, a in zip(shape, axes) if a != "model"]))
    job = dict(shape=shape, axes=axes, data=data, K=K, M=M, rounds=rounds,
               seed=SEED, cfg=dict(backend="shard_map", lam=LAM,
                                   loss="hinge", **cfg), **extra)
    if not orders:
        return job
    nk = tp.job_data(job)[1].shape[1]
    kind = "permutation" if cfg["solver"] == "sdca_kernel" else "draws"
    orders = tp.visit_orders_from_keys(
        tp.round_keys(jax.random.PRNGKey(SEED), rounds), K, nk, cfg["H"],
        kind)
    job["orders"] = [o.numpy() for o in orders]
    return job


KERNEL = dict(solver="sdca_kernel", H=128)
EAGER = dict(solver="sdca", H=64)
TOPK = dict(compress="topk", compress_k=16, gather=True)

JOBS2 = {
    "dense-kernel": _job((2,), ("data",), "tiny", KERNEL),
    "sparse-kernel": _job((2,), ("data",), "tiny_sparse", KERNEL),
    "dense-eager-nesterov": _job((2,), ("data",), "tiny",
                                 dict(EAGER, accel="nesterov:16"),
                                 rounds=6),
    # the importance draw needs every worker's row distribution (gathered
    # over the data row); the deadline budgets are global, a row a worker
    "dense-importance": _job((2,), ("data",), "tiny",
                             dict(EAGER, solver="sdca_importance"),
                             orders=False, reference=False),
    "dense-deadline": _job((2,), ("data",), "tiny",
                           dict(EAGER, solver="sdca_deadline"),
                           budgets=[[64, 20]] * ROUNDS, reference=False),
}
JOBS4 = {
    "dense-kernel-flat": _job((4,), ("data",), "tiny", KERNEL),
    "sparse-kernel-flat": _job((4,), ("data",), "tiny_sparse", KERNEL),
    "sparse-kernel-hier2": _job((4,), ("data",), "tiny_sparse",
                                dict(KERNEL, topology="hier:2")),
    "sparse-kernel-a2a": _job((4,), ("data",), "tiny_sparse",
                              dict(KERNEL, topology="a2a")),
    "sparse-topk-gather-hier2": _job((4,), ("data",), "tiny_sparse",
                                     dict(KERNEL, topology="hier:2",
                                          **TOPK)),
    "dense-int8": _job((4,), ("data",), "tiny",
                       dict(KERNEL, compress="int8")),
    "mixed-radix-hier2": _job((2, 2), ("pod", "data"), "tiny_sparse",
                              dict(KERNEL, topology="hier:2",
                                   data_axis=("pod", "data"))),
    "dense-2x2": _job((2, 2), ("data", "model"), "tiny",
                      dict(EAGER, model_axis="model"), M=2),
    "sparse-2x2": _job((2, 2), ("data", "model"), "tiny_sparse",
                       dict(EAGER, model_axis="model"), M=2),
    "sparse-2x2-topk-hier2": _job((2, 2), ("data", "model"), "tiny_sparse",
                                  dict(EAGER, model_axis="model",
                                       topology="hier:2", **TOPK), M=2),
}
# the z-exchange kernel across processes: the per-block kernel on every
# rank, the model column's all_reduce between its launches (the
# reference's vmap run is the 1-D walk, another schedule: not compared)
ZX4 = {
    "zx-across-processes": _job((2, 2), ("data", "model"), "tiny_sparse",
                                dict(KERNEL, model_axis="model"), M=2,
                                reference=False),
}
ERRORS4 = {
    "world-mismatch": _job((2,), ("data",), "tiny", KERNEL),
}


def _spawn(world, jobs):
    names = list(jobs)
    per_rank = spawn_ranks(tp.solve_on_ranks, world,
                           ([jobs[n] for n in names],),
                           timeout=SPAWN_TIMEOUT)
    return {n: [r[i] for r in per_rank] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def runs():
    out = _spawn(2, JOBS2)
    out.update(_spawn(4, {**JOBS4, **ZX4, **ERRORS4}))
    return out


def _one_process(job):
    """The port's one-process run of a job on the same orders."""
    X, y, mask = tp.job_data(job)
    cfg = dict(job["cfg"])
    mesh = None
    if job["M"] > 1 or len(job["shape"]) > 1:
        mesh = make_test_mesh(job["shape"], job["axes"], device="cpu")
    else:
        cfg["backend"] = "vmap"
    budgets = job.get("budgets")
    return solve(CoCoAConfig(**cfg), X, y, mask, rounds=job["rounds"],
                 seed=SEED, visit_orders=tp.job_orders(job), mesh=mesh,
                 budget_fn=None if budgets is None else (
                     lambda t: torch.as_tensor(budgets[t])))


def _reference(job):
    """The reference's vmap run on its own orders (its seed): dense rows,
    or SparseShards with the global column ids at any M."""
    cfg = {k: v for k, v in job["cfg"].items()
           if k not in ("backend", "model_axis", "data_axis")}
    if job["data"] == "tiny":
        X, y = ref_load("tiny")
        data = ref_partition(X, y, job["K"], seed=0)
    else:
        csr, y = ref_load("tiny_sparse")
        data = ref_partition_sparse(csr, y, job["K"], seed=0)
    return ref_solve(RefConfig(**cfg), *data, rounds=job["rounds"],
                     gap_every=1, seed=SEED)


def _assemble(ranks, job):
    """The one-process state from the ranks' slices: w concatenated over
    the model shards (model column of worker 0), alpha stacked over the
    workers (model shard 0 of each)."""
    model = "model" if job["M"] > 1 else None
    w = np.concatenate([r["w"] for r in ranks
                        if all(v == 0 for a, v in r["coords"].items()
                               if a != model)])
    alpha = np.concatenate([r["alpha"] for r in ranks
                            if model is None or r["coords"][model] == 0])
    return w, alpha


@pytest.mark.parametrize("name", list(JOBS2) + list(JOBS4))
def test_process_mesh_matches_one_process_and_reference(runs, name):
    job = {**JOBS2, **JOBS4}[name]
    ranks = runs[name]
    for r in ranks[1:]:                   # every rank, the same history
        for key in ("gap", "primal", "dual", "comm_floats"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
    one = _one_process(job)
    np.testing.assert_allclose(ranks[0]["gap"], one.history["gap"],
                               rtol=RANK_RTOL)
    np.testing.assert_allclose(ranks[0]["primal"], one.history["primal"],
                               rtol=RANK_RTOL)
    assert list(ranks[0]["comm_floats"]) == one.history["comm_floats"]
    w, alpha = _assemble(ranks, job)
    np.testing.assert_allclose(w, tp.to_np(one.state.w), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(alpha, tp.to_np(one.state.alpha),
                               atol=1e-6, rtol=1e-5)
    if job.get("reference", True) and not (job["M"] > 1
                                           and job["cfg"].get("gather")):
        # (a gather at M > 1 splits k over the shards: the reference's
        # vmap run, at M = 1, sends another message)
        ref = _reference(job)
        np.testing.assert_allclose(ranks[0]["gap"], ref.history["gap"],
                                   rtol=REF_RTOL)
        if job["M"] == 1 and not job["cfg"].get("compress"):
            assert (list(ranks[0]["comm_floats"])
                    == ref.history["comm_floats"])
    if job["cfg"].get("gather") and job["cfg"].get("topology") != "flat":
        # hier gather: the measured post-dedup inter volume, as the
        # one-process run measured it and at most its bound
        got = ranks[0]["measured"]["inter_gather"]
        assert got == one.tracer.measured["inter_gather"]
        bound = job["rounds"] * [h.floats for h in one.tracer.hops
                                 if h.name == "inter_gather"][0]
        assert 0 < got <= bound
    assert ranks[0]["gap"][-1] < ranks[0]["gap"][0]


def test_zx_kernel_across_processes_matches_one_process(runs):
    """`sdca_kernel` on a 2 x 2 process mesh runs the z-exchange schedule
    on every rank's block: every rank the same history, and per round the
    one-card 2 x 2 mesh's within 1e-6 relative, with the same wire plan
    (the model hop's exchanges of B floats)."""
    job = ZX4["zx-across-processes"]
    ranks = runs["zx-across-processes"]
    for r in ranks:
        assert "error" not in r, r.get("error")
    for r in ranks[1:]:
        for key in ("gap", "primal", "dual", "comm_floats"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
    one = _one_process(job)
    np.testing.assert_allclose(ranks[0]["gap"], one.history["gap"],
                               rtol=RANK_RTOL)
    np.testing.assert_allclose(ranks[0]["primal"], one.history["primal"],
                               rtol=RANK_RTOL)
    assert list(ranks[0]["comm_floats"]) == one.history["comm_floats"]
    assert any(h.name == "model_zx" for h in one.tracer.hops)
    w, alpha = _assemble(ranks, job)
    np.testing.assert_allclose(w, tp.to_np(one.state.w), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(alpha, tp.to_np(one.state.alpha),
                               atol=1e-6, rtol=1e-5)
    assert ranks[0]["gap"][-1] < ranks[0]["gap"][0]


def test_mesh_of_another_size_is_refused(runs):
    for r in runs["world-mismatch"]:
        assert "has 2 positions but the process group has 4" in r["error"]


def test_accelerated_ranks_carry_their_momentum(runs):
    """Momentum runs on each rank's own slices: after 6 accelerated rounds
    across 2 ranks every rank holds the last round's (v, alpha) and the
    catalyst scalar for its own worker, equal to the one-process run's
    momentum leaves sliced to that rank."""
    job = JOBS2["dense-eager-nesterov"]
    ranks = runs["dense-eager-nesterov"]
    one = _one_process(job).state
    v_prev = tp.to_np(one.v_prev)
    alpha_prev = tp.to_np(one.alpha_prev)
    for k, r in enumerate(ranks):
        assert r["coords"] == {"data": k}
        np.testing.assert_allclose(r["v_prev"], v_prev, atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(r["alpha_prev"], alpha_prev[k:k + 1],
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(r["accel_a"], tp.to_np(one.accel_a),
                                   rtol=1e-6)
        assert r["v_prev"].shape == r["w"].shape
        assert r["alpha_prev"].shape == r["alpha"].shape


# ----------------------------------------------------------------------------
# the mesh value and initialize_distributed, without processes
# ----------------------------------------------------------------------------

def test_initialize_distributed_without_a_world(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(num_processes=2, device="cpu")


def test_process_mesh_coordinates_are_row_major():
    mesh = Mesh(("pod", "data", "model"), (2, 3, 2), torch.device("cpu"),
                rank=9)
    assert mesh.is_process and mesh.size == 12
    assert mesh.coords() == {"pod": 1, "data": 1, "model": 1}
    for r in range(12):
        assert mesh.rank_at(mesh.coords(r)) == r
    assert not make_test_mesh((2, 2), device="cpu").is_process


# ----------------------------------------------------------------------------
# the CLI under torch.distributed.run
# ----------------------------------------------------------------------------

CLI = ["--device", "cpu", "--dataset", "tiny", "--rounds", "3", "--H", "64",
       "--eps", "0", "--backend", "shard_map"]


def _torchrun(nproc, argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.cocoa_train",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT)


def _final(out):
    """The port's closing line (after the records' `final: P=...`)."""
    return [ln for ln in out.splitlines() if ln.startswith("final: rounds=")]


def test_cli_runs_under_torchrun(capsys, tmp_path):
    m = tmp_path / "m.jsonl"
    p = _torchrun(2, CLI + ["--workers", "2", "--metrics-out", str(m)])
    assert p.returncode == 0, p.stderr[-3000:]
    finals = _final(p.stdout)
    assert len(finals) == 1, p.stdout          # rank 0 prints, alone
    assert "ranks=2" in finals[0]
    # rank 0 writes the one metrics file: one record a certified round
    assert sorted(f.name for f in tmp_path.iterdir()) == ["m.jsonl"]
    recs = [json.loads(ln) for ln in m.read_text().splitlines()]
    assert [r["round"] for r in recs] == [2, 3]
    assert f"gap={recs[-1]['gap']:.3e}" in finals[0]
    cocoa_train.main(CLI + ["--workers", "2"])
    one = _final(capsys.readouterr().out)[0]
    gap = lambda line: line.split("gap=")[1].split()[0]
    assert gap(finals[0]) == gap(one)


def test_cli_world_size_must_match_the_mesh():
    p = _torchrun(2, CLI + ["--workers", "4"])
    assert p.returncode != 0
    assert "has 4 positions but 2 ranks were started" in p.stderr


# ----------------------------------------------------------------------------
# on the card: the ranks share cuda:0
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_dist.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_cuda_ranks_share_the_card(card):
    """Two ranks on cuda:0 through the kernels (one launch a round each)
    and a 2 x 2 dense mesh of four through the eager solver, against the
    one-process runs on the card."""
    from repro_torch.kernels import build
    build.build_all(("local_sdca", "sparse_sdca_pipelined"))
    for world, jobs in ((2, {n: JOBS2[n] for n in ("dense-kernel",
                                                   "sparse-kernel")}),
                        (4, {"dense-2x2": JOBS4["dense-2x2"]})):
        jobs = {n: dict(j, device=str(card)) for n, j in jobs.items()}
        got = _spawn(world, jobs)
        for name, job in jobs.items():
            X, y, mask = tp.job_data(job)
            if isinstance(X, torch.Tensor):
                X = X.to(card)
            else:
                X = type(X)(X.cols.to(card), X.vals.to(card),
                            X.nnz.to(card), d=X.d)
            cfg = dict(job["cfg"])
            mesh = None
            if job["M"] > 1:
                mesh = make_test_mesh(job["shape"], job["axes"], device=card)
            else:
                cfg["backend"] = "vmap"
            one = solve(CoCoAConfig(**cfg), X, y.to(card), mask.to(card),
                        rounds=job["rounds"], seed=SEED,
                        visit_orders=tp.job_orders(job), mesh=mesh)
            for r in got[name]:
                np.testing.assert_allclose(r["gap"], one.history["gap"],
                                           rtol=RANK_RTOL)
