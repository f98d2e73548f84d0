"""The port's boundaries: what it imports, where it runs, and what its CLI
accepts."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_tree, save_tree
from repro_torch.core import init_state, state_to_tree
from repro_torch.data import (load, partition, partition_sparse,
                              shards_from_arrays)
from repro_torch.launch import cocoa_train
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.obs import validate as port_validate
import repro.obs.validate as ref_validate
from repro.launch import cocoa_train as ref_train

import torch_parity as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"cocoa.py", "local_sdca.py", "sparse_sdca.py", "ops.py",
            "cocoa_train.py", "chip_smoke.py", "metrics.py", "events.py",
            "prof.py", "cost.py", "dashboard.py", "validate.py",
            "regress.py", "straggler.py", "manager.py", "failures.py",
            "elastic.py", "baselines.py", "adamw.py", "localdp.py",
            "train.py", "rglru.py", "gemma3_27b.py",
            "recurrentgemma_9b.py", "llama4_scout.py", "llama4_maverick.py",
            "qwen2_vl_7b.py", "whisper_large_v3.py", "paper_svm.py",
            "specs.py"} <= names
    assert (ROOT / "src" / "repro_torch" / "optim" / "compress.py"
            in PORT_FILES)


def _defaults():
    """Entry points called without `device`, each returning a tensor."""
    X, y = load("tiny")
    csr, ys = load("tiny_sparse")
    return [lambda: partition(X, y, 4)[0],
            lambda: partition_sparse(csr, ys, 4)[1],
            lambda: init_state(8, 2, 4).w,
            lambda: shards_from_arrays(np.zeros((1, 1, 1), np.int32),
                                       np.zeros((1, 1, 1), np.float32),
                                       np.ones((1, 1), np.int32), 4).vals]


def test_entry_points_default_to_cuda():
    """Without a card the default raises; with one it lands on cuda."""
    for make in _defaults():
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()


def test_init_residual_defaults_to_cuda():
    """The error-feedback residual follows the port's device rule: on the
    card unless the caller names another device."""
    from repro_torch import comm
    if torch.cuda.is_available():
        assert comm.init_residual(2, 3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            comm.init_residual(2, 3)


def test_init_residual_on_the_cpu_when_asked():
    from repro_torch import comm
    ef = comm.init_residual(4, 5, torch.float64, device="cpu")
    assert ef.device.type == "cpu" and ef.dtype == torch.float64
    assert tuple(ef.shape) == (4, 5) and not ef.any()


def test_cli_defaults_to_cuda():
    argv = ["--dataset", "tiny", "--rounds", "1", "--solver", "sdca_kernel"]
    if torch.cuda.is_available():
        assert cocoa_train.main(argv)["round"] == [1]
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cocoa_train.main(argv)


def _certified(rounds):
    """The rounds the CLI certifies: every second one and the last (the
    reference trainer's gap_every=2)."""
    return sorted(set(range(2, rounds + 1, 2)) | {rounds})


def test_cli_sparse_kernel_run_on_cpu(capsys):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny_sparse",
                             "--solver", "sdca_kernel", "--rounds", "4"])
    out = capsys.readouterr().out
    assert "sparse shards" in out and "round 4: gap=" in out
    assert hist["round"] == _certified(4) == [2, 4]
    gaps = hist["gap"]
    assert all(b < a for a, b in zip(gaps, gaps[1:])), gaps


def test_cli_dense_default_solver_on_cpu(capsys):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny",
                             "--rounds", "3", "--H", "64", "--gamma", "avg",
                             "--eps", "0"])
    assert hist["round"] == _certified(3) == [2, 3]
    assert "final: rounds=3" in capsys.readouterr().out


# ----------------------------------------------------------------------------
# the operational flags (they exited naming ROADMAP.md Queue 1 item 12
# before checkpoint and runtime were ported)
# ----------------------------------------------------------------------------

TINY = ["--device", "cpu", "--dataset", "tiny", "--H", "64", "--eps", "0"]


def _final_gap(out):
    return [ln for ln in out.splitlines()
            if ln.startswith("final: rounds=")][-1].split("gap=")[1].split()[0]


def test_cli_ckpt_resumes_and_equals_an_uninterrupted_run(tmp_path, capsys):
    ck = ["--ckpt", str(tmp_path), "--ckpt-every", "2"]
    first = cocoa_train.main(TINY + ck + ["--rounds", "4"])
    assert first["round"] == [2, 4] and "resumed" not in (
        capsys.readouterr().out)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]
    hist = cocoa_train.main(TINY + ck + ["--rounds", "8"])
    out = capsys.readouterr().out
    assert "resumed from round 4" in out and hist["round"] == [6, 8]
    # keep=2: the newest two steps
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_6", "step_8"]
    full = cocoa_train.main(TINY + ["--rounds", "8"])
    assert _final_gap(out) == _final_gap(capsys.readouterr().out)
    assert hist["gap"] == full["gap"][2:]


def test_cli_ckpt_without_ef_leaf_resumes(tmp_path, capsys):
    """A checkpoint from before the wire stack (no `ef` leaf) restores
    with zero residuals."""
    cocoa_train.main(TINY + ["--rounds", "2", "--ckpt", str(tmp_path / "a"),
                             "--ckpt-every", "2"])
    tree, _ = restore_tree(tmp_path / "a", dict.fromkeys(
        ("w", "alpha", "rounds", "alpha_bar"), 0))
    save_tree(tmp_path / "b", 2, tree)
    capsys.readouterr()
    hist = cocoa_train.main(TINY + ["--rounds", "4", "--ckpt",
                                    str(tmp_path / "b")])
    assert "resumed from round 2" in capsys.readouterr().out
    assert hist["round"] == [4]


def test_cli_ckpt_of_another_width_exits(tmp_path):
    save_tree(tmp_path, 2, state_to_tree(init_state(10, 8, 128,
                                                    device="cpu")))
    with pytest.raises(SystemExit, match="only replicated"):
        cocoa_train.main(TINY + ["--rounds", "4", "--ckpt", str(tmp_path)])


def test_cli_simulate_failure_on_tiny(capsys):
    hist = cocoa_train.main(TINY + ["--rounds", "6", "--simulate-failure",
                                    "2"])
    out = capsys.readouterr().out
    assert "simulating loss of worker 0 (dual-safe drop + recovery)" in out
    assert out.index("round 2: gap=") < out.index("simulating loss") < \
        out.index("round 4: gap=")
    assert hist["round"] == [2, 4, 6]
    assert all(g >= -1e-6 for g in hist["gap"])
    assert hist["gap"][-1] < hist["gap"][1]


@pytest.mark.parametrize("data,flags,msg", [
    ("tiny", ["--elastic-to", "4@2"], "elastic re-partition 8 -> 4 workers"),
    ("tiny_sparse", ["--solver", "sdca_kernel", "--elastic-to", "5@2"],
     "elastic re-partition 8 -> 5 workers"),
    ("tiny_sparse", ["--mesh", "2x2", "--solver", "sdca_kernel",
                     "--elastic-to", "3@2"],
     "elastic re-partition 2 -> 3 workers"),
])
def test_cli_elastic_to_runs(capsys, data, flags, msg):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", data, "--H",
                             "128", "--lam", "1e-3", "--eps", "0",
                             "--rounds", "6", *flags])
    out = capsys.readouterr().out
    assert msg in out
    _falling(hist, 6)
    K = msg.split("-> ")[1].split()[0]
    final = [ln for ln in out.splitlines() if ln.startswith("  hop ")][0]
    assert f"{K} msgs" in final


def test_cli_elastic_to_rejects_a_bad_target():
    with pytest.raises(SystemExit, match="--elastic-to wants 'K@round'"):
        cocoa_train.main(TINY + ["--elastic-to", "4"])
    with pytest.raises(SystemExit, match="hier group 4 must divide K=6"):
        cocoa_train.main(TINY + ["--topology", "hier:4", "--elastic-to",
                                 "6@2"])


def test_cli_resumes_a_reference_replicated_checkpoint_on_a_mesh(
        tmp_path, capsys, monkeypatch):
    """The reference trainer's checkpoint (w replicated, d = 512 floats)
    resumed by the port under --mesh 2x3: w resharded into 3 feature
    shards of 171 (513 floats placed)."""
    common = ["--dataset", "tiny_sparse", "--H", "128", "--lam", "1e-3",
              "--eps", "0", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    monkeypatch.setattr(sys, "argv", ["cocoa_train", *common, "--workers",
                                      "2", "--rounds", "2"])
    ref_train.main()
    ref_gap = float(_final_gap_ref(capsys.readouterr().out))
    hist = cocoa_train.main(["--device", "cpu", *common, "--mesh", "2x3",
                             "--solver", "sdca_kernel", "--rounds", "6"])
    out = capsys.readouterr().out
    assert "resharded legacy checkpoint w: 1 -> 3 feature shards" in out
    assert "resumed from round 2" in out and "mesh=2x3" in out
    assert hist["round"] == [4, 6]
    assert hist["gap"][-1] < hist["gap"][0] < ref_gap


def _final_gap_ref(out):
    return [ln for ln in out.splitlines()
            if ln.startswith("final: P=")][-1].split("gap=")[1].split()[0]


def test_cli_elastic_to_exits_on_a_process_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "repro_torch.launch.cocoa_train",
         *TINY, "--workers", "2", "--backend", "shard_map", "--elastic-to",
         "1@2"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=110)
    assert p.returncode != 0
    assert "ROADMAP.md Queue 1 item 14 (Elastic runs across processes)" in (
        p.stderr)


def test_cli_ckpt_and_failure_on_two_ranks_equal_one_process(tmp_path):
    """--ckpt (saved by rank 0 from the gathered blocks, each rank
    restoring its own) and --simulate-failure on a 2-rank gloo mesh, held
    to the one-process runs within 1e-6 relative."""
    base = TINY + ["--workers", "2", "--lam", "1e-3"]

    def runs(where, extra):
        ck = ["--ckpt", str(tmp_path / where), "--ckpt-every", "2"]
        return [base + extra + ck + ["--rounds", "4"],
                base + extra + ck + ["--rounds", "8"],
                base + extra + ["--rounds", "6", "--simulate-failure", "2"]]

    ranks = spawn_ranks(tp.cli_on_ranks, 2,
                        (runs("ranks", ["--backend", "shard_map"]),),
                        timeout=110)
    one = [cocoa_train.main(argv) for argv in runs("one", [])]
    clocks = ("execute_s", "certificate_s")
    for a, b in zip(*ranks):
        assert {k: v for k, v in a.items() if k not in clocks} == {
            k: v for k, v in b.items() if k not in clocks}
    for got, want in zip(ranks[0], one):
        assert got["round"] == want["round"]
        np.testing.assert_allclose(got["gap"], want["gap"], rtol=1e-6)
        np.testing.assert_allclose(got["primal"], want["primal"], rtol=1e-6)
    assert ranks[0][1]["round"] == [6, 8]
    # the checkpoint rank 0 wrote holds the global layout
    a, _ = restore_tree(tmp_path / "ranks", {"alpha": 0, "ef": 0, "w": 0})
    b, _ = restore_tree(tmp_path / "one", {"alpha": 0, "ef": 0, "w": 0})
    for k in a:
        assert a[k].shape == b[k].shape
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x2", "--solver", "sdca_sparse_kernel"],
    ["--mesh", "2x2", "--solver", "sdca"],
    ["--backend", "shard_map", "--solver", "sdca_kernel"],
])
def test_cli_mesh_and_backend_run_on_tiny_sparse(capsys, flags):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny_sparse",
                             "--rounds", "3", "--H", "256", "--lam", "1e-3",
                             "--eps", "0", *flags])
    out = capsys.readouterr().out
    gaps = hist["gap"]
    assert hist["round"] == _certified(3)
    assert all(b < a for a, b in zip(gaps, gaps[1:]))
    if "--mesh" in flags:
        assert "sparse feature shards: M=2" in out and "mesh=2x2" in out


def _falling(hist, rounds):
    gaps = hist["gap"]
    assert hist["round"] == _certified(rounds), gaps
    assert all(b < a for a, b in zip(gaps, gaps[1:])), gaps


@pytest.mark.parametrize("flags", [
    ["--compress", "topk", "--compress-k", "16"],
    ["--topology", "hier:2"],
    ["--compress", "randk", "--compress-k", "64", "--gather"],
    ["--compress", "topk", "--compress-k", "16", "--topology", "hier:2",
     "--gather"],
    ["--mesh", "2x2", "--solver", "sdca_kernel", "--topology", "hier:2",
     "--compress", "topk", "--compress-k", "15", "--gather"],
])
def test_cli_wire_flags_run_on_tiny_sparse(capsys, flags):
    """The comm flags run on the CPU (they exited naming ROADMAP Queue 1
    item 8 before it was ported), and the summary prints the tracer's
    per-hop table."""
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny_sparse",
                             "--rounds", "4", "--H", "256", "--lam", "1e-3",
                             "--eps", "0", *flags])
    out = capsys.readouterr().out
    _falling(hist, 4)
    assert "comm[" in out and "  hop " in out
    if "--gather" in flags and "hier:2" in flags:
        assert "hop inter_gather[data]" in out
        assert "(measured after dedup, last round: " in out


@pytest.mark.parametrize("solver", ["gd", "sdca_deadline"])
def test_cli_other_solvers_run_on_tiny(capsys, solver):
    """`--solver gd|sdca_deadline` run on the CPU (they exited naming
    ROADMAP Queue 1 item 4 before it was ported)."""
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny",
                             "--solver", solver, "--rounds", "3", "--H",
                             "64", "--lam", "1e-3", "--eps", "0"])
    _falling(hist, 3)
    assert "final: rounds=3" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--gather"], "--gather needs --compress topk or randk"),
    (["--compress", "int8", "--gather"], "--gather needs"),
    (["--topology", "hier:3"], "hier group 3 must divide K=8"),
    (["--topology", "ring"], "unknown topology"),
])
def test_cli_rejects_bad_wire_flags(flags, match):
    with pytest.raises(SystemExit, match=match):
        cocoa_train.main(["--device", "cpu", "--dataset", "tiny", *flags])


@pytest.mark.parametrize("accel", ["nesterov:16", "catalyst:20"])
def test_cli_accel_runs_on_tiny(capsys, accel):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny",
                             "--rounds", "4", "--H", "64", "--eps", "0",
                             "--accel", accel])
    gaps = hist["gap"]
    assert hist["round"] == _certified(4) and gaps[-1] < gaps[0]
    assert all(g >= -1e-6 for g in gaps)
    assert "final: rounds=4" in capsys.readouterr().out


def test_cli_dense_mesh_runs_on_tiny(capsys):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny",
                             "--rounds", "3", "--H", "64", "--eps", "0",
                             "--mesh", "2x2"])
    out = capsys.readouterr().out
    gaps = hist["gap"]
    assert hist["round"] == _certified(3)
    assert all(b < a for a, b in zip(gaps, gaps[1:]))
    assert "dense feature shards: M=2 d_local=32" in out
    assert "mesh=2x2" in out and "hop model_z[model]" in out


def test_cli_dense_mesh_refuses_the_dense_kernel():
    with pytest.raises(SystemExit, match="cannot run feature-sharded"):
        cocoa_train.main(["--device", "cpu", "--dataset", "tiny",
                          "--mesh", "2x2", "--solver", "sdca_kernel"])


# ----------------------------------------------------------------------------
# the telemetry flags (they exited naming ROADMAP.md Queue 1 items 11 and 12
# before obs and the straggler tracker were ported)
# ----------------------------------------------------------------------------

TINY_SPARSE = ["--device", "cpu", "--dataset", "tiny_sparse", "--solver",
               "sdca_kernel", "--rounds", "4", "--H", "128", "--lam", "1e-3",
               "--eps", "0"]


def _lines(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _trace_names(path):
    return {ev.get("name") for ev in json.loads(path.read_text())[
        "traceEvents"]}


@pytest.mark.parametrize("flag", ["--metrics-out", "--dashboard",
                                  "--profile", "--simulate-straggler"])
def test_cli_obs_flag_runs_alone(tmp_path, capsys, flag):
    value = {"--metrics-out": [str(tmp_path / "m.jsonl")], "--dashboard": [],
             "--profile": [str(tmp_path / "prof")],
             "--simulate-straggler": ["1"]}[flag]
    hist = cocoa_train.main(TINY_SPARSE + [flag, *value])
    out = capsys.readouterr().out
    _falling(hist, 4)
    assert "final: P=" in out and "time: compile 0.00s + execute" in out
    if flag == "--metrics-out":
        recs = _lines(tmp_path / "m.jsonl")
        assert [r["round"] for r in recs] == [2, 4]
        assert port_validate.main([value[0], "--require-timing"]) == 0
        assert "metrics: 4 rounds -> " in out
        assert not (tmp_path / "m.prof.jsonl").exists()
    elif flag == "--dashboard":
        assert "round 2: gap=" in out and "round_ms=" in out
        assert "flops_frac" not in out        # no profile stream to pair
    elif flag == "--profile":
        assert "cocoa/local_solve" in _trace_names(
            tmp_path / "prof" / "trace.json")
        assert "profile: trace written to " in out
    else:
        assert "straggler budgets: [" in out


def test_cli_metrics_profile_dashboard_on_tiny_sparse(tmp_path, capsys):
    """--metrics-out --profile --dashboard together: the JSONL passes both
    packages' validators, the profile stream pairs with it by
    round_global, the trace holds the rounds' ranges and the dashboard
    draws the compute row."""
    m, trace_dir = tmp_path / "m.jsonl", tmp_path / "prof"
    hist = cocoa_train.main(TINY_SPARSE + [
        "--rounds", "6", "--metrics-out", str(m), "--profile",
        str(trace_dir), "--dashboard"])
    out = capsys.readouterr().out
    _falling(hist, 6)
    p = tmp_path / "m.prof.jsonl"
    for mod in (port_validate, ref_validate):
        assert mod.main([str(m), "--prof", str(p), "--require-timing"]) == 0
    recs, profs = _lines(m), _lines(p)
    assert [r["round_global"] for r in recs] == [2, 4, 6]
    assert [q["round_global"] for q in profs] == [2, 4, 6]
    assert all(q["backend"] == "cpu" and q["hw"] == "cpu_host"
               for q in profs)
    assert [r["gap"] for r in recs] == hist["gap"]
    names = _trace_names(trace_dir / "trace.json")
    assert {"cocoa_round", "cocoa/local_solve", "cocoa/exchange",
            "cocoa/certificate"} <= names
    assert "round 6: gap=" in out and "flops_frac=" in out
    assert f"--prof {p}" in out


def test_cli_simulate_straggler_records_carry_budgets(tmp_path, capsys):
    m = tmp_path / "m.jsonl"
    cocoa_train.main(["--device", "cpu", "--dataset", "tiny", "--solver",
                      "sdca_deadline", "--H", "64", "--rounds", "4",
                      "--eps", "0", "--workers", "4",
                      "--simulate-straggler", "1", "--metrics-out", str(m)])
    recs = _lines(m)
    assert len(recs) == 2
    for r in recs:
        assert len(r["budgets"]) == 4 and len(r["throughput"]) == 4
        assert min(range(4), key=lambda k: r["throughput"][k]) == 1
    assert ref_validate.main([str(m)]) == 0
