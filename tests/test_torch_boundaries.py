"""The port's boundaries: what it imports, where it runs, and what its CLI
accepts."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import init_state
from repro_torch.data import (load, partition, partition_sparse,
                              shards_from_arrays)
from repro_torch.launch import cocoa_train

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
            "cocoa_train.py", "chip_smoke.py"} <= names


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


def test_cli_sparse_kernel_run_on_cpu(capsys):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny_sparse",
                             "--solver", "sdca_kernel", "--rounds", "4"])
    out = capsys.readouterr().out
    assert "sparse shards" in out and "round 4: gap=" in out
    gaps = hist["gap"]
    assert len(gaps) == 4
    assert all(b < a for a, b in zip(gaps, gaps[1:])), gaps


def test_cli_dense_default_solver_on_cpu(capsys):
    hist = cocoa_train.main(["--device", "cpu", "--dataset", "tiny",
                             "--rounds", "3", "--H", "64", "--gamma", "avg",
                             "--eps", "0"])
    assert hist["round"] == [1, 2, 3]
    assert "final: rounds=3" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [
    (["--accel", "nesterov"], "item 9"),
    (["--mesh", "2x2"], "item 10"),                 # dense M > 1
    (["--ckpt", "ckpt_dir"], "item 12"),
    (["--simulate-failure", "3"], "item 12"),
    (["--simulate-straggler", "1"], "item 12"),
    (["--elastic-to", "4@2"], "item 12"),
    (["--metrics-out", "m.jsonl"], "item 11"),
    (["--dashboard"], "item 11"),
    (["--profile", "prof"], "item 11"),
])
def test_cli_unported_flags_name_their_roadmap_item(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {item}"):
        cocoa_train.main(["--device", "cpu", "--dataset", "tiny", *flags])


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
    assert len(gaps) == 3 and all(b < a for a, b in zip(gaps, gaps[1:]))
    if "--mesh" in flags:
        assert "sparse feature shards: M=2" in out and "mesh=2x2" in out


def _falling(hist, rounds):
    gaps = hist["gap"]
    assert len(gaps) == rounds, gaps
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
