"""The dry run (`launch.dryrun`) against the reference's and against the
port's own real runs.

(i) Smoke-config cells -- stablelm-1.6b train, falcon-mamba-7b prefill,
llama4-scout decode, at batch 8 and length 64 -- are lowered by the
reference's `lower_cell` in a child with 8 forced host devices on its
2 x 2 and 2 x 2 x 2 test meshes (built with Auto axes: jax 0.9's default
Explicit axes break its sharding constraints, ROADMAP.md Queue 3), and
by the port's `lower_cell` on fake worlds of 4 and 8 ranks in a child of
its own. `global_param_bytes` must be equal and `flops_per_device`
within FLOPS_RTOL = 5%. Read: mamba prefill and scout decode equal on
both meshes; stablelm train 2.17% over on both (98,566,144 against
96,468,992 on 2 x 2): DTensor runs layer 0's MLP input products (wi, wg)
whole over "model" on the attention's partial sums (4.19 M forward, and
their backward), net of its other choices op by op against XLA's
partitioner (the other train-step products take other splits of equal
FLOPs).

(i') The smoke decode_long cells (serve_long: the KV caches' sequence
over "data") of gemma3-27b, gemma2-27b, recurrentgemma-9b and
falcon-mamba-7b at batch 1 and cache lengths 2,048 and 8,192, the same
way: `flops_per_device` within FLOPS_RTOL of the reference's at both
lengths, `collective_wire_bytes_per_device` within WIRE_RATIO = 3x of the
reference's and equal at both lengths (each rank scores its own cache
slots and only softmax statistics cross the wire,
`models.shards.decode_over_shards`). Read on 2 x 2 and 2 x 2 x 2: FLOPs
equal but recurrentgemma's on 2 x 2 x 2 (103,424 against 102,912) and
falcon-mamba's (47,104 against 46,080, 2.2% over); wire bytes 13,948
against 9,452 (gemma3), 5,564 against 4,716 (gemma2), 9,836 against
7,676 and 7,932 (recurrentgemma), 4,748 against 6,772 (falcon-mamba), at
both lengths. Before the sharded decode the port gathered every cache
whole: gemma3 read 363,972 wire bytes at S 2,048 and 1,150,404 at 8,192.

(ii) A fake 4-rank dry run of smoke steps -- stablelm train, prefill and
decode, scout's expert-parallel prefill and decode, gemma3-27b's
serve_long decode over a sequence-sharded cache -- makes the same
collectives as a real run of the same steps on 4 gloo CPU ranks: the
tallies equal, kind by kind, group by group, byte for byte.

(iii) One production cell, stablelm-1.6b decode_32k on the 256-rank
fake world, prints [ok] with the reference's keys, and long_500k writes
its skip record.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

from repro_torch.launch.mesh import spawn_ranks

import torch_parity as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_RTOL = 0.05
CELLS = [("stablelm-1.6b", "t_train", "train"),
         ("falcon-mamba-7b", "t_prefill", "prefill"),
         ("llama4-scout-17b-a16e", "t_decode", "decode")]
LONG_ARCHS = ("gemma3-27b", "gemma2-27b", "recurrentgemma-9b",
              "falcon-mamba-7b")
LONG_SHAPES = ("t_long2k", "t_long8k")
WIRE_RATIO = 3.0
MESHES = ("single", "multi")
TALLY_JOBS = [dict(arch="stablelm-1.6b", kind=k, B=4, S=16)
              for k in ("train", "prefill", "decode")] + \
    [dict(arch="llama4-scout-17b-a16e", kind=k, B=4, S=16)
     for k in ("prefill", "decode")] + \
    [dict(arch="gemma3-27b", kind="decode", B=1, S=64, mode="serve_long")]
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "kind", "lower_s",
               "compile_s", "flops_per_device", "hbm_bytes_per_device",
               "collectives", "collective_wire_bytes_per_device",
               "xla_cost_flops", "xla_cost_bytes", "memory_analysis",
               "global_param_bytes", "n_devices"}

_SHAPES = """
{sp}.SHAPES["t_train"] = dict(seq=64, batch=8, kind="train")
{sp}.SHAPES["t_prefill"] = dict(seq=64, batch=8, kind="prefill")
{sp}.SHAPES["t_decode"] = dict(seq=64, batch=8, kind="decode")
{sp}.SHAPES["t_long2k"] = dict(seq=2048, batch=1, kind="decode_long")
{sp}.SHAPES["t_long8k"] = dict(seq=8192, batch=1, kind="decode_long")
"""

_REF = """
import os
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
import jax
from jax.sharding import AxisType
from repro.configs import smoke_config
from repro.launch import dryrun as D, mesh as meshlib, specs as Sp
meshlib.make_test_mesh = lambda shape=(2, 2), axes=("data", "model"): \\
    jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
""" + _SHAPES.format(sp="Sp") + """
for arch, shape, kind in {cells!r}:
    for m in ("single", "multi"):
        cell = Sp.Cell(arch, shape, smoke_config(arch), kind)
        rec = D.lower_cell(cell, D._mesh(m), m)
        out[f"{{arch}}/{{m}}"] = np.array(
            [rec["flops_per_device"], rec["global_param_bytes"]])
for arch in {long_archs!r}:
    for shape in {long_shapes!r}:
        for m in ("single", "multi"):
            cell = Sp.Cell(arch, shape, smoke_config(arch), "decode_long")
            rec = D.lower_cell(cell, D._mesh(m), m)
            out[f"{{arch}}/{{shape}}/{{m}}"] = np.array(
                [rec["flops_per_device"],
                 rec["collective_wire_bytes_per_device"]])
"""

_PORT = """
import json, os, warnings
warnings.filterwarnings("ignore")
os.environ["REPRO_DRYRUN_DEVICES"] = "1"
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun as D, specs as Sp
""" + _SHAPES.format(sp="Sp") + """
out = {{}}
for m in ("single", "multi"):
    for arch, shape, kind in {cells!r}:
        cell = Sp.Cell(arch, shape, smoke_config(arch), kind)
        out[f"{{arch}}/{{m}}"] = D.lower_cell(cell, D._mesh(m), m)
    for arch in {long_archs!r}:
        for shape in {long_shapes!r}:
            cell = Sp.Cell(arch, shape, smoke_config(arch), "decode_long")
            out[f"{{arch}}/{{shape}}/{{m}}"] = D.lower_cell(
                cell, D._mesh(m), m)
print("RESULT " + json.dumps(out))
"""

_TALLY = """
import json, sys, warnings
warnings.filterwarnings("ignore")
sys.path.insert(0, "tests")
import torch_parity as tp
from repro_torch.launch.mesh import make_fake_mesh
mesh = make_fake_mesh((2, 2), ("data", "model"))
print("RESULT " + json.dumps([tp.step_tally_job(j, mesh)
                              for j in {jobs!r}]))
"""


def _child(code: str, timeout: int = 600, env_extra=None) -> object:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **(env_extra or {}))
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):]), p.stdout


@pytest.fixture(scope="module")
def reference():
    return tp.reference_in_child(_REF.format(
        cells=CELLS, long_archs=LONG_ARCHS, long_shapes=LONG_SHAPES),
        devices=8)


@pytest.fixture(scope="module")
def port():
    return _child(_PORT.format(cells=CELLS, long_archs=LONG_ARCHS,
                               long_shapes=LONG_SHAPES))[0]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cell", range(len(CELLS)),
                         ids=[c[0] for c in CELLS])
def test_smoke_cells_against_the_reference(reference, port, cell, mesh):
    arch = CELLS[cell][0]
    flops, pbytes = reference[f"{arch}/{mesh}"]
    rec = port[f"{arch}/{mesh}"]
    assert RECORD_KEYS <= set(rec)
    assert rec["n_devices"] == (4 if mesh == "single" else 8)
    assert rec["global_param_bytes"] == int(pbytes)
    assert rec["flops_per_device"] == pytest.approx(flops, rel=FLOPS_RTOL)
    assert rec["xla_cost_flops"] == -1.0


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_decode_long_cells_against_the_reference(reference, port, arch,
                                                 mesh):
    wire = []
    for shape in LONG_SHAPES:
        flops, ref_wire = reference[f"{arch}/{shape}/{mesh}"]
        rec = port[f"{arch}/{shape}/{mesh}"]
        assert rec["kind"] == "decode"
        assert rec["flops_per_device"] == pytest.approx(flops,
                                                        rel=FLOPS_RTOL)
        assert rec["collective_wire_bytes_per_device"] <= \
            WIRE_RATIO * ref_wire
        wire.append(rec["collective_wire_bytes_per_device"])
    assert wire[0] == wire[1], "the bytes on the wire grow with the cache"


@pytest.fixture(scope="module")
def tallies():
    fake = _child(_TALLY.format(jobs=TALLY_JOBS))[0]
    real = spawn_ranks(tp.step_tally_on_ranks, 4,
                       (TALLY_JOBS, (2, 2), ("data", "model")), timeout=300)
    return fake, real[0]


@pytest.mark.parametrize("job", range(len(TALLY_JOBS)),
                         ids=[f"{j['arch']}-{j['kind']}" for j in TALLY_JOBS])
def test_dry_run_tally_equals_a_real_run(tallies, job):
    fake, real = tallies
    assert fake[job]["tally"], "the step made no collective"
    assert fake[job]["tally"] == real[job]["tally"]


def test_a_production_cell_and_a_skip_record():
    with tempfile.TemporaryDirectory() as out:
        code = f"""
            from repro_torch.launch import dryrun as D
            for shape in ("decode_32k", "long_500k"):
                try:
                    D.main(["--arch", "stablelm-1.6b", "--shape", shape,
                            "--mesh", "single", "--out", {out!r}])
                except SystemExit as e:
                    assert e.code == 0, e.code
            print("RESULT 0")
            """
        _, stdout = _child(code, timeout=300)
        assert "[ok]   stablelm-1.6b x decode_32k (single)" in stdout
        assert "[skip] stablelm-1.6b x long_500k (single)" in stdout
        with open(os.path.join(out, "stablelm-1.6b__decode_32k__single.json")
                  ) as f:
            rec = json.load(f)
        with open(os.path.join(out, "stablelm-1.6b__long_500k__single.json")
                  ) as f:
            skip = json.load(f)
    assert RECORD_KEYS <= set(rec)
    assert rec["n_devices"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["flops_per_device"] > 0
    assert rec["collective_wire_bytes_per_device"] > 0
    assert set(skip) == {"arch", "shape", "mesh", "skipped"}
    assert "sub-quadratic" in skip["skipped"]
