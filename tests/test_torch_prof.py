"""The port's profiles, hardware specs, fenced timing and round cost.

`build_profile` and `validate_profile` are held to the reference's on the
same stats; `obs.cost` prices the main path's three shapes at the bounds
`chip_smoke.py` prints (pure arithmetic, `PERF.md` section 6) and the
tiny specs' rounds by the same formulas. The card's clocks and specs are
checked by the `cuda`-marked test, which skips without a card.
"""
import json

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.obs.prof import CPU_HOST as REF_CPU_HOST
from repro_torch import comm
from repro_torch.core import CoCoAConfig
from repro_torch.data import load, partition, partition_sparse
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.core.cocoa import place_on_mesh
import repro_torch.obs as port_obs
from repro_torch.obs import cost, metrics, prof

PKGS = {"reference": ref_obs, "port": port_obs}
HW = {"reference": REF_CPU_HOST, "port": prof.CPU_HOST}
_STATS = {"flops": 10.0, "dot_flops": 4.0, "hbm_bytes": 100.0,
          "collective_wire_bytes": 8.0}


def _good_profile_dict(pkg):
    return PKGS[pkg].build_profile("k", _STATS, wall_s=1e-3, backend="cpu",
                                   hw=HW[pkg]).to_dict()


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("mutate,msg", [
    (lambda d: d.update(extra=1), "unknown"),
    (lambda d: d.pop("wall_s"), "missing"),
    (lambda d: d.update(flops="many"), "flops"),
    (lambda d: d.update(iters=True), "iters"),
    (lambda d: d.update(schema=99), "schema"),
    (lambda d: d.update(kind="epoch"), "kind"),
    (lambda d: d.update(wall_s=-1.0), "wall_s"),
    (lambda d: d.update(hbm_bytes=float("nan")), "hbm_bytes"),
    (lambda d: d.update(iters=0), "iters"),
    (lambda d: d.update(dot_flops=11.0), "dot_flops"),
    (lambda d: d.update(kind="round"), "round_global"),
])
def test_validate_profile_rejects_in_both_packages(pkg, mutate, msg):
    d = _good_profile_dict(pkg)
    mutate(d)
    errs = []
    for mod in (ref_obs, port_obs):
        with pytest.raises(ValueError, match=msg) as err:
            mod.validate_profile(d)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("stats,wall,kw", [
    (_STATS, 1e-3, {}),
    ({"flops": 2.5e9, "dot_flops": 0.0, "hbm_bytes": 4.3e8,
      "collective_wire_bytes": 1.9e5}, 0.0547, dict(kind="round",
                                                    round_global=6, iters=2)),
    ({"dot_flops": 7.0, "hbm_bytes": 3.0}, 0.0, dict(shape={"d": 8})),
])
def test_build_profile_matches_reference(stats, wall, kw):
    """The same stats dict on CPU_HOST: equal profiles field by field, and
    each package reads the other's JSON."""
    ref = ref_obs.build_profile("gold", stats, wall, backend="cpu",
                                hw=REF_CPU_HOST, **kw)
    port = port_obs.build_profile("gold", stats, wall, backend="cpu",
                                  hw=prof.CPU_HOST, **kw)
    assert list(port.to_dict()) == list(ref.to_dict())
    assert port.to_dict() == ref.to_dict()
    d = json.loads(json.dumps(port.to_dict()))
    assert ref_obs.KernelProfile.from_dict(d).to_dict() == ref.to_dict()
    assert port_obs.KernelProfile.from_dict(
        json.loads(json.dumps(ref.to_dict()))) == port


def test_hardware_specs():
    h100 = port_obs.get_hardware("h100_sxm")
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw) == (67e12, 3.35e12,
                                                           450e9)
    assert port_obs.get_hardware("h100_sxm_bf16").peak_flops == 989e12
    assert prof.CPU_HOST == port_obs.HardwareSpec(
        *(getattr(REF_CPU_HOST, f) for f in ("name", "peak_flops",
                                             "hbm_bw", "ici_bw")))
    # no TPU spec in the port: the error lists what it has
    with pytest.raises(KeyError, match="h100_sxm"):
        port_obs.get_hardware("tpu_v5e")
    assert not any("tpu" in name for name in prof.HARDWARE)
    assert port_obs.default_hardware("cpu") is prof.CPU_HOST


def test_default_hardware_needs_the_card_it_names():
    """The default device is the card: without one it raises rather than
    pricing a run with the CPU's peaks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present (tested by the cuda-marked test)")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_obs.default_hardware()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_obs.build_profile("k", _STATS, 1e-3)
    assert port_obs.build_profile("k", _STATS, 1e-3,
                                  hw=prof.CPU_HOST, backend="cpu").hw \
        == "cpu_host"


def test_round_profile_sink_pairs_with_records(tmp_path):
    from test_torch_obs import make_record
    from repro_torch.obs.validate import check_cross, validate_file
    mpath, ppath = tmp_path / "run.jsonl", tmp_path / "run.prof.jsonl"
    bus = port_obs.EventBus()
    bus.subscribe(port_obs.JsonlSink(mpath))
    sink = bus.subscribe(port_obs.RoundProfileSink(
        ppath, _STATS, shape={"K": 4}, compile_s=0.5, device="cpu"))
    for rg in (2, 4):
        bus.emit(make_record(port_obs, round=rg, round_global=rg,
                             rounds_in_record=2, execute_s=2e-3))
    bus.close()
    assert len(sink.profiles) == 2
    p = sink.profiles[0]
    assert (p.kind, p.round_global, p.backend, p.hw) == ("round", 2, "cpu",
                                                        "cpu_host")
    assert p.wall_s == pytest.approx(1e-3)
    assert p.compile_s == 0.5 and sink.profiles[1].compile_s == 0.0
    assert validate_file(str(ppath), require_timing=True) == 4
    assert check_cross(str(mpath), str(ppath)) == 2
    assert ref_obs.validate.check_cross(str(mpath), str(ppath)) == 2


# ----------------------------------------------------------------------------
# fenced timing and the compile split on the CPU
# ----------------------------------------------------------------------------

def test_fenced_timing_on_the_cpu():
    x = torch.randn(64, 64)
    (out, n), dt = port_obs.fenced_call(lambda a: (a @ a, 3), x)
    assert dt > 0 and n == 3 and out.shape == (64, 64)
    assert port_obs.fenced_time(torch.mm, x, x, iters=2) > 0
    assert metrics.cuda_devices(({"a": [x]}, (x, 1))) == []
    assert port_obs.aot_compile(("sparse_sdca_pipelined",), "cpu") == 0.0
    assert ops.round_libraries("sdca_kernel") == ("local_sdca",)
    assert ops.round_libraries("sdca_sparse_kernel", 2) == (
        "sparse_sdca_zx",)
    assert ops.round_libraries("sdca") == ()


def test_profile_fn_on_the_cpu():
    x = torch.randn(128, 128)
    stats = {"flops": 2 * 128 ** 3, "dot_flops": 2 * 128 ** 3,
             "hbm_bytes": 3 * 4 * 128 ** 2}
    p = port_obs.profile_fn(torch.mm, x, x, stats=stats, name="mm",
                            iters=2, shape={"n": 128})
    assert (p.backend, p.hw, p.iters, p.compile_s) == ("cpu", "cpu_host",
                                                       2, 0.0)
    assert p.wall_s > 0 and p.flops == stats["flops"]
    port_obs.validate_profile(p.to_dict())
    ref_obs.validate_profile(p.to_dict())


# ----------------------------------------------------------------------------
# obs.cost: the main path's bounds, and the tiny specs' rounds
# ----------------------------------------------------------------------------

RCV1_NNZ = 51_489_528          # chip_smoke.py phase 4's rcv1-shaped CSR


def _bound_ms(stats):
    return 1e3 * prof.H100_SXM.roofline(
        stats["flops"], stats["hbm_bytes"],
        stats["collective_wire_bytes"])["bound_s"]


@pytest.mark.parametrize("name,stats,want_ms", [
    ("epsilon K=8 dense walk",
     cost.dense_walk(8, 50_000, 2_000, wire_bytes=4 * 2_000), 0.958),
    ("rcv1 K=8 1-D sparse walk",
     cost.sparse_walk(RCV1_NNZ, 8, 84_675, 47_236, wire_bytes=4 * 47_236),
     0.1275),
    ("rcv1 4 x 2 zx round",
     cost.zx_round(RCV1_NNZ, 4, 2, 169_350, 23_618, block_rows=16,
                   passes=1, wire_bytes=4 * 23_618), 0.1321),
])
def test_main_path_bounds(name, stats, want_ms):
    """PERF.md section 6's bound column, from the shapes alone: every one
    bound by bytes at 3.35 TB/s."""
    roof = prof.H100_SXM.roofline(stats["flops"], stats["hbm_bytes"],
                                  stats["collective_wire_bytes"])
    assert roof["dominant"] == "memory", name
    assert round(_bound_ms(stats), 4 if want_ms < 0.5 else 3) == want_ms
    assert stats["dot_flops"] == 0.0 <= stats["flops"]


def test_main_path_counts():
    """chip_smoke.py's byte and flop formulas, term by term."""
    K, nk, d = 8, 50_000, 2_000
    s = cost.dense_walk(K, nk, d)
    assert s["hbm_bytes"] == 4 * (K * nk * d + 5 * K * nk + d + K * d)
    assert s["flops"] == 6 * K * nk * d
    K, nk, d = 8, 84_675, 47_236
    s = cost.sparse_walk(RCV1_NNZ, K, nk, d)
    assert s["hbm_bytes"] == 8 * RCV1_NNZ + 4 * (5 * K * nk + d + K * d)
    assert s["flops"] == 6 * RCV1_NNZ
    assert cost.sparse_walk(RCV1_NNZ, K, nk, d, steps=2 * nk)["flops"] \
        == 12 * RCV1_NNZ
    K, M, nk, dl, B = 4, 2, 169_350, 23_618, 16
    inv = -(-nk // B)
    s = cost.zx_round(RCV1_NNZ, K, M, nk, dl, B)
    assert s["hbm_bytes"] == (8 * RCV1_NNZ + inv * K * B * (2 * M + 1) * 4
                              + 4 * (6 * K * nk + M * dl + K * M * dl))
    assert s["flops"] == 4 * RCV1_NNZ


@pytest.fixture(scope="module")
def tiny():
    X, y = load("tiny")
    return partition(X, y, 8, device="cpu")


@pytest.fixture(scope="module")
def tiny_sparse():
    csr, y = load("tiny_sparse")
    return csr, y, partition_sparse(csr, y, 8, device="cpu")


@pytest.mark.parametrize("solver,H,passes,steps", [
    ("sdca_kernel", 128, 1, None), ("sdca_kernel", 256, 2, None),
    ("sdca", 64, None, 64), ("gd", 3, None, 3 * 128)])
def test_round_stats_dense(tiny, solver, H, passes, steps):
    Xp, yp, mk = tiny
    K, nk, d = Xp.shape
    cfg = CoCoAConfig.adding(K, H=H, solver=solver, loss="squared")
    got = cost.round_stats(cfg, Xp, mk)
    want = cost.dense_walk(K, nk, d, rows=int(mk.sum()),
                           steps=steps or passes * nk,
                           wire_bytes=4 * d)
    assert got == want
    assert got["collective_wire_bytes"] == 4 * K * d / K


def test_round_stats_sparse_and_wire(tiny_sparse):
    _, _, (sh, yp, mk) = tiny_sparse
    K, nk = yp.shape
    nnz = int(sh.nnz.sum())
    cfg = CoCoAConfig.adding(K, H=nk, solver="sdca_sparse_kernel")
    assert cost.round_stats(cfg, sh, mk) == cost.sparse_walk(
        nnz, K, nk, sh.d, wire_bytes=4 * sh.d)
    # top-k 16 over hier:2: the tracer's per-round floats a worker
    cfg = CoCoAConfig.adding(K, H=nk, solver="sdca_sparse_kernel",
                             compress="topk", compress_k=16,
                             topology="hier:2")
    topo = comm.Topology.simulated(K, "hier:2")
    from repro_torch.core.cocoa import resolve_solver, run_tracer
    tr = run_tracer(cfg, sh, topo, resolve_solver(cfg.solver, True))
    got = cost.round_stats(cfg, sh, mk, topo)
    assert got["collective_wire_bytes"] == 4 * tr.floats_per_round / K
    assert got["hbm_bytes"] == cost.sparse_walk(nnz, K, nk,
                                                sh.d)["hbm_bytes"]


def test_round_stats_zx_on_a_mesh(tiny_sparse):
    csr, y, _ = tiny_sparse
    K, M = 4, 2
    fs, yp, mk = partition_sparse(csr, y, K, M=M, device="cpu")
    cfg = CoCoAConfig.adding(K, H=128, solver="sdca_sparse_kernel",
                             backend="shard_map", model_axis="model")
    mesh = make_test_mesh((K, M), device="cpu")
    X, _, mask = place_on_mesh(cfg, mesh, fs, yp, mk)
    topo = comm.Topology.from_mesh(mesh, "data", "model")
    nk = yp.shape[1]
    plan = ops.sparse_zx_plan(nk, fs.d_local, 128, r_max=fs.r_loc,
                              model_shards=M, backend="cpu")
    got = cost.round_stats(cfg, X, mask, topo)
    assert got["hbm_bytes"] == cost.zx_round(
        int(fs.nnz.sum()), K, M, nk, fs.d_local, plan["block_rows"],
        plan["n_passes"])["hbm_bytes"]
    assert got["flops"] == plan["n_passes"] * 4 * int(fs.nnz.sum())
    assert got["collective_wire_bytes"] > 0


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_prof.py`")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_card_timing_and_spec(card):
    name = torch.cuda.get_device_name(card)
    if "H100" in name:
        assert port_obs.default_hardware() is prof.H100_SXM
    else:
        with pytest.raises(ValueError, match="no HardwareSpec"):
            port_obs.default_hardware()
    x = torch.randn(1024, 1024, device=card)
    (y,), dt = port_obs.fenced_call(lambda a: (a @ a,), x)
    assert dt > 0 and metrics.cuda_devices(y) == [card]
    ms = 1e3 * port_obs.fenced_time(torch.mm, x, x, iters=5)
    assert 0 < ms < 1e3
    np.testing.assert_allclose(y.cpu().numpy(), (x @ x).cpu().numpy())
