"""The port's observability layer against the reference's.

Records, validators, the aggregator, the dashboard, `validate`, `regress`
and the straggler tracker run on the same inputs in both packages and must
give the same results, byte for byte where they print. `solve`'s record
stream is held to the reference's on the reference's visit orders: round
fields, hops, comm totals and wire deltas equal, gap / primal / dual within
1e-4 relative (tests/test_torch_cocoa.py's tolerance).
"""
import io
import json

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro.obs.regress as ref_regress
import repro.obs.validate as ref_validate
import repro.runtime.straggler as ref_straggler
from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.data import load, partition as ref_partition
from repro.data.sparse import partition_sparse as ref_partition_sparse
import repro_torch.obs as port_obs
import repro_torch.obs.regress as port_regress
import repro_torch.obs.validate as port_validate
import repro_torch.runtime.straggler as port_straggler
from repro_torch.core import CoCoAConfig, solve
from repro_torch.data import partition, partition_sparse

import torch_parity as tp

PKGS = {"reference": ref_obs, "port": port_obs}
K = 8
GAP_RTOL = 1e-4


def make_record(obs, round=1, round_global=None, gap=0.5, execute_s=1e-3,
                **kw):
    """tests/test_obs.py's record maker, for either package."""
    hops = kw.pop("hops", ({"hop": "reduce", "axis": "data", "messages": 4,
                            "floats_per_message": 64, "floats": 256,
                            "bytes": 1024},))
    wire = kw.pop("wire_floats", 256)
    return obs.RoundRecord(
        round=round, round_global=round_global or round,
        rounds_in_record=kw.pop("rounds_in_record", 1), gap=gap,
        primal=gap + 0.1, dual=0.1, compile_s=kw.pop("compile_s", 0.0),
        execute_s=execute_s, certificate_s=kw.pop("certificate_s", 1e-4),
        wire_floats=wire, wire_bytes=4 * wire, hops=hops,
        comm={"comm_vectors": 4 * round, "comm_floats": 256 * round,
              "comm_bytes": 1024 * round, "comm_psums": round}, **kw)


def _records(obs):
    """A gap_every=2 run's records with budgets, rates and a measured hop."""
    hop = {"hop": "inter_gather", "axis": "data", "messages": 2,
           "floats_per_message": 64, "floats": 128, "bytes": 512,
           "measured_floats": 100, "measured_floats_round": 60}
    rates = tuple(1e4 if i != 1 else 1e3 for i in range(4))
    return [make_record(obs, round=2, rounds_in_record=2, execute_s=0.4,
                        gap=0.5, compile_s=1.0, wire_floats=512,
                        budgets=(64, 16, 64, 64), throughput=rates,
                        hops=(hop,)),
            make_record(obs, round=4, round_global=4, rounds_in_record=2,
                        execute_s=0.2, gap=0.05, wire_floats=512,
                        budgets=(64, 16, 64, 64), throughput=rates,
                        hops=(hop,)),
            make_record(obs, round=5, round_global=5, execute_s=0.15,
                        gap=0.01, wire_floats=256)]


# ----------------------------------------------------------------------------
# schema: rejection cases on both validators, records across the packages
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("mutate,msg", [
    (lambda d: d.pop("gap"), "missing field"),
    (lambda d: d.update(gap="0.5"), "wants"),
    (lambda d: d.update(round=True), "wants"),          # bools are not ints
    (lambda d: d.update(schema=99), "schema version"),
    (lambda d: d.update(extra=1), "unknown record fields"),
    (lambda d: d.update(round=0), ">= 1"),
    (lambda d: d.update(round_global=0), "round_global"),
    (lambda d: d.update(execute_s=-1.0), "finite and >= 0"),
    (lambda d: d.update(execute_s=float("nan")), "finite and >= 0"),
    (lambda d: d.update(wire_bytes=1), "4 \\* wire_floats"),
    (lambda d: d.update(hops=[{"hop": "reduce"}]), "hop row missing"),
    (lambda d: d.update(comm={}), "comm totals missing"),
])
def test_validate_record_rejects_in_both_packages(pkg, mutate, msg):
    d = make_record(PKGS[pkg]).to_dict()
    mutate(d)
    with pytest.raises(ValueError, match=msg) as err:
        PKGS[pkg].validate_record(d)
    # the other package rejects the same dict with the same message
    other = PKGS["port" if pkg == "reference" else "reference"]
    with pytest.raises(ValueError) as err_other:
        other.validate_record(d)
    assert str(err.value) == str(err_other.value)


@pytest.mark.parametrize("src,dst", [("port", "reference"),
                                     ("reference", "port")])
def test_records_cross_the_packages(src, dst):
    for rec in _records(PKGS[src]):
        d = json.loads(json.dumps(rec.to_dict()))
        back = PKGS[dst].RoundRecord.from_dict(d)
        assert list(back.to_dict()) == list(rec.to_dict())
        assert back.to_dict() == rec.to_dict()
    assert PKGS[src].SCHEMA_VERSION == PKGS[dst].SCHEMA_VERSION == 1


def test_metric_primitives_match():
    samples = [0.4, 0.1, 0.9, 0.2, 0.7, 0.3]
    sums = []
    for obs in PKGS.values():
        h = obs.Histogram("lat")
        for s in samples:
            h.observe(s)
        c, g = obs.Counter("n"), obs.Gauge("gap")
        sums.append((h.summary(), h.percentile(50), c.inc(3), g.set(0.25)))
        with pytest.raises(ValueError):
            c.inc(-1)
    assert sums[0] == sums[1]


# ----------------------------------------------------------------------------
# aggregator and dashboard: the same text on the same records
# ----------------------------------------------------------------------------

def _aggregate(obs):
    agg = obs.Aggregator()
    for rec in _records(obs):
        agg.emit(rec)
    return agg


def test_aggregator_matches_reference():
    ref, port = _aggregate(ref_obs), _aggregate(port_obs)
    assert port.summary() == ref.summary()
    assert port.history() == ref.history()
    assert list(port.history()) == list(ref.history())
    assert port.format_summary() == ref.format_summary()
    assert port.rounds_to_gap(0.1) == ref.rounds_to_gap(0.1) == 4
    assert port.rounds == ref.rounds == 5
    assert (port_obs.Aggregator().format_summary()
            == ref_obs.Aggregator().format_summary())


class _FakeTty(io.StringIO):
    def isatty(self):
        return True


class _ProfSource:
    def __init__(self, profiles):
        self.profiles = profiles


_STATS = {"flops": 1000.0, "dot_flops": 600.0, "hbm_bytes": 4096.0,
          "collective_wire_bytes": 512.0}


def _dashboard_text(obs, tty, case):
    out = _FakeTty() if tty else io.StringIO()
    recs = _records(obs)
    src = None
    if case == "compute":
        prof = [obs.build_profile("cocoa_round", _STATS, 1e-3, kind="round",
                                  backend="cpu", hw=obs.prof.CPU_HOST,
                                  round_global=r.round_global)
                for r in recs]
        src = _ProfSource([])
    if case == "fold":
        recs = [make_record(obs, throughput=tuple(float(i + 1)
                                                  for i in range(12)),
                            budgets=tuple(range(12)))]
    db = obs.Dashboard(out=out, total_rounds=6, prof_source=src)
    for i, rec in enumerate(recs):
        if src is not None:
            src.profiles.append(prof[i])
        db.emit(rec)
    db.close()
    return out.getvalue()


@pytest.mark.parametrize("case", ["plain", "compute", "fold"])
@pytest.mark.parametrize("tty", [False, True], ids=["piped", "tty"])
def test_dashboard_bytes_equal_reference(tty, case):
    port = _dashboard_text(port_obs, tty, case)
    assert port == _dashboard_text(ref_obs, tty, case)
    if case == "compute":
        assert ("comp " if tty else "flops_frac=") in port
    if case == "fold" and tty:
        assert "+4 more" in port and "w8" not in port
    assert ("\x1b[" in port) == tty
    assert port_obs.sparkline([0.0, 1.0, 2.0]) == ref_obs.sparkline(
        [0.0, 1.0, 2.0])


# ----------------------------------------------------------------------------
# validate and regress: the same exit codes and rows on the same files
# ----------------------------------------------------------------------------

def _files(tmp_path, case):
    """(argv, expected exit code) of a validate run over files of `case`."""
    m, p = tmp_path / "run.jsonl", tmp_path / "run.prof.jsonl"
    good = [r.to_dict() for r in _records(port_obs)]
    lines = [json.dumps(d) for d in good]
    argv = [str(m)]
    want = 0
    if case == "bad_line":
        lines.insert(1, "{not json}")
        want = 1
    elif case == "not_increasing":
        lines = lines[::-1]
        want = 1
    elif case == "empty":
        lines = []
        want = 1
    elif case == "zero_time":
        lines = [json.dumps(make_record(port_obs, execute_s=0.0).to_dict())]
        argv.append("--require-timing")
        want = 1
    elif case in ("prof", "orphan"):
        rgs = [2, 4] if case == "prof" else [2, 9]
        p.write_text("".join(json.dumps(port_obs.build_profile(
            "cocoa_round", _STATS, 1e-3, kind="round", backend="cpu",
            hw=port_obs.prof.CPU_HOST, round_global=rg).to_dict()) + "\n"
            for rg in rgs))
        argv += ["--prof", str(p)]
        want = 0 if case == "prof" else 1
    m.write_text("".join(ln + "\n" for ln in lines))
    return argv, want


@pytest.mark.parametrize("case", ["good", "bad_line", "not_increasing",
                                  "empty", "zero_time", "prof", "orphan"])
def test_validate_cli_matches_reference(tmp_path, capsys, case):
    argv, want = _files(tmp_path, case)
    outs = []
    for mod in (ref_validate, port_validate):
        assert mod.main(argv) == want
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out
    assert outs[0].err == outs[1].err


def _history(path, metrics):
    path.write_text(json.dumps(
        {"ts": "2026-01-01T00:00:00", "name": "autotune",
         "payload": {"metrics": metrics}}) + "\n")


@pytest.mark.parametrize("step", ["no_history", "pin", "within", "slower",
                                  "report_only", "wide_band", "corrupt",
                                  "new_metric"])
def test_regress_cli_matches_reference(tmp_path, capsys, step):
    """The reference's end-to-end regress walk, one step a case: both
    packages give the same exit code (0, 1 or 2) and the same verdict
    rows."""
    hist, base = tmp_path / "h.jsonl", tmp_path / "b.json"
    argv = ["--history", str(hist), "--baseline", str(base)]
    want, extra = {"no_history": (2, []), "pin": (0, ["--update-baseline"]),
                   "within": (0, []), "slower": (1, []),
                   "report_only": (0, ["--report-only"]),
                   "wide_band": (0, ["--noise-band", "1.5"]),
                   "corrupt": (2, []), "new_metric": (0, [])}[step]
    if step != "no_history":
        _history(hist, {"sparse_sdca_wall_s": 1.0})
    if step not in ("no_history", "pin", "corrupt"):
        ref_regress.write_baseline(base, {"sparse_sdca_wall_s": 1.0})
    if step in ("slower", "report_only", "wide_band"):
        _history(hist, {"sparse_sdca_wall_s": 2.0})
    if step == "corrupt":
        base.write_text("{truncated")
    if step == "new_metric":
        _history(hist, {"sparse_sdca_wall_s": 1.0, "zx_wall_s": 1.0})
    outs = []
    for mod in (ref_regress, port_regress):
        assert mod.main(argv + extra) == want
        outs.append(capsys.readouterr().out)
        if step == "pin":
            assert json.loads(base.read_text())["metrics"] == {
                "sparse_sdca_wall_s": 1.0}
    if step == "no_history":     # the port names its own bench
        assert "no history" in outs[1]
    else:
        assert outs[1].replace(str(base), "B") == outs[0].replace(
            str(base), "B")
    rows = port_regress.compare({"a_s": 0.4, "b_s": 1.2, "c_s": 1.6},
                                {"a_s": 1.0, "b_s": 1.0, "c_s": 1.0})
    assert rows == ref_regress.compare(
        {"a_s": 0.4, "b_s": 1.2, "c_s": 1.6},
        {"a_s": 1.0, "b_s": 1.0, "c_s": 1.0})
    assert port_regress.overall(rows) == ref_regress.overall(rows)


def test_regress_defaults_fail_closed_without_a_baseline(capsys):
    """The port's default trajectory has no committed baseline or history:
    the gate exits 2 rather than passing."""
    assert port_regress.DEFAULT_NAME != ref_regress.DEFAULT_NAME
    assert not port_regress.default_baseline().exists()
    assert port_regress.main([]) == 2
    assert port_regress.main(["--report-only"]) == 0


# ----------------------------------------------------------------------------
# the straggler tracker and budgets on fixed inputs
# ----------------------------------------------------------------------------

def _both(fn):
    return [np.asarray(fn(mod)) for mod in (ref_straggler, port_straggler)]


def test_throughput_tracker_matches_reference():
    def run(mod):
        tr = mod.ThroughputTracker(4, init_rate=1e4, beta=0.5,
                                   slowdown=[1.0, 1.0, 10.0, 1.0])
        for s in (0.01, 0.012, 0.009):
            tr.observe_round(steps_done=256, round_s=s)
        tr.observe_round(steps_done=np.array([256, 256, 32, 256]),
                         round_s=0.01)
        tr.update(np.array([100, 100, 100, 10.0]), np.array([1.0, 1, 1, 1]))
        return np.concatenate([tr.rate, np.asarray(tr.budgets(
            deadline_s=0.01, H_max=1000, H_min=16))])
    ref, port = _both(run)
    np.testing.assert_array_equal(port, ref)
    b = port_straggler.ThroughputTracker(3).budgets(1e-3, 64)
    assert b.dtype == torch.int32 and tuple(b.shape) == (3,)


@pytest.mark.parametrize("rates,deadline,H_max,H_min", [
    ([1e4, np.inf, np.nan, -np.inf], 0.01, 256, 16),
    ([1e4, 5e3, 2e2, 1e5], 0.01, 64, 64),
    ([3.3e3, 7.7e3, 1.1e4, 9e2], 0.02, 128, 16),
])
def test_budget_functions_match_reference(rates, deadline, H_max, H_min):
    rates = np.asarray(rates)
    ref, port = _both(lambda mod: mod.budget_fn_from_rates(
        rates, deadline_s=deadline, H_max=H_max, H_min=H_min)(0))
    np.testing.assert_array_equal(port, ref)

    def tracked(mod):
        tr = mod.ThroughputTracker(4)
        tr.rate = rates.copy()
        return mod.budget_fn_from_tracker(tr, deadline, H_max, H_min)(3)
    ref, port = _both(tracked)
    np.testing.assert_array_equal(port, ref)
    assert ((port >= H_min) & (port <= H_max)).all()


def test_budget_clip_rejects_inverted_interval():
    for mod in (ref_straggler, port_straggler):
        with pytest.raises(ValueError, match="H_max"):
            mod.budget_fn_from_rates(np.full(4, 1e4), deadline_s=0.01,
                                     H_max=16, H_min=256)
        with pytest.raises(ValueError, match="slowdown"):
            mod.ThroughputTracker(4, slowdown=[1.0, 2.0])


# ----------------------------------------------------------------------------
# solve's record stream against the reference's
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    X, y = load("tiny")
    return ref_partition(X, y, K), partition(X, y, K, device="cpu")


@pytest.fixture(scope="module")
def tiny_sparse():
    csr, y = load("tiny_sparse")
    return (ref_partition_sparse(csr, y, K),
            partition_sparse(csr, y, K, device="cpu"))


_EXACT = ("round", "round_global", "rounds_in_record", "wire_floats",
          "wire_bytes", "hops", "comm", "budgets", "throughput")


def _streams_match(ref_recs, port_recs):
    assert len(port_recs) == len(ref_recs) > 0
    for r, p in zip(ref_recs, port_recs):
        rd, pd = r.to_dict(), p.to_dict()
        assert list(pd) == list(rd)
        for key in _EXACT:
            assert pd[key] == rd[key], key
        for key in ("gap", "primal", "dual"):
            np.testing.assert_allclose(pd[key], rd[key], rtol=GAP_RTOL)
        port_obs.validate_record(pd)
        ref_obs.validate_record(pd)
        assert p.execute_s > 0 and p.certificate_s > 0
    assert all(p.compile_s == 0 for p in port_recs[1:])


def _record_pair(ref_data, port_data, kind, rounds, gap_every, ref_state=None,
                 port_state=None, eps_gap=0.0, **cfg):
    buses = {}
    for name, obs in PKGS.items():
        bus = obs.EventBus()
        buses[name] = (bus, bus.subscribe(obs.Aggregator()))
    ref = ref_solve(RefConfig.adding(K, **cfg), *ref_data, rounds=rounds,
                    seed=0, gap_every=gap_every, eps_gap=eps_gap,
                    state=ref_state, obs=buses["reference"][0])
    nk = port_data[1].shape[1]
    key = 0 if ref_state is None else ref_state.rng
    hook = tp.reference_visit_orders(key, rounds, K, nk, cfg["H"], kind)
    port = solve(CoCoAConfig.adding(K, **cfg), *port_data, rounds=rounds,
                 seed=0, gap_every=gap_every, eps_gap=eps_gap,
                 state=port_state, visit_orders=hook,
                 obs=buses["port"][0])
    ref_recs = buses["reference"][1].records
    port_recs = buses["port"][1].records
    _streams_match(ref_recs, port_recs)
    return ref, port, port_recs


def test_solve_records_match_reference_dense(tiny):
    _, port, recs = _record_pair(*tiny, "draws", 7, 3, solver="sdca",
                                 lam=1e-3, H=64)
    assert [r.round for r in recs] == [3, 6, 7]
    assert [r.rounds_in_record for r in recs] == [3, 3, 1]
    # the history is the records' view, plus the port's time lists
    agg = port_obs.Aggregator()
    for r in recs:
        agg.emit(r)
    hist = dict(port.history)
    assert hist.pop("execute_s") == [r.execute_s for r in recs]
    assert hist.pop("certificate_s") == [r.certificate_s for r in recs]
    assert hist == agg.history()
    assert sum(r.wire_floats for r in recs) == recs[-1].comm["comm_floats"]
    assert list(recs[-1].hops) == port.tracer.per_hop()


def test_solve_records_match_reference_sparse_kernel(tiny_sparse):
    _, _, recs = _record_pair(*tiny_sparse, "permutation", 5, 2,
                              solver="sdca_sparse_kernel", lam=1e-3, H=128)
    assert [r.round for r in recs] == [2, 4, 5]


def test_solve_eps_break_matches_reference(tiny):
    ref, port, recs = _record_pair(*tiny, "draws", 30, 1, eps_gap=0.3,
                                   solver="sdca", lam=1e-3, H=512)
    assert recs[-1].gap <= 0.3
    assert recs[-1].round == port.history["round"][-1] < 30
    assert port.state.rounds == int(ref.state.rounds) == recs[-1].round


def test_solve_carried_state_continues_round_global(tiny_sparse):
    cfg = dict(solver="sdca_sparse_kernel", lam=1e-3, H=128)
    ref_mid, port_mid, _ = _record_pair(*tiny_sparse, "permutation", 3, 3,
                                        **cfg)
    _, _, recs = _record_pair(*tiny_sparse, "permutation", 2, 2,
                              ref_state=ref_mid.state,
                              port_state=port_mid.state, **cfg)
    assert [(r.round, r.round_global) for r in recs] == [(2, 5)]


def test_solve_records_budgets_and_rates(tiny):
    """A deadline run with a simulated straggler: every record carries K
    budgets and K EMA rates, the slowed worker's rate the lowest, and the
    on_round hook sees every certified round."""
    _, (Xp, yp, mk) = tiny
    slow = np.ones(K)
    slow[2] = 10.0
    tracker = port_straggler.ThroughputTracker(K, slowdown=slow)
    budget_fn = port_straggler.budget_fn_from_tracker(
        tracker, deadline_s=1e-3, H_max=64, H_min=16)
    bus = port_obs.EventBus()
    agg = bus.subscribe(port_obs.Aggregator())
    seen = []
    cfg = CoCoAConfig.adding(K, loss="hinge", lam=1e-3, H=64,
                             solver="sdca_deadline")
    solve(cfg, Xp, yp, mk, rounds=4, gap_every=2, seed=0, obs=bus,
          budget_fn=budget_fn, throughput=tracker,
          on_round=lambda t, st, gap: seen.append((t, st.rounds, gap)))
    assert [s[:2] for s in seen] == [(2, 2), (4, 4)]
    for rec in agg.records:
        assert len(rec.budgets) == K and len(rec.throughput) == K
        assert min(range(K), key=lambda k: rec.throughput[k]) == 2
        ref_obs.validate_record(rec.to_dict())
    assert agg.last.throughput == tuple(float(v) for v in tracker.rate)
