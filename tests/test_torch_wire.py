"""The port's wire stack against the reference's (`repro.comm`):
compressors, the exchange, the hop plans and tracer, and `solve` under
compression and every reduce topology.

Both sides take the same numpy inputs. The reference draws rand-k's index
sets and QSGD's uniforms from threefry keys; the port takes them as
inputs, and these tests feed it the reference's own draws
(`torch_parity.comm_draws_from_keys`). Where the draws are fed in, or the
scheme is deterministic, messages and residuals are equal bit for bit;
sums over workers within rtol 1e-6 (the association may differ). `solve`
is held to the reference's per-round gaps within 1e-4 relative, as
tests/test_torch_cocoa.py does, with `comm_floats` identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as rcomm
from repro.core import CoCoAConfig as RefConfig, solve as ref_solve
from repro.data import load, partition as ref_partition
from repro.data.sparse import partition_sparse as ref_partition_sparse
from repro_torch import comm
from repro_torch.core import CoCoAConfig, duality, solve
from repro_torch.data import partition, partition_sparse

import torch_parity as tp

K = 8
GAP_RTOL = 1e-4
SUM_RTOL = 1e-6
SCHEMES = ("none", "topk", "randk", "qsgd", "int8")
TOPOLOGIES = ("flat", "hier:2", "a2a")


def _msgs(seed, K_, d, nonzeros=None):
    """(x, residual) (K, d) float32; `nonzeros` keeps that many entries of
    each row of x and zeroes the rest (ties among the zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K_, d)).astype(np.float32)
    r = (0.1 * rng.standard_normal((K_, d))).astype(np.float32)
    if nonzeros is not None:
        keep = np.zeros((K_, d), bool)
        for k in range(K_):
            keep[k, rng.choice(d, nonzeros, replace=False)] = True
        x = np.where(keep, x, 0.0).astype(np.float32)
        r = np.zeros_like(r)
    return x, r


def _keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _pair(name, k=0):
    return rcomm.resolve_compressor(name, k), comm.resolve_compressor(name, k)


def _equal(got, want):
    np.testing.assert_array_equal(tp.to_np(got), np.asarray(want))


# ----------------------------------------------------------------------------
# compressors
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,k,d", [
    ("none", 0, 40), ("topk", 7, 40), ("topk", 64, 40), ("randk", 5, 40),
    ("randk", 64, 40), ("qsgd", 0, 40), ("int8", 0, 40), ("qsgd", 0, 1),
])
def test_compressor_matches_reference_bit_for_bit(name, k, d):
    x, r = _msgs(1, K, d)
    ref, port = _pair(name, k)
    keys = _keys(2, K)
    want_x, want_r = jax.vmap(ref)(jnp.asarray(x), jnp.asarray(r), keys)
    draws = tp.comm_draws_from_keys(keys, name, d, getattr(port, "slots", 0))
    got_x, got_r = port(torch.from_numpy(x), torch.from_numpy(r), draws)
    _equal(got_x, want_x)
    _equal(got_r, want_r)
    assert port.floats_per_message(d) == ref.floats_per_message(d)
    if ref.supports_gather:
        assert port.gather_floats(d) == ref.gather_floats(d)


@pytest.mark.parametrize("nonzeros,k", [(3, 8), (0, 4), (5, 5), (1, 40)])
def test_topk_ties_take_the_lowest_index(nonzeros, k):
    """Fewer nonzeros than k: the zeros tie, and the port picks them in
    `jax.lax.top_k`'s order (magnitude, then the lowest index)."""
    x, r = _msgs(3, K, 40, nonzeros=nonzeros)
    ref, port = _pair("topk", k)
    want, want_r = jax.vmap(ref.encode)(jnp.asarray(x), jnp.asarray(r),
                                        _keys(0, K))
    got, got_r = port.encode(torch.from_numpy(x), torch.from_numpy(r))
    _equal(got.idx, want.idx)
    _equal(got.val, want.val)
    _equal(got_r, want_r)


def test_int8_rounds_half_to_even():
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5]], np.float32)
    ref, port = _pair("int8")
    want, _ = ref(jnp.asarray(x[0]), jnp.zeros(7), None)
    got, _ = port(torch.from_numpy(x), torch.zeros(1, 7))
    _equal(got[0], want)
    assert tp.to_np(got[0]).tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -2.0,
                                         4.0]


@pytest.mark.parametrize("name", ["topk", "randk"])
@pytest.mark.parametrize("M,k", [(2, 7), (3, 7), (3, 8), (2, 1)])
def test_budget_split_matches_reference(name, M, k):
    """The split sparsifier on (K, M, d_local) messages: shard m keeps
    k//M + (m < k%M) live entries of ceil(k/M) slots. The reference reads
    m from `lax.axis_index`, here taken under a named vmap; a worker's
    shards share its draws."""
    d_loc = 12
    x, r = _msgs(4, K * M, d_loc, nonzeros=5)
    r = (0.1 * np.random.default_rng(5).standard_normal(r.shape)
         ).astype(np.float32)
    x3, r3 = x.reshape(K, M, d_loc), r.reshape(K, M, d_loc)
    ref = rcomm.resolve_compressor(name, k).with_shards(M, "model")
    port = comm.resolve_compressor(name, k).with_shards(M)
    assert port.slots == ref.slots == -(-k // M)
    assert [port.live_budget(m) for m in range(M)] == \
        [int(ref.live_budget(m)) for m in range(M)]
    keys = _keys(6, K)
    enc = jax.vmap(jax.vmap(ref.encode, in_axes=(0, 0, None),
                            axis_name="model"))
    want, want_r = enc(jnp.asarray(x3), jnp.asarray(r3), keys)
    draws = tp.comm_draws_from_keys(keys, name, d_loc, port.slots)
    got, got_r = port.encode(torch.from_numpy(x3), torch.from_numpy(r3),
                             None if draws is None else draws[:, None])
    _equal(got.idx, want.idx)
    _equal(got.val, want.val)
    _equal(got_r, want_r)
    live = (tp.to_np(got.idx) < d_loc).sum(axis=-1)
    assert (live <= np.array([port.live_budget(m) for m in range(M)])).all()


def test_merge_sets_and_decode_sum_match_reference():
    """Overlapping sets with sentinel (dead) entries: the merged set, its
    measured unique count and the decoded sum."""
    rng = np.random.default_rng(7)
    d, g, k = 30, 4, 6
    idx = rng.integers(0, 12, size=(2, g, k)).astype(np.int32)
    idx[:, :, -1] = d                                  # dead slots
    val = rng.standard_normal((2, g, k)).astype(np.float32)
    val[:, :, -1] = 0.0
    mi, mv, uniq = jax.vmap(lambda i, v: rcomm.merge_sets(i, v, d))(
        jnp.asarray(idx), jnp.asarray(val))
    pi, pv, pu = comm.merge_sets(torch.from_numpy(idx).long(),
                                 torch.from_numpy(val), d)
    _equal(pi, mi)
    np.testing.assert_allclose(tp.to_np(pv), np.asarray(mv), rtol=SUM_RTOL,
                               atol=1e-7)
    _equal(pu, uniq)
    assert (tp.to_np(pu) < g * k).all()            # duplicates were merged
    want = rcomm.decode_sum(jnp.asarray(idx), jnp.asarray(val), d)
    got = comm.decode_sum(torch.from_numpy(idx), torch.from_numpy(val), d)
    np.testing.assert_allclose(tp.to_np(got), np.asarray(want),
                               rtol=SUM_RTOL, atol=1e-7)
    np.testing.assert_allclose(
        tp.to_np(comm.decode_sum(pi, pv, d)), tp.to_np(got), rtol=SUM_RTOL,
        atol=1e-6)


def test_sparse_message_rebase():
    m = comm.SparseMessage(torch.tensor([0, 3]), torch.tensor([1.0, 2.0]))
    assert m.rebase(10).idx.tolist() == [10, 13]
    assert m.rebase(10).rebase(-10).idx.tolist() == [0, 3]


def test_resolve_rejects_unknown_and_bad_budgets():
    with pytest.raises(ValueError, match="unknown compressor"):
        comm.resolve_compressor("zip")
    with pytest.raises(ValueError, match="k >= 1"):
        comm.resolve_compressor("topk", 0)
    with pytest.raises(NotImplementedError, match="needs topk or randk"):
        comm.resolve_compressor("int8").encode(torch.zeros(2, 3),
                                               torch.zeros(2, 3))
    with pytest.raises(ValueError, match="index draws"):
        comm.resolve_compressor("randk", 2)(torch.zeros(2, 3),
                                            torch.zeros(2, 3))


@pytest.mark.parametrize("method", ["none", "int8", "topk:0.25"])
def test_pytree_api_matches_reference(method):
    from repro.comm import compress as rc
    from repro_torch.comm import compress as pc
    rng = np.random.default_rng(8)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32)]}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": [torch.from_numpy(tree["b"][0])]}
    want, wef = rc.compress(jtree, None, method)
    got, gef = pc.compress(ttree, None, method)
    for _ in range(2):           # a second round through the residuals
        want, wef = rc.compress(jtree, wef, method)
        got, gef = pc.compress(ttree, gef, method)
    _equal(got["a"], want["a"])
    _equal(got["b"][0], want["b"][0])
    if method != "none":
        _equal(gef.residual["a"], wef.residual["a"])
    assert pc.compressed_bytes(ttree, method) == \
        rc.compressed_bytes(jtree, method)


# ----------------------------------------------------------------------------
# the exchange
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_exchange_matches_reference(topology, scheme, gather):
    d, k = 48, 6
    x, r = _msgs(9, K, d)
    ref_comp, port_comp = _pair(scheme, k)
    ref_topo = rcomm.Topology.simulated(K, topology=topology)
    port_topo = comm.Topology.simulated(K, topology=topology)
    p = comm.AggParams(1.0, 4.0)
    keys = _keys(10, K)
    args = (jnp.asarray(x), jnp.asarray(r), keys, rcomm.AggParams(1.0, 4.0),
            ref_comp)
    draws = tp.comm_draws_from_keys(keys, scheme, d,
                                    getattr(port_comp, "slots", 0))
    if gather and not port_comp.supports_gather:
        with pytest.raises(ValueError, match="topk/randk"):
            rcomm.exchange(ref_topo, *args, gather=True)
        with pytest.raises(ValueError, match="topk/randk"):
            comm.exchange(port_topo, torch.from_numpy(x),
                          torch.from_numpy(r), p, port_comp, gather=True,
                          draws=draws)
        return
    ref_stats, port_stats = {}, {}
    want, want_ef = rcomm.exchange(ref_topo, *args, gather=gather,
                                   stats=ref_stats)
    got, got_ef = comm.exchange(port_topo, torch.from_numpy(x),
                                torch.from_numpy(r), p, port_comp,
                                gather=gather, stats=port_stats, draws=draws)
    _equal(got_ef, want_ef)
    np.testing.assert_allclose(tp.to_np(got), np.asarray(want),
                               rtol=SUM_RTOL, atol=1e-7)
    assert set(port_stats) == set(ref_stats)
    if "inter_gather" in ref_stats:
        assert int(port_stats["inter_gather"]) == \
            int(ref_stats["inter_gather"])


@pytest.mark.parametrize("scheme", ["topk", "randk"])
def test_gather_form_equals_dense_form(scheme):
    """The gathered sets decode to the dense form's sum, with the same EF
    residual: gather is a wire-routing choice."""
    x, r = _msgs(11, K, 64, nonzeros=10)
    comp = comm.resolve_compressor(scheme, 16)
    draws = comp.draw(K, 64, torch.Generator().manual_seed(0))
    topo = comm.Topology.simulated(K, "hier:4")
    p = comm.AggParams(1.0, 2.0)
    args = (torch.from_numpy(x), torch.from_numpy(r), p, comp)
    dense, ef_d = comm.exchange(topo, *args, draws=draws)
    gath, ef_g = comm.exchange(topo, *args, gather=True, draws=draws)
    torch.testing.assert_close(gath, dense, rtol=SUM_RTOL, atol=1e-7)
    assert torch.equal(ef_d, ef_g)


def test_flush_ef_matches_reference():
    x, r = _msgs(12, K, 10)
    p = comm.AggParams(0.5, 2.0)
    want = rcomm.flush_ef(jnp.asarray(x[0]), jnp.asarray(r),
                          rcomm.AggParams(0.5, 2.0))
    got = comm.flush_ef(torch.from_numpy(x[0]), torch.from_numpy(r), p)
    np.testing.assert_allclose(tp.to_np(got), np.asarray(want),
                               rtol=SUM_RTOL)


def test_topology_validation_matches_reference():
    for spec in ("flat", "a2a", "hier:2", "hier:4", "hier:8", None, ""):
        want = rcomm.Topology.simulated(K, topology=spec)
        got = comm.Topology.simulated(K, topology=spec)
        assert (got.reduce, got.group) == (want.reduce, want.group)
    for spec in ("hier:3", "hier:16", "hier:1", "ring"):
        with pytest.raises(ValueError):
            rcomm.Topology.simulated(K, topology=spec)
        with pytest.raises(ValueError):
            comm.Topology.simulated(K, topology=spec)
    assert comm.parse_reduce("hier:4") == rcomm.parse_reduce("hier:4")


# ----------------------------------------------------------------------------
# hop plans and the tracer
# ----------------------------------------------------------------------------

def _hops(hops):
    return [(h.name, h.messages, h.floats_per_message, h.axis, h.floats)
            for h in hops]


@pytest.mark.parametrize("topology", TOPOLOGIES + ("hier:4",))
@pytest.mark.parametrize("scheme,k,gather", [
    ("none", 0, False), ("topk", 64, False), ("topk", 64, True),
    ("randk", 33, True), ("qsgd", 0, False), ("int8", 0, False)])
def test_hops_and_tracer_totals_match_reference(topology, scheme, k, gather):
    for d_local in (47_236, 23_618, 13, 5):
        ref_comp, port_comp = _pair(scheme, k)
        ref_topo = rcomm.Topology.simulated(K, topology=topology)
        port_topo = comm.Topology.simulated(K, topology=topology)
        f_msg = port_comp.floats_per_message(d_local)
        f_set = port_comp.gather_floats(d_local) if gather else None
        assert _hops(port_topo.hops(f_msg, d_local, f_set)) == \
            _hops(ref_topo.hops(f_msg, d_local, f_set))
        extra = (comm.Hop("model_zx", K * 2, 17 * 16, axis="model"),)
        rt = rcomm.CommTracer.for_run(
            K=K, d_local=d_local, compressor=ref_comp, topo=ref_topo,
            gather=gather, extra_hops=(rcomm.Hop("model_zx", K * 2, 17 * 16,
                                                 axis="model"),))
        pt = comm.CommTracer.for_run(K=K, d_local=d_local,
                                     compressor=port_comp, topo=port_topo,
                                     gather=gather, extra_hops=extra)
        for t, wire in enumerate((100, 90, 80)):
            rt.tick()
            pt.tick()
            if gather and topology.startswith("hier"):
                rt.observe("inter_gather", jnp.asarray(wire))
                pt.observe("inter_gather", torch.tensor(wire))
            assert pt.totals() == rt.totals()
        assert pt.per_round() == rt.per_round()
        assert pt.per_hop() == rt.per_hop()
        assert pt.per_axis() == rt.per_axis()


def test_model_hops_match_reference():
    from repro.comm.placement import WSpec as RefWSpec
    zx = {"exchanges": 21, "block_rows": 16}
    for M in (1, 2, 4):
        ax = "model" if M > 1 else None
        for plan in (None, zx):
            want = rcomm.model_hops(RefWSpec(47_236, M, ax), 4, 1000,
                                    zx_plan=plan)
            got = comm.model_hops(comm.WSpec(47_236, M, ax), 4, 1000,
                                  zx_plan=plan)
            assert _hops(got) == _hops(want)
    assert comm.accel_hops("nesterov") == rcomm.accel_hops("nesterov") == ()


# ----------------------------------------------------------------------------
# solve under compression, every topology
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


def _solve_pair(data, rounds=5, draws=None, **cfg):
    ref_data, port_data = data
    ref = ref_solve(RefConfig.adding(K, **cfg), *ref_data, rounds=rounds,
                    seed=0)
    nk = port_data[1].shape[1]
    hook = tp.reference_visit_orders(0, rounds, K, nk, cfg["H"],
                                     "permutation")
    port = solve(CoCoAConfig.adding(K, **cfg), *port_data, rounds=rounds,
                 seed=0, visit_orders=hook, comm_draws=draws)
    assert port.history["round"] == ref.history["round"]
    np.testing.assert_allclose(port.history["gap"], ref.history["gap"],
                               rtol=GAP_RTOL)
    np.testing.assert_allclose(port.history["primal"],
                               ref.history["primal"], rtol=GAP_RTOL)
    for key in ("comm_floats", "comm_vectors", "comm_bytes", "comm_psums"):
        assert port.history[key] == ref.history[key], key
    return ref, port


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("scheme,gather", [("none", False), ("topk", False),
                                           ("topk", True), ("int8", False)])
@pytest.mark.parametrize("dataset", ["tiny", "tiny_sparse"])
def test_solve_matches_reference(request, dataset, scheme, gather, topology):
    _, port = _solve_pair(request.getfixturevalue(dataset),
                          solver="sdca_kernel", lam=1e-3, H=128,
                          compress=scheme, compress_k=16, topology=topology,
                          gather=gather)
    gaps = port.history["gap"]
    assert gaps[-1] < gaps[0]
    if gather and topology == "hier:2":
        assert port.state.wire is not None


@pytest.mark.parametrize("scheme", ["randk", "qsgd"])
def test_solve_with_the_references_draws(tiny_sparse, scheme):
    """The random schemes through `solve`, fed the reference's compressor
    draws round by round."""
    d = tiny_sparse[1][0].d
    slots = 32 if scheme == "randk" else 0
    draws = tp.reference_comm_draws(0, 4, K, d, scheme, slots)
    _solve_pair(tiny_sparse, rounds=4, draws=draws, solver="sdca_kernel",
                lam=1e-3, H=128, compress=scheme, compress_k=32,
                topology="hier:4", gather=scheme == "randk")


def test_compressed_runs_certify_at_the_carried_v(tiny_sparse, monkeypatch):
    """Under compression the certificate is `gap_at_v` at the carried v
    (the lossy exchange lets v drift from v(alpha)); without it,
    `gap_decomposed`."""
    calls = []
    for name in ("gap_at_v", "gap_decomposed"):
        real = getattr(duality, name)
        monkeypatch.setattr(duality, name,
                            lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    _, port_data = tiny_sparse
    runs = {}
    for scheme, want in (("topk", "gap_at_v"), ("none", "gap_decomposed")):
        calls.clear()
        runs[scheme] = solve(CoCoAConfig.adding(
            K, solver="sdca_kernel", lam=1e-3, H=128, compress=scheme,
            compress_k=16), *port_data, rounds=2, seed=0)
        assert calls == [want, want]
    from repro_torch.core.losses import get_loss
    r = runs["topk"]
    _, _, g = duality.gap_at_v(r.state.w, r.state.alpha, *port_data,
                               get_loss("hinge"), 1e-3)
    assert float(g) == r.history["gap"][-1]
    _, _, g_alpha = duality.gap_decomposed(r.state.alpha, *port_data,
                                           get_loss("hinge"), 1e-3)
    assert float(g_alpha) != r.history["gap"][-1]   # v drifted from v(alpha)


def test_gather_config_checks():
    with pytest.raises(ValueError, match="sparse-set compressor"):
        CoCoAConfig(compress="int8", gather=True).compressor()
    split = CoCoAConfig(compress="topk", compress_k=7, gather=True,
                        model_axis="model").compressor(M=2)
    assert (split.k, split.shards, split.slots) == (7, 2, 4)
    dense = CoCoAConfig(compress="topk", compress_k=7).compressor(M=2)
    assert dense.shards == 1


MESH_CASES = {"topk15_gather_hier2": dict(compress="topk", compress_k=15,
                                          gather=True, topology="hier:2"),
              "int8_a2a": dict(compress="int8", topology="a2a")}
MESH_KW = dict(loss="hinge", lam=1e-3, H=128, backend="shard_map",
               model_axis="model", solver="sdca_kernel")


@pytest.fixture(scope="module")
def ref_mesh():
    """The reference's 2-D solves under compression on a (2, 2) mesh of
    forced host devices (a child process, as tests/test_torch_mesh2d.py):
    top-k 15 gathered over hier:2 with the budget split 8 / 7 over the two
    model shards, and int8 over a2a."""
    return tp.reference_in_child(f"""
        import jax
        from repro.core import CoCoAConfig, solve
        from repro.data import load
        from repro.data.sparse import partition_sparse
        csr, y = load("tiny_sparse")
        fs, yp, mk = partition_sparse(csr, y, 2, seed=0, M=2)
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for name, extra in {MESH_CASES!r}.items():
            r = solve(CoCoAConfig.adding(2, **{MESH_KW!r}, **extra), fs, yp,
                      mk, rounds=4, gap_every=1, seed=2, mesh=mesh)
            out[name + "_gap"] = np.asarray(r.history["gap"])
            out[name + "_floats"] = np.asarray(r.history["comm_floats"])
            if r.state.wire is not None:
                out[name + "_wire"] = np.asarray(r.state.wire)
    """)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_solve_under_compression_matches_reference(ref_mesh, case):
    """The one-card (2, 2) mesh under compression: per-round gaps within
    1e-4, the wire plan (with hier gather's measured inter volume, averaged
    over the model shards) identical."""
    from repro_torch.launch.mesh import make_test_mesh
    csr, y = load("tiny_sparse")
    fs, yp, mk = partition_sparse(csr, y, 2, seed=0, M=2, device="cpu")
    hook = tp.reference_visit_orders(2, 4, 2, yp.shape[1], 128,
                                     "permutation")
    r = solve(CoCoAConfig.adding(2, **MESH_KW, **MESH_CASES[case]), fs, yp,
              mk, rounds=4, seed=2, visit_orders=hook,
              mesh=make_test_mesh((2, 2), device="cpu"))
    np.testing.assert_allclose(r.history["gap"], ref_mesh[case + "_gap"],
                               rtol=GAP_RTOL)
    assert r.history["comm_floats"] == list(ref_mesh[case + "_floats"])
    if case + "_wire" in ref_mesh:
        assert int(r.state.wire) == int(ref_mesh[case + "_wire"])
    assert float(r.state.w[fs.d:].abs().sum()) == 0.0


# ----------------------------------------------------------------------------
# on the card: the same selection and scatters as on the CPU
# ----------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_wire.py`")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 3])
def test_cuda_topk_ties_and_sentinels_match_cpu(card, M):
    """`torch.topk` leaves ties unordered on the card; the stable sort does
    not. Dead slots (the sentinel d) are dropped by every scatter."""
    x, r = _msgs(13, K * M, 200, nonzeros=3)
    x3, r3 = (torch.from_numpy(a.reshape(K, M, 200)) for a in (x, r))
    comp = comm.resolve_compressor("topk", 8).with_shards(M)
    cpu = comp.encode(x3, r3)
    dev = comp.encode(x3.to(card), r3.to(card))
    assert torch.equal(dev[0].idx.cpu(), cpu[0].idx)
    assert torch.equal(dev[0].val.cpu(), cpu[0].val)
    assert torch.equal(dev[1].cpu(), cpu[1])
    got = comm.decode_sum(dev[0].idx[:, 0], dev[0].val[:, 0], 200)
    want = comm.decode_sum(cpu[0].idx[:, 0], cpu[0].val[:, 0], 200)
    torch.testing.assert_close(got.cpu(), want, rtol=SUM_RTOL, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,gather", [("topk", True), ("randk", False),
                                           ("qsgd", False), ("int8", False)])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_cuda_exchange_matches_cpu(card, topology, scheme, gather):
    """The exchange on the card against the CPU on the same draws: the EF
    residuals bit for bit (elementwise arithmetic, the same selection);
    the sums over workers within 1e-6 of their largest entry (the card
    reduces, and scatter-adds with atomics, in another order, and an
    entry that cancels to ~0 keeps the larger entries' rounding)."""
    x, r = _msgs(14, K, 1000)
    topo = comm.Topology.simulated(K, topology)
    p = comm.AggParams(1.0, 8.0)
    comp = comm.resolve_compressor(scheme, 50)
    draws = comp.draw(K, 1000, torch.Generator().manual_seed(1))
    cpu = comm.exchange(topo, torch.from_numpy(x), torch.from_numpy(r), p,
                        comp, gather=gather, draws=draws)
    dev = comm.exchange(topo, torch.from_numpy(x).to(card),
                        torch.from_numpy(r).to(card), p, comp,
                        gather=gather, draws=draws)
    assert torch.equal(dev[1].cpu(), cpu[1])
    err = float((dev[0].cpu() - cpu[0]).abs().max())
    assert err <= SUM_RTOL * float(cpu[0].abs().max()), err
