"""The port's MoE (llama4-scout, llama4-maverick), M-RoPE and embedding
inputs (qwen2-vl-7b) held against the reference on the CPU, with the
reference's weights carried across by `params_from_reference`.

Tolerances: `moe_forward` at rtol 1e-5 / atol 1e-6 in float32 (the same
formulas, sums in another order), the atol in units of the output's
largest magnitude: the reference's expert init has scale 1/sqrt(E) (its
`dense_init` takes shape[0] = E as the fan-in), so the smoke layer's
outputs reach ~30, and an element near 0 that is a difference of such
terms parts by a few float32 ulps of 30 (2.6e-6 seen); its routes
(expert, slot, keep) equal;
the scoring loss, xent and aux at rtol 1e-5; prefill and decode logits at
rtol 1e-4 / atol 1e-5, as tests/test_torch_models.py holds the dense
archs; one training step as tests/test_torch_train.py holds one.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_runtime import ServingEngine as TEngine
from repro_torch.launch.train import init_opt, train_step
from repro_torch.models import layers as TL, model as TM
from repro_torch.models.config import Block

import torch_parity as tp

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.launch.serving_runtime import ServingEngine as REngine  # noqa
from repro.launch.train import train_step as ref_train_step  # noqa: E402
from repro.models import layers as RL, model as RM  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
LLAMA4 = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b")
NEW_ARCHS = LLAMA4 + ("qwen2-vl-7b",)


def _t(a):
    return torch.from_numpy(np.array(a))      # a writable copy


def _params(tree):
    """A reference dict of arrays as the port's `Params`."""
    return TL.Params(**{k: _params(v) if isinstance(v, dict) else _t(v)
                        for k, v in tp.tree_to_numpy(tree).items()})


@functools.lru_cache(maxsize=None)
def _weights(arch, **change):
    cfg = dataclasses.replace(rconfigs.smoke_config(arch), **change)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, TM.params_from_reference(tp.tree_to_numpy(params),
                                                 cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_steps(cfg):
    """The reference's prefill and decode_step, jitted for `cfg`."""
    return (jax.jit(functools.partial(RM.prefill, cfg=cfg)),
            jax.jit(functools.partial(RM.decode_step, cfg=cfg)))


# ----------------------------------------------------------------------------
# moe_forward and its routes
# ----------------------------------------------------------------------------

def _ref_routes(params, x, cfg, groups):
    """The reference's routes, as its `moe_forward` computes them
    (src/repro/models/layers.py:364-381): (expert, slot, keep, logits),
    each (G, T/G)."""
    B, S, d = x.shape
    E, T = cfg.n_experts, B * S
    xt = x.reshape(groups, T // groups, d)
    logits = (xt @ params["router"]).astype(jnp.float32)
    eid = jnp.argmax(jax.nn.softmax(logits, axis=-1), axis=-1)
    onehot = jax.nn.one_hot(eid, E, dtype=jnp.int32)
    C = max(1, int(math.ceil(T // groups * cfg.capacity_factor / E)))
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    return (np.asarray(eid), np.asarray(pos), np.asarray(pos < C),
            np.asarray(logits))


@pytest.mark.parametrize("arch", LLAMA4)
@pytest.mark.parametrize("cf", [0.25, 1.25, 64.0])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_forward_matches_reference(arch, cf, groups):
    """Outputs and aux within rtol 1e-5 / atol 1e-6, the routes equal, at
    capacities that drop (0.25), may drop (1.25) and never drop (64). The
    port dispatches in one group; the reference's G = 2 (`set_moe_ctx`)
    gives each group its own capacity, which the port gives by running
    each group's tokens (here one sequence each) as its own call. The
    aux is over all tokens whatever G."""
    cfg = dataclasses.replace(rconfigs.smoke_config(arch),
                              capacity_factor=cf)
    dff = cfg.d_ff
    p = RL.init_moe(jax.random.PRNGKey(7), cfg, dff, jnp.float32)
    x = np.random.default_rng(7).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    RL.set_moe_ctx(groups=groups)
    try:
        want, want_aux = RL.moe_forward(p, jnp.asarray(x), cfg, dff)
        eid, pos, keep, logits = _ref_routes(p, jnp.asarray(x), cfg, groups)
    finally:
        RL.set_moe_ctx()
    tp_ = _params(p)
    xg = _t(x).reshape(groups, -1, cfg.d_model)
    with torch.no_grad():
        got = torch.cat([TL.moe_forward(tp_, xs[None], cfg, dff)[0]
                         for xs in xg]).reshape(x.shape)
        _, got_aux = TL.moe_forward(tp_, _t(x), cfg, dff)
        routes = [TL.moe_route(tp_, xs, cfg) for xs in xg]
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * scale)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    print(f"{arch} cf {cf} G {groups}: smallest top-1/top-2 logit gap "
          f"{float((top2[..., 1] - top2[..., 0]).min()):.3e}, "
          f"{int((~keep).sum())} of {keep.size} tokens dropped")
    for k, want_r in ((0, eid), (2, pos), (3, keep)):     # expert, slot, keep
        np.testing.assert_array_equal(
            torch.stack([r[k] for r in routes]).numpy(), want_r)
    if cf == 0.25:
        assert not keep.all()
    if cf == 64.0:
        assert keep.all()


def test_dropped_tokens_get_only_the_shared_expert():
    """A token at slot >= C gets 0 from the experts: its output is the
    shared expert's alone."""
    cfg = dataclasses.replace(tconfigs.smoke_config(LLAMA4[0]),
                              capacity_factor=0.25)
    gen = torch.Generator().manual_seed(3)
    p = TL.init_moe(gen, cfg, cfg.d_ff, torch.float32)
    x = torch.randn(1, 32, cfg.d_model, generator=gen)
    with torch.no_grad():
        out, _ = TL.moe_forward(p, x, cfg, cfg.d_ff)
        _, _, _, keep, _ = TL.moe_route(p, x[0], cfg)
        shared = TL.mlp_forward(p.shared, x, "swiglu")
    dropped = ~keep
    assert dropped.any() and keep.any()
    torch.testing.assert_close(out[0, dropped], shared[0, dropped],
                               rtol=0, atol=0)
    assert not torch.allclose(out[0, ~dropped], shared[0, ~dropped])


def test_init_moe_draws_experts_one_at_a_time():
    """Each expert stack has the reference's shape and scale
    (1/sqrt(E): `dense_init`'s fan_in is shape[0]); the shared expert is
    a swiglu MLP of the expert width."""
    cfg = dataclasses.replace(tconfigs.smoke_config(LLAMA4[1]),
                              n_experts=16)
    p = TL.init_moe(torch.Generator().manual_seed(0), cfg, 96,
                    torch.bfloat16)
    E, d = cfg.n_experts, cfg.d_model
    assert p.router.shape == (d, E)
    assert p.wi.shape == p.wg.shape == (E, d, 96) and p.wo.shape == (E, 96, d)
    assert p.wi.dtype == torch.bfloat16
    for w in (p.wi, p.wg, p.wo):
        assert abs(float(w.detach().float().std()) - 1 / math.sqrt(E)) < 0.01
        assert not torch.equal(w[0], w[1])
    assert set(dict(p.shared.named_parameters())) == {"wi", "wg", "wo"}
    meta = TL.init_moe(None, cfg, 96, torch.bfloat16)
    assert meta.wi.device.type == "meta"


def test_dense_init_draws_a_stack_slice_by_slice():
    """A stack of 3 axes is its slices drawn in turn from the generator,
    each at the stack's scale 1/sqrt(shape[0]); a matrix is one draw."""
    stack = TL.dense_init(torch.Generator().manual_seed(5), (3, 4, 6),
                          torch.float32)
    gen = torch.Generator().manual_seed(5)
    pieces = [TL.dense_init(gen, (4, 6), torch.float32,
                            scale=1 / math.sqrt(3)) for _ in range(3)]
    torch.testing.assert_close(stack, torch.stack(pieces), rtol=0, atol=0)
    mat = TL.dense_init(torch.Generator().manual_seed(5), (4, 6),
                        torch.float32)
    want = torch.randn(4, 6, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(mat, want / 2, rtol=0, atol=0)


# ----------------------------------------------------------------------------
# the model: loss, prefill and decode, serving
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LLAMA4)
def test_forward_train_matches_reference(arch):
    cfg, params, model = _weights(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab, (2, 64))
    labels = rng.integers(1, cfg.vocab, (2, 64))
    want, wm = RM.forward_train(params, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)}, cfg)
    with torch.no_grad():
        got, gm = TM.forward_train(model, {"tokens": _t(toks),
                                           "labels": _t(labels)}, cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    for key in ("xent", "moe_aux"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=RTOL)
    assert float(gm["moe_aux"]) > 0
    assert float(got) == float(gm["xent"] + 0.01 * gm["moe_aux"])


def test_moe_capacity_drops_tokens():
    """tests/test_models.py::test_moe_capacity_drops_tokens on the port:
    with a tiny capacity tokens drop (the loss moves from the dropless
    one), both stay finite, and the aux is there."""
    cfg0 = tconfigs.smoke_config("llama4-scout-17b-a16e")
    model = TM.init_params(cfg0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": _t(rng.integers(1, cfg0.vocab, (2, 64))),
             "labels": _t(rng.integers(1, cfg0.vocab, (2, 64)))}
    with torch.no_grad():
        l1, m1 = TM.forward_train(
            model, batch, dataclasses.replace(cfg0, capacity_factor=0.25))
        l2, _ = TM.forward_train(
            model, batch, dataclasses.replace(cfg0, capacity_factor=64.0))
    assert torch.isfinite(l1) and torch.isfinite(l2)
    assert float(m1["moe_aux"]) > 0
    assert abs(float(l1) - float(l2)) > 1e-6


def _vl_positions(B, n_text, grid, n_after):
    """qwen2-vl's three streams for a text prefix, a grid x grid image
    (temporal constant, height and width along the grid) and more text
    from the largest position + 1: (3, B, n_text + grid² + n_after)."""
    t = np.arange(n_text)
    r, c = np.divmod(np.arange(grid * grid), grid)
    after = n_text + grid + np.arange(n_after)
    streams = np.stack([
        np.concatenate([t, np.full(grid * grid, n_text), after]),
        np.concatenate([t, n_text + r, after]),
        np.concatenate([t, n_text + c, after])]).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(
        streams[:, None], (3, B, streams.shape[1])))


def _prompt(cfg, B, P, seed):
    """A prefill batch: tokens, or embeds with M-RoPE streams that
    differ (with equal streams M-RoPE is plain RoPE)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(1, cfg.vocab, (B, P))}
    pos = _vl_positions(B, 4, 3, P - 13)
    assert not (pos[0] == pos[1]).all()
    return {"embeds": rng.standard_normal((B, P, cfg.d_model)).astype(
        np.float32), "positions": pos}


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("flag", [False, True])
def test_prefill_and_decode_match_reference(arch, flag):
    """Logits within rtol 1e-4 / atol 1e-5 and the caches too; decode at
    B = 2 gives each expert C = 1 slot, so a step can drop a token.
    qwen2-vl's 3-D positions keep it off the flash path either way."""
    cfg, params, model = _weights(arch, use_flash_attention=flag)
    B, P, S_max = 2, 20, 32
    batch = _prompt(cfg, B, P, 10)
    prefill, decode = _ref_steps(cfg)
    want, rcache = prefill(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           cache=RM.init_cache(cfg, B, S_max))
    tcache = TM.init_cache(cfg, B, S_max, device="cpu")
    got, tcache = TM.prefill(model, {k: _t(v) for k, v in batch.items()},
                             tcache, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for step in range(4):
        pos = P + step
        want, rcache = decode(params, rcache, jnp.asarray(nxt, jnp.int32),
                              jnp.int32(pos))
        got, tcache = TM.decode_step(model, tcache, _t(nxt), pos, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
        nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for g, w in zip(tcache, tp.reference_cache_layers(rcache, cfg)):
        for key in g:
            np.testing.assert_allclose(tp.to_np(g[key]), w[key], rtol=1e-4,
                                       atol=1e-5)


def test_mrope_mask_reads_the_temporal_stream(monkeypatch):
    """Under M-RoPE the prefill hands chunked_attention the temporal
    stream (B, S), and the flash kernel is never called."""
    cfg, _, model = _weights("qwen2-vl-7b", use_flash_attention=True)
    batch = _prompt(cfg, 2, 20, 4)
    seen = []
    real = TL.chunked_attention
    monkeypatch.setattr(TL, "chunked_attention",
                        lambda q, k, v, pos, **kw: seen.append(pos)
                        or real(q, k, v, pos, **kw))
    monkeypatch.setattr(TM, "flash_attention", lambda *a, **kw: 1 / 0)
    TM.prefill(model, {k: _t(v) for k, v in batch.items()},
               TM.init_cache(cfg, 2, 32, "cpu"))
    assert len(seen) == cfg.n_layers
    for pos in seen:
        np.testing.assert_array_equal(pos.numpy(), batch["positions"][0])


def test_serve_steps_run_qwen2_vl():
    """`launch.serve` on an embeddings model: prefill_step from embeds and
    positions, then serve_step's greedy tokens, against the reference's
    `launch.serve` (decode writes one position to all three streams)."""
    cfg, params, model = _weights("qwen2-vl-7b")
    batch = _prompt(cfg, 2, 24, 5)
    rlog, rcache = rserve.prefill_step(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        RM.init_cache(cfg, 2, 40), cfg=cfg)
    tlog, tcache = tserve.prefill_step(
        model, {k: _t(v) for k, v in batch.items()},
        TM.init_cache(cfg, 2, 40, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), rtol=1e-4,
                               atol=1e-5)
    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]
    for pos in (24, 25, 26):
        rn, rcache = rserve.serve_step(params, rcache,
                                       jnp.asarray(nxt, jnp.int32), pos,
                                       cfg=cfg)
        tn, tcache = tserve.serve_step(model, tcache, _t(nxt), pos)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
        nxt = np.asarray(rn)


def test_engine_refuses_an_embeddings_model():
    cfg, _, model = _weights("qwen2-vl-7b")
    with pytest.raises(NotImplementedError, match="prefill_step"):
        TEngine(cfg, model, slots=2, s_max=32, device="cpu")


@pytest.mark.parametrize("arch", LLAMA4)
def test_engine_gives_the_reference_tokens_under_decode_drops(arch,
                                                             monkeypatch):
    """slots 2, s_max 96, capacity 1.25: a decode step's T = 2 tokens give
    each expert one slot, so a slot whose expert the other slot (dead or
    live) took first gets the shared expert alone. Both engines give the
    same tokens and live counts; the decode dropped tokens."""
    cfg, params, model = _weights(arch)
    assert cfg.capacity_factor == 1.25
    ref = REngine(cfg, params, slots=2, s_max=96)
    port = TEngine(cfg, model, slots=2, s_max=96, device="cpu")
    drops = []
    real = TL.moe_route

    def route(p, xt, c):
        out = real(p, xt, c)
        if xt.shape[0] == port.B:             # a decode step's batch
            drops.append(int((~out[3]).sum()))
        return out
    monkeypatch.setattr(TL, "moe_route", route)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 500, (p,)).astype(np.int32)
               for p in (5, 9, 7, 4, 11, 6)]
    rreqs = [ref.submit(p, max_new=6) for p in prompts]
    treqs = [port.submit(p, max_new=6) for p in prompts]
    live = []
    for _ in range(100):
        a, b = ref.step(), port.step()
        live.append((a, b))
        if a == 0 and not ref.queue:
            break
    assert all(a == b for a, b in live), live
    for r, t in zip(rreqs, treqs):
        assert t.done and r.done and t.out == r.out, (t.out, r.out)
    print(f"{arch}: decode drops per MoE call {drops}")
    assert sum(drops) > 0


def test_count_params_moe_active():
    """tests/test_models.py::test_count_params_moe_active on the port."""
    cfg = tconfigs.get_config("llama4-maverick-400b-a17b")
    total = TM.count_params(cfg)
    active = TM.count_params(cfg, active_only=True)
    assert total > 3.5e11 and active < 2.5e10
    assert (total, active) == (400_711_848_960, 17_184_691_200)
    scout = tconfigs.get_config("llama4-scout-17b-a16e")
    assert (TM.count_params(scout), TM.count_params(scout, True)) == (
        107_769_861_120, 17_172_894_720)


@pytest.mark.parametrize("change", [
    dict(pattern=(Block(mlp="moe"),), n_experts=4, shared_expert=True),
    dict(mrope_sections=(2, 3, 3), rope_pct=1.0),
    dict(input_mode="embeddings"),
])
def test_ported_model_features_now_build(change):
    """MoE, M-RoPE and embedding inputs, which raised naming item 13
    before this slice, build and run on a dense smoke config."""
    cfg = dataclasses.replace(tconfigs.smoke_config("stablelm-1.6b"),
                              **change)
    model = TM.init_params(cfg, device="cpu")
    rng = np.random.default_rng(2)
    batch = {"labels": _t(rng.integers(1, cfg.vocab, (2, 16)))}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = _t(rng.standard_normal((2, 16, cfg.d_model))
                             .astype(np.float32))
    else:
        batch["tokens"] = _t(rng.integers(1, cfg.vocab, (2, 16)))
    with torch.no_grad():
        loss, m = TM.forward_train(model, batch, cfg)
    assert torch.isfinite(loss)
    assert (float(m["moe_aux"]) > 0) == ("pattern" in change)


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

def _named(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def test_train_step_matches_reference():
    """One AdamW step on smoke scout (float32) against the reference's
    `train_step`: loss, grad_norm, and every weight after the step, the
    router's and the experts' among them (the gate carries the router's
    gradient, the aux loss too)."""
    arch = "llama4-scout-17b-a16e"
    cfg = dataclasses.replace(rconfigs.smoke_config(arch), dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    init = tp.tree_to_numpy(params)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    after, _, m = jax.jit(lambda p, o, b: ref_train_step(p, o, b, cfg=cfg))(
        params, ref_adamw_init(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = TM.params_from_reference(init, cfg, device="cpu")
    model, _, got = train_step(model, init_opt(model),
                               {k: _t(v) for k, v in batch.items()}, cfg=cfg)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got["moe_aux"]), float(m["moe_aux"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(m["grad_norm"]), rtol=1e-4)
    want = _named(TM.params_from_reference(tp.tree_to_numpy(after), cfg,
                                           device="cpu"))
    before = _named(TM.params_from_reference(init, cfg, device="cpu"))
    for n, p in _named(model).items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)
    assert not torch.equal(_named(model)["blocks.0.moe.router"],
                           before["blocks.0.moe.router"])


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_carries_the_moe_aux(policy):
    """Under remat each block's aux leaves the checkpointed function: the
    loss and every grad equal the un-rematerialized ones bit for bit."""
    cfg, _, model = _weights("llama4-maverick-400b-a17b")
    rng = np.random.default_rng(4)
    batch = {"tokens": _t(rng.integers(1, cfg.vocab, (2, 32))),
             "labels": _t(rng.integers(1, cfg.vocab, (2, 32)))}
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        model.zero_grad(set_to_none=True)
        loss, m = TM.forward_train(model, batch, c)
        loss.backward()
        out.append((loss.item(), m["moe_aux"].item(),
                    {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert out[0][:2] == out[1][:2] and out[0][1] > 0
    for n, g in out[0][2].items():
        assert torch.equal(g, out[1][2][n]), n
    model.zero_grad(set_to_none=True)
