"""The port's sliding-window attention, ring-buffer caches and RG-LRU
block held against the reference, layer by layer, through the model on a
ring that wraps, and through the serving engine.

Tolerances: layers elementwise at rtol 1e-5 / atol 1e-6 in float32 (the
same formulas, sums in another order; the RG-LRU's associative scan is
reassociated, Hillis-Steele here and XLA's tree there, so its outputs and
states at rtol 1e-5 / atol 1e-6 as well, which they meet); the model's
prefill and decode logits and its caches at rtol 1e-4 / atol 1e-5 (layers
of float32 matmuls in another order, as tests/test_torch_models.py);
the engines' tokens exactly (greedy argmax over logits that agree to
~1e-6). Torch runs single-threaded.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_runtime import ServingEngine as TEngine
from repro_torch.models import layers as TL, model as TM, rglru as TR

from torch_parity import reference_cache_layers, to_np, tree_to_numpy

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config  # noqa: E402
from repro.launch.serving_runtime import ServingEngine as REngine  # noqa
from repro.models import layers as RL, model as RM, rglru as RR  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
WINDOWED = ("gemma2-27b", "gemma3-27b", "recurrentgemma-9b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


def _qkv(seed, B, S, H, KV, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------------

S_ATT = 40
# (H, KV, softcap, q_chunk): GQA with chunks of 10 (pick_chunk(40, 12),
# dividing no window below), MQA with softcap 50 and chunks of 8
ATTN_KINDS = [(4, 2, None, 12), (4, 1, 50.0, 8)]


@pytest.mark.parametrize("window", [1, 5, 16, S_ATT - 1, S_ATT + 7])
@pytest.mark.parametrize("H,KV,cap,chunk", ATTN_KINDS)
def test_windowed_chunked_attention_matches_reference(window, H, KV, cap,
                                                      chunk):
    q, k, v = _qkv(window * H + KV, 2, S_ATT, H, KV)
    # row 1's positions start at 100: the mask reads positions, not indices
    pos = (np.arange(S_ATT, dtype=np.int32)[None]
           + np.array([[0], [100]], np.int32))
    got = TL.chunked_attention(_t(q), _t(k), _t(v), _t(pos), window=window,
                               softcap=cap, q_chunk=chunk)
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                window=window, softcap=cap, q_chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("H,KV,cap,chunk", ATTN_KINDS)
def test_windowed_decode_attention_matches_reference(H, KV, cap, chunk):
    W = 16
    q, k, v = _qkv(H + KV, 2, S_ATT, H, KV)
    q1 = q[:, :1]
    for pos in (0, W - 1, 27, S_ATT - 1):
        for window in (W, S_ATT + 7):        # S + 7: the global branch
            got = TL.decode_attention(_t(q1), _t(k), _t(v), pos,
                                      window=window, softcap=cap)
            want = RL.decode_attention(jnp.asarray(q1), jnp.asarray(k),
                                       jnp.asarray(v), pos, window=window,
                                       softcap=cap)
            _close(got, want)


@pytest.mark.parametrize("H,KV,cap,chunk", ATTN_KINDS)
def test_decode_attention_ring_matches_reference(H, KV, cap, chunk):
    W = 12
    q, k, v = _qkv(H * KV + 7, 2, W, H, KV)
    q1 = q[:, :1]
    for pos in (3, W - 1, W, 3 * W + 5):     # 3: slots 4..11 unwritten
        got = TL.decode_attention_ring(_t(q1), _t(k), _t(v), pos, window=W,
                                       softcap=cap)
        want = RL.decode_attention_ring(jnp.asarray(q1), jnp.asarray(k),
                                        jnp.asarray(v), pos, window=W,
                                        softcap=cap)
        _close(got, want)


def test_ring_slots_past_the_position_are_never_read():
    """At pos < W the slots above pos hold nothing yet: garbage there
    changes nothing."""
    W, pos = 12, 5
    q, k, v = _qkv(3, 1, W, 4, 2)
    got = TL.decode_attention_ring(_t(q[:, :1]), _t(k), _t(v), pos, window=W)
    k[:, pos + 1:] = 1e3
    v[:, pos + 1:] = -1e3
    again = TL.decode_attention_ring(_t(q[:, :1]), _t(k), _t(v), pos,
                                     window=W)
    assert torch.equal(got, again)


# ----------------------------------------------------------------------------
# RG-LRU
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lru():
    cfg = smoke_config("recurrentgemma-9b")
    p = RR.init_rglru(jax.random.PRNGKey(5), cfg, jnp.float32)
    x = np.random.default_rng(5).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    tp = TL.Params(**{k: _t(v) for k, v in tree_to_numpy(p).items()})
    return cfg, p, tp, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rglru_shapes_and_types(dtype):
    cfg = smoke_config("recurrentgemma-9b")
    want = RR.init_rglru(jax.random.PRNGKey(0), cfg, jnp.dtype(dtype))
    got = TR.init_rglru(torch.Generator().manual_seed(0), cfg,
                        getattr(torch, dtype))
    assert set(dict(got.named_parameters())) == set(want)
    for name, w in want.items():
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[1] == str(w.dtype), name
    lam = getattr(got, "lambda")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())


@pytest.mark.parametrize("seq_chunk", [8, 32])
def test_rglru_forward_matches_reference(lru, seq_chunk):
    cfg, p, tp, x = lru
    cfg = dataclasses.replace(cfg, seq_chunk=seq_chunk)
    want, wst = RR.rglru_forward(p, jnp.asarray(x), cfg)
    got, gst = TR.rglru_forward(tp, _t(x), cfg)
    _close(got, want)
    for key in ("h", "conv"):
        _close(gst[key], wst[key])


def test_rglru_seq_chunks_agree(lru):
    cfg, _, tp, x = lru
    outs = [TR.rglru_forward(tp, _t(x), dataclasses.replace(
        cfg, seq_chunk=c))[0] for c in (8, 32)]
    _close(outs[0], outs[1])


@pytest.mark.parametrize("S", [1, 9])
def test_rglru_with_state_updates_it_in_place(lru, S):
    cfg, p, tp, x = lru
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.conv_width - 1, cfg.lru_width)).astype(
        np.float32)
    want, wst = RR.rglru_forward(p, jnp.asarray(x[:, :S]), cfg,
                                 {"h": jnp.asarray(h),
                                  "conv": jnp.asarray(conv)})
    state = {"h": _t(h), "conv": _t(conv)}
    tensors = dict(state)
    got, gst = TR.rglru_forward(tp, _t(x[:, :S]), cfg, state)
    assert gst is state
    assert all(state[k] is tensors[k] for k in state)
    _close(got, want)
    for key in ("h", "conv"):
        _close(state[key], wst[key])


# ----------------------------------------------------------------------------
# the model on a ring that wraps
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_steps(cfg):
    """The reference's prefill and decode_step, jitted for `cfg` (pos
    traced): one compile a config instead of op-by-op dispatch."""
    return (jax.jit(functools.partial(RM.prefill, cfg=cfg)),
            jax.jit(functools.partial(RM.decode_step, cfg=cfg)))


def _weights(arch, **change):
    cfg = dataclasses.replace(smoke_config(arch), **change)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, TM.params_from_reference(tree_to_numpy(params), cfg,
                                                 device="cpu")


@pytest.mark.parametrize("arch", WINDOWED)
def test_decode_past_two_windows_on_a_ring_matches_reference(arch):
    """P 40, S_max 64: every windowed cache is a ring of 32 slots, the
    prefill rolls its last 32 tokens in, and decode runs to position 70,
    past 2W."""
    cfg, params, model = _weights(arch)
    B, P, S_max, last = 2, 40, 64, 70
    rng = np.random.default_rng(11)
    toks = rng.integers(1, cfg.vocab, (B, P))
    rcache = RM.init_cache(cfg, B, S_max)
    tcache = TM.init_cache(cfg, B, S_max, device="cpu")
    windows = {spec.window for spec in cfg.pattern} - {None}
    assert windows == {32} and any(
        c["k"].shape[1] == 32 for c in tcache if "k" in c)
    prefill, decode = _ref_steps(cfg)
    want, rcache = prefill(params, {"tokens": jnp.asarray(toks)},
                           cache=rcache)
    got, tcache = TM.prefill(model, {"tokens": _t(toks)}, tcache, cfg)
    _close(got, want, 1e-4, 1e-5)
    nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for pos in range(P, last + 1):
        want, rcache = decode(params, rcache, jnp.asarray(nxt),
                              jnp.int32(pos))
        got, tcache = TM.decode_step(model, tcache, _t(nxt), pos, cfg)
        _close(got, want, 1e-4, 1e-5)
        nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for g, w in zip(tcache, reference_cache_layers(rcache, cfg)):
        assert g.keys() == w.keys()
        for key in g:
            _close(g[key], w[key], 1e-4, 1e-5)


@pytest.mark.parametrize("arch", WINDOWED)
def test_windowed_flash_gate_takes_the_plain_path(arch, monkeypatch):
    """Under use_flash_attention only the global layers reach the kernel
    wrapper; the windowed ones take chunked_attention."""
    cfg, _, model = _weights(arch, use_flash_attention=True)
    calls = []
    real = TM.flash_attention
    monkeypatch.setattr(TM, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    toks = _t(np.random.default_rng(3).integers(1, cfg.vocab, (1, 48)))
    TM.prefill(model, {"tokens": toks}, TM.init_cache(cfg, 1, 64, "cpu"))
    n_global = sum(1 for b in cfg.blocks()
                   if b.mixer == "attn" and b.window is None)
    assert len(calls) == n_global


@pytest.mark.parametrize("arch", WINDOWED)
def test_serve_steps_run_the_windowed_archs(arch):
    """`launch.serve`'s prefill and greedy step, unchanged, on the new
    archs: the reference's logits and next tokens (the reference's
    `serve_step` is the argmax of its `decode_step`, jitted here)."""
    cfg, params, model = _weights(arch)
    prefill, decode = _ref_steps(cfg)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 40))
    rlog, rcache = prefill(params, {"tokens": jnp.asarray(toks)},
                           cache=RM.init_cache(cfg, 2, 64))
    tcache = TM.init_cache(cfg, 2, 64, device="cpu")
    tlog, tcache = tserve.prefill_step(model, {"tokens": _t(toks)}, tcache)
    _close(tlog, rlog, 1e-4, 1e-5)
    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]
    for pos in (40, 41):
        rlog, rcache = decode(params, rcache, jnp.asarray(nxt, jnp.int32),
                              jnp.int32(pos))
        tn, tcache = tserve.serve_step(model, tcache, _t(nxt), pos)
        assert tn.dtype == torch.int32
        nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]
        np.testing.assert_array_equal(tn.numpy(), nxt)


# ----------------------------------------------------------------------------
# the serving engine
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-27b"])
@pytest.mark.parametrize("s_max,lens", [
    (24, (5, 19, 7)),              # dense caches: min(24, 32) slots
    (96, (40, 9, 50)),             # rings of 32 slots; prompts past W
])
def test_engine_gives_the_reference_tokens_on_windowed_archs(arch, s_max,
                                                            lens):
    cfg, params, model = _weights(arch)
    ref = REngine(cfg, params, slots=2, s_max=s_max)
    port = TEngine(cfg, model, slots=2, s_max=s_max, device="cpu")
    ring = s_max > 32
    assert any(c["k"].shape[1] == (32 if ring else s_max)
               for c in port.cache if "k" in c)
    rng = np.random.default_rng(s_max)
    prompts = [rng.integers(1, 500, (p,)).astype(np.int32) for p in lens]
    rreqs = [ref.submit(p, max_new=6) for p in prompts]
    treqs = [port.submit(p, max_new=6) for p in prompts]
    live = []
    for _ in range(200):
        a, b = ref.step(), port.step()
        live.append((a, b))
        if a == 0 and not ref.queue:
            break
    assert all(a == b for a, b in live), live
    for r, t in zip(rreqs, treqs):
        assert t.done and r.done
        assert t.out == r.out, (t.out, r.out)


def _one_row_greedy(params, cfg, prompt, n, s_max):
    """The reference model's greedy tokens for one prompt, one row."""
    prefill, decode = _ref_steps(cfg)
    cache = RM.init_cache(cfg, 1, s_max)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompt[None])},
                            cache=cache)
    out = [int(jnp.argmax(logits[0, -1]))]
    for step in range(n - 1):
        logits, cache = decode(params, cache,
                               jnp.asarray([[out[-1]]], jnp.int32),
                               jnp.int32(len(prompt) + step))
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


@pytest.mark.parametrize("slots,lens", [(1, (40, 9, 50)),
                                        (2, (37, 37, 37, 37))])
def test_engine_serves_recurrentgemma_as_one_row_loops(slots, lens):
    """The reference engine cannot serve RG-LRU caches
    (tests/test_torch_serving.py); the port's gives each request the
    tokens of a one-row greedy loop on the reference model. Two slots
    with prompts of one length decode at each slot's own position."""
    cfg, params, model = _weights("recurrentgemma-9b")
    s_max = 96
    port = TEngine(cfg, model, slots=slots, s_max=s_max, device="cpu")
    rng = np.random.default_rng(slots)
    prompts = [rng.integers(1, 500, (p,)).astype(np.int32) for p in lens]
    reqs = [port.submit(p, max_new=6) for p in prompts]
    port.run_until_drained()
    for p, r in zip(prompts, reqs):
        assert r.done and r.out == _one_row_greedy(params, cfg, p, 6, s_max)
