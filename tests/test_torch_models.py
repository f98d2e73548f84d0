"""The port's LM seed (configs, tokens, layers, SSM, model) held against the
reference, with the reference's weights carried across by
`params_from_reference`.

Tolerances: layers elementwise at rtol 1e-5 / atol 1e-6 in float32 (the
same formulas, sums in another order); the scoring loss within 1e-4 of
the reference's (tests/test_models.py:197's bound for the kernel paths);
prefill and decode logits at rtol 1e-4 / atol 1e-5, and caches at the
same, since two layers of float32 matmuls in another order separate them
by ~1e-6. The associative scan is reassociated (Hillis-Steele here, XLA's
tree there): rtol 1e-4 / atol 1e-6 on its states.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.data import TokenStream as TTokenStream
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import layers as TL, model as TM, ssm as TS
from repro_torch.models.config import Block

from torch_parity import reference_cache_layers, to_np, tree_to_numpy

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.tokens import TokenStream as RTokenStream  # noqa: E402
from repro.models import layers as RL, model as RM, ssm as RS  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ARCHS = ["stablelm-1.6b", "falcon-mamba-7b", "gemma-7b", "gemma2-27b",
         "gemma3-27b", "recurrentgemma-9b"]


@pytest.fixture(autouse=True)
def _no_grad():
    """The weights are trainable parameters: these tests compare forward
    values, so they run without an autograd graph, as scoring does (the
    training step's parity is tests/test_torch_train.py)."""
    with torch.no_grad():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


def _params(tree):
    """A reference dict of arrays as the port's `Params`."""
    return TL.Params(**{k: _params(v) if isinstance(v, dict) else _t(v)
                        for k, v in tree_to_numpy(tree).items()})


# ----------------------------------------------------------------------------
# configs and tokens
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_configs_equal_the_reference(arch):
    assert (dataclasses.asdict(tconfigs.get_config(arch))
            == dataclasses.asdict(rconfigs.get_config(arch)))
    assert (dataclasses.asdict(tconfigs.smoke_config(arch))
            == dataclasses.asdict(rconfigs.smoke_config(arch)))
    assert arch in tconfigs.ARCHS


def test_every_reference_name_resolves():
    """Every name the reference knows, whisper-large-v3 and paper-svm (a
    CoCoA+ workload, not a model) included, resolves to the reference's
    config; ARCHS leaves paper-svm out, as the reference's; an unknown
    name still raises KeyError."""
    assert set(tconfigs.ARCHS) == set(rconfigs.ARCHS)
    assert "paper-svm" not in tconfigs.ARCHS
    for arch in (*rconfigs.ARCHS, "paper-svm"):
        got, want = tconfigs.get_config(arch), rconfigs.get_config(arch)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        tconfigs.get_config("nope")


@pytest.mark.parametrize("kw", [dict(vocab=512, batch=2, seq=64),
                                dict(vocab=65024, batch=4, seq=33, seed=3,
                                     shard=1, shards=2)])
def test_token_stream_batches_equal_the_reference(kw):
    ref = RTokenStream(**kw, corpus_len=1 << 16)
    port = TTokenStream(**kw, corpus_len=1 << 16)
    for step in (0, 1, 7):
        want, got = ref.batch_at(step), port.batch_at(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
        tens = port.tensors_at(step, device="cpu")
        np.testing.assert_array_equal(tens["tokens"].numpy(), want["tokens"])


def test_token_stream_tensors_default_to_cuda():
    ts = TTokenStream(512, 2, 8, corpus_len=1 << 12)
    if torch.cuda.is_available():
        assert ts.tensors_at(0)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.tensors_at(0)


# ----------------------------------------------------------------------------
# layers, elementwise
# ----------------------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    g, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        TL.rmsnorm(_t(x), _t(g)).numpy(),
        np.asarray(RL.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TL.layernorm(_t(x), _t(g), _t(b)).numpy(),
        np.asarray(RL.layernorm(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b))), rtol=RTOL, atol=ATOL)


# M-RoPE sections of each rope_pct at head_dim 16: they sum to rot / 2
MROPE_SECTIONS = {1.0: (2, 3, 3), 0.25: (1, 1, 0), 0.5: (2, 1, 1)}


@pytest.mark.parametrize("pct", [1.0, 0.25, 0.5])
def test_rope_matches_reference(pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = (np.arange(9, dtype=np.int32)[None] + np.array([[0], [40]],
                                                         np.int32))
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), _t(pos), rope_pct=pct, base=10_000.0).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 rope_pct=pct, base=10_000.0)),
        rtol=1e-5, atol=2e-6)
    # M-RoPE: three streams that differ, so each section's stream shows
    streams = np.stack([pos, 2 * pos + 3, pos[:, ::-1]]).astype(np.int32)
    secs = MROPE_SECTIONS[pct]
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), _t(streams), rope_pct=pct, base=10_000.0,
                      mrope_sections=secs).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(streams),
                                 rope_pct=pct, base=10_000.0,
                                 mrope_sections=secs)),
        rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("H,KV,cap,chunk", [(4, 2, None, 8), (4, 1, 30.0, 16),
                                            (2, 2, None, 24)])
def test_chunked_and_decode_attention_match_reference(H, KV, cap, chunk):
    rng = np.random.default_rng(H * KV)
    B, S, hd = 2, 24, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    got = TL.chunked_attention(_t(q), _t(k), _t(v), _t(pos), softcap=cap,
                               q_chunk=chunk)
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                softcap=cap, q_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    q1 = q[:, :1]
    for p in (0, 10, S - 1):
        got = TL.decode_attention(_t(q1), _t(k), _t(v), p, softcap=cap)
        want = RL.decode_attention(jnp.asarray(q1), jnp.asarray(k),
                                   jnp.asarray(v), p, softcap=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_bidirectional_attention_matches_reference():
    """Bidirectional attention, which raised before the encoder-decoder
    was ported, against the reference (tests/test_torch_encdec.py holds
    the cross attention)."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(8, dtype=np.int32)[None]
    got = TL.chunked_attention(_t(q), _t(k), _t(v), _t(pos), causal=False,
                               q_chunk=3)
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                causal=False, q_chunk=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bias,qkn,pct", [(False, False, 0.25),
                                          (True, True, 1.0)])
def test_attn_qkv_matches_reference(bias, qkn, pct):
    cfg = dataclasses.replace(rconfigs.smoke_config("stablelm-1.6b"),
                              qkv_bias=bias, qk_norm=qkn, rope_pct=pct)
    p = RL.init_attn(jax.random.PRNGKey(2), cfg, jnp.float32)
    if bias:      # non-zero biases and norm gains, so they are exercised
        p = jax.tree.map(lambda a: a + 0.1, p)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want = RL.attn_qkv(p, jnp.asarray(x), cfg, jnp.asarray(pos), 10_000.0)
    got = TL.attn_qkv(_params(p), _t(x), cfg, _t(pos), 10_000.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["geglu", "swiglu", "gelu"])
def test_mlp_matches_reference(kind):
    p = RL.init_mlp(jax.random.PRNGKey(3), 32, 64, kind, jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 7, 32)).astype(
        np.float32)
    np.testing.assert_allclose(
        TL.mlp_forward(_params(p), _t(x), kind).numpy(),
        np.asarray(RL.mlp_forward(p, jnp.asarray(x), kind)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tied,cap,scale", [(False, None, False),
                                            (True, 30.0, True)])
def test_embed_and_logits_match_reference(tied, cap, scale):
    cfg = dataclasses.replace(rconfigs.smoke_config("stablelm-1.6b"),
                              tie_embeddings=tied, final_softcap=cap,
                              embed_scale=scale)
    p = RL.init_embed(jax.random.PRNGKey(4), cfg, jnp.float32)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 6))
    want_x = RL.embed_tokens(p, jnp.asarray(toks), cfg)
    got_x = TL.embed_tokens(_params(p), _t(toks), cfg)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=RTOL)
    np.testing.assert_allclose(
        TL.lm_logits(_params(p), got_x, cfg).numpy(),
        np.asarray(RL.lm_logits(p, want_x, cfg)), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------------
# the SSM block
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    cfg = rconfigs.smoke_config("falcon-mamba-7b")
    p = RS.init_ssm(jax.random.PRNGKey(5), cfg, jnp.float32)
    x = np.random.default_rng(5).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    return cfg, p, _params(p), x


def test_conv_and_ssm_params_match_reference(mamba):
    cfg, p, tp, _ = mamba
    rng = np.random.default_rng(6)
    xin = rng.standard_normal((2, 9, cfg.d_inner)).astype(np.float32)
    st = rng.standard_normal((2, cfg.conv_width - 1, cfg.d_inner)).astype(
        np.float32)
    for state in (None, st):
        want = RS._causal_conv(jnp.asarray(xin), p["conv_w"], p["conv_b"],
                               None if state is None else jnp.asarray(state))
        got = TS._causal_conv(_t(xin), tp.conv_w, tp.conv_b,
                              None if state is None else _t(state))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)
    for g, w in zip(TS._ssm_params(tp, _t(xin), cfg),
                    RS._ssm_params(p, jnp.asarray(xin), cfg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("C", [1, 5, 16])
def test_scan_chunk_matches_reference(C):
    rng = np.random.default_rng(C)
    a = rng.uniform(0.5, 1.0, (2, C, 8, 4)).astype(np.float32)
    b = rng.standard_normal((2, C, 8, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 8, 4)).astype(np.float32)
    got = TS._scan_chunk(_t(h0), _t(a), _t(b))
    want = RS._scan_chunk(jnp.asarray(h0), jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_ssm_forward_matches_reference(mamba, fused):
    cfg, p, tp, x = mamba
    cfg = dataclasses.replace(cfg, use_fused_ssm=fused)
    want, wst = RS.ssm_forward(p, jnp.asarray(x), cfg)
    got, gst = TS.ssm_forward(tp, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for key in ("h", "conv"):   # fused: h stays h0, as the reference's
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   rtol=1e-4, atol=1e-6)


def test_ssm_forward_with_state_updates_it_in_place(mamba):
    cfg, p, tp, x = mamba
    cfg = dataclasses.replace(cfg, use_fused_ssm=True)   # gated off: state
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)).astype(
        np.float32)
    conv = rng.standard_normal((2, cfg.conv_width - 1, cfg.d_inner)).astype(
        np.float32)
    want, wst = RS.ssm_forward(p, jnp.asarray(x[:, :1]), cfg,
                               {"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    state = {"h": _t(h.copy()), "conv": _t(conv.copy())}
    before = ss.LAUNCHES
    got, gst = TS.ssm_forward(tp, _t(x[:, :1]), cfg, state)
    assert gst is state and ss.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for key in ("h", "conv"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(wst[key]),
                                   rtol=1e-4, atol=1e-6)


def test_fused_ssm_needs_d_inner_multiple_of_128(mamba):
    cfg, p, tp, x = mamba
    cfg = dataclasses.replace(cfg, use_fused_ssm=True, d_inner=96)
    xin = torch.zeros(1, 4, cfg.d_model)
    small = TS.init_ssm(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(ValueError, match="d_inner % 128"):
        TS.ssm_forward(small, xin, cfg)


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    cfg = rconfigs.smoke_config(request.param)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    model = TM.params_from_reference(tree_to_numpy(params), cfg,
                                     device="cpu")
    return cfg, params, model


def test_params_from_reference_carries_every_leaf(lm):
    cfg, params, model = lm
    n_leaves = len(jax.tree.leaves(params))
    n_full, rem = RM._split_layers(cfg)
    per_period = len(jax.tree.leaves(params["scan"]))
    assert (len(model.state_dict())
            == n_leaves - per_period + per_period * n_full)
    np.testing.assert_array_equal(
        model.blocks[1].norm1.g.numpy(),
        np.asarray(params["scan"][0]["norm1"]["g"][1]))
    assert TM.count_params(cfg) == RM.count_params(cfg)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_count_params_full_size(arch):
    cfg = tconfigs.get_config(arch)
    assert TM.count_params(cfg) == RM.count_params(cfg)
    assert (TM.count_params(cfg, active_only=True)
            == RM.count_params(cfg, active_only=True))
    assert cfg.param_count() == TM.count_params(cfg)


@pytest.mark.parametrize("flag", [False, True])
def test_forward_train_loss_matches_reference(lm, flag):
    cfg, params, model = lm
    cfg = dataclasses.replace(cfg, use_flash_attention=flag,
                              use_fused_ssm=flag)
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab, (2, 64))
    labels = rng.integers(1, cfg.vocab, (2, 64))
    want, _ = RM.forward_train(params, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)}, cfg)
    got, metrics = TM.forward_train(model, {"tokens": _t(toks),
                                            "labels": _t(labels)}, cfg)
    assert abs(float(got) - float(want)) < 1e-4
    assert float(metrics["moe_aux"]) == 0.0


def test_forward_train_loss_mask_matches_reference(lm):
    cfg, params, model = lm
    rng = np.random.default_rng(9)
    toks = rng.integers(1, cfg.vocab, (2, 48))
    mask = (rng.random((2, 48)) < 0.6).astype(np.float32)
    want, _ = RM.forward_train(params, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(toks),
                                        "loss_mask": jnp.asarray(mask)}, cfg)
    got, _ = TM.forward_train(model, {"tokens": _t(toks),
                                      "labels": _t(toks),
                                      "loss_mask": _t(mask)})
    assert abs(float(got) - float(want)) < 1e-4


@pytest.mark.parametrize("flag", [False, True])
def test_prefill_and_decode_match_reference(lm, flag):
    cfg, params, model = lm
    cfg = dataclasses.replace(cfg, use_flash_attention=flag,
                              use_fused_ssm=flag)
    B, P, S_max = 2, 20, 32
    rng = np.random.default_rng(10)
    toks = rng.integers(1, cfg.vocab, (B, P))
    rcache = RM.init_cache(cfg, B, S_max)
    want, rcache = RM.prefill(params, {"tokens": jnp.asarray(toks)}, cfg,
                              rcache)
    tcache = TM.init_cache(cfg, B, S_max, device="cpu")
    got, tcache = TM.prefill(model, {"tokens": _t(toks)}, tcache, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for step in range(4):
        pos = P + step
        want, rcache = RM.decode_step(params, rcache, jnp.asarray(nxt), pos,
                                      cfg)
        got, tcache = TM.decode_step(model, tcache, _t(nxt), pos, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
        nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for g, w in zip(tcache, reference_cache_layers(rcache, cfg)):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_allclose(to_np(g[key]), w[key], rtol=1e-4,
                                       atol=1e-5)


# an encoder-decoder config builds the whisper structure whatever else it
# asks for: the reference's init_params_encdec ignores the pattern (MoE),
# M-RoPE and the input mode, and so does the port
ENCDEC = dict(enc_layers=2, dec_layers=2)


@pytest.mark.parametrize("change", [
    dict(ENCDEC, pattern=(Block(mlp="moe"),), n_experts=4),
    dict(ENCDEC, mrope_sections=(2, 3, 3)),
    ENCDEC,
    dict(ENCDEC, input_mode="embeddings"),
])
def test_encdec_configs_build_and_score_as_reference(change):
    """Such a config, which raised before the encoder-decoder was ported,
    builds, caches and scores as the reference's does."""
    cfg = dataclasses.replace(rconfigs.smoke_config("stablelm-1.6b"),
                              **change)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    model = TM.params_from_reference(tree_to_numpy(params), cfg,
                                     device="cpu")
    assert isinstance(model, TM.EncoderDecoder)
    assert TM.count_params(cfg) == RM.count_params(cfg)
    want_cache = RM.init_cache(cfg, 2, 16)
    got_cache = TM.init_cache(cfg, 2, 16, device="cpu")
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert (tuple(got_cache[part][key].shape)
                    == want_cache[part][key].shape)
    rng = np.random.default_rng(14)
    frames = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab, (2, 9))
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, _ = jax.jit(lambda p, b: RM.forward_train(p, b, cfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, metrics = TM.forward_train(model, {k: _t(v)
                                            for k, v in batch.items()}, cfg)
    assert abs(float(got) - float(want)) < 1e-4
    assert float(metrics["moe_aux"]) == 0.0


def test_model_defaults_to_cuda():
    cfg = tconfigs.smoke_config("stablelm-1.6b")
    if torch.cuda.is_available():
        assert TM.init_params(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_cache(cfg, 1, 8)
