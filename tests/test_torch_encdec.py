"""The port's encoder-decoder (whisper-large-v3's structure) held against
the reference on the same numpy inputs, the reference's weights carried
across by `params_from_reference`: bidirectional and cross attention,
`encode`, `prefill_encdec`, `decode_step_encdec`, `forward_train_encdec`
(loss and grads), remat, one `train_step`, `launch.serve`; and the
decoder's context, where the port raises and the reference clamps.

Tolerances: attention elementwise at rtol 1e-5 / atol 1e-6 in float32
(the same formulas, sums in another order); the encoder, cross K/V,
decode logits and caches at rtol 1e-4 / atol 1e-5 (two layers of float32
matmuls in another order); the loss within 1e-4 (tests/test_models.py's
bound); grads within 1e-4 of each leaf's largest |grad|.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_runtime import ServingEngine
from repro_torch.launch.train import init_opt, train_step
from repro_torch.models import layers as TL, model as TM
from repro_torch.optim.localdp import decoder_loss_fn

import torch_parity as tp

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.launch.train import train_step as ref_train_step  # noqa: E402
from repro.models import layers as RL, model as RM  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ARCH = "whisper-large-v3"
B, T, SD = 2, 40, 12          # streams, frames, decoder tokens


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(tp.to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def whisper():
    """The smoke config (2 + 2 layers, 4 heads over 2 KV heads: GQA), the
    reference's weights and the port's model holding them."""
    cfg = ref_smoke_config(ARCH)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    model = TM.params_from_reference(tp.tree_to_numpy(params), cfg,
                                     device="cpu")
    return cfg, params, model


def _frames(cfg, n=T, seed=1):
    return (np.random.default_rng(seed).standard_normal((B, n, cfg.d_model))
            .astype(np.float32))


def _batch(cfg, seed=2, frames=T, sd=SD):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, sd + 1))
    return {"frames": _frames(cfg, frames, seed),
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _port(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,H,KV,chunk", [(24, 24, 4, 2, 8),
                                              (24, 40, 4, 2, 7),
                                              (10, 33, 4, 1, 16),
                                              (9, 5, 2, 2, 4)])
def test_bidirectional_and_cross_attention_match_reference(Sq, Sk, H, KV,
                                                           chunk):
    """`causal=False` over keys of another length (cross attention), at
    chunks that do and do not divide Sq, GQA and MQA; with a softcap
    too."""
    rng = np.random.default_rng(Sq * Sk + KV)
    hd = 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq))
    for kw in (dict(), dict(softcap=20.0)):
        got = TL.chunked_attention(_t(q), _t(k), _t(v), _t(pos),
                                   causal=False, q_chunk=chunk, **kw)
        want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos),
                                    causal=False, q_chunk=chunk, **kw)
        _close(got, want, RTOL, ATOL, str(kw))


@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4)])
def test_decode_attention_over_all_frames_matches_reference(H, KV):
    """The one-token cross attention, `decode_attention` at pos = T - 1
    over all T frames (GQA as the smoke config, MHA as the full one), and
    over a cache's first slots."""
    rng = np.random.default_rng(4 + KV)
    q = rng.standard_normal((B, 1, H, 16)).astype(np.float32)
    k, v = (rng.standard_normal((B, 20, KV, 16)).astype(np.float32)
            for _ in range(2))
    for pos in (0, 9, 19):
        got = TL.decode_attention(_t(q), _t(k), _t(v), pos)
        want = RL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), pos)
        _close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("bias,qkn", [(False, False), (True, True)])
def test_attn_qkv_cross_kv_matches_reference(bias, qkn):
    """k and v from `cross_kv` with its own length, and no RoPE."""
    cfg = dataclasses.replace(ref_smoke_config("stablelm-1.6b"),
                              qkv_bias=bias, qk_norm=qkn)
    p = RL.init_attn(jax.random.PRNGKey(5), cfg, jnp.float32)
    if bias:      # non-zero biases and norm gains, so they are exercised
        p = jax.tree.map(lambda a: a + 0.1, p)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 19, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (B, 7))
    params = TL.Params(**{
        k: (TL.Params(**{n: _t(a) for n, a in v.items()})
            if isinstance(v, dict) else _t(v))
        for k, v in tp.tree_to_numpy(p).items()})
    want = RL.attn_qkv(p, jnp.asarray(x), cfg, jnp.asarray(pos), 10_000.0,
                       cross_kv=jnp.asarray(src))
    got = TL.attn_qkv(params, _t(x), cfg, _t(pos), 10_000.0,
                      cross_kv=_t(src))
    assert got[1].shape == (B, 19, cfg.n_kv, cfg.head_dim)
    for g, w in zip(got, want):
        _close(g, w, RTOL, 1e-5)


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

def test_params_from_reference_carries_every_leaf(whisper):
    cfg, params, model = whisper
    state = model.state_dict()
    n_layer_leaves = (len(jax.tree.leaves(params["enc"]))
                      + len(jax.tree.leaves(params["dec"])))
    assert len(state) == (len(jax.tree.leaves(params)) - n_layer_leaves
                          + n_layer_leaves * cfg.enc_layers)
    np.testing.assert_array_equal(
        model.dec[1].cross_attn.wk.detach().numpy(),
        np.asarray(params["dec"]["cross_attn"]["wk"][1]))
    assert TM.count_params(cfg) == RM.count_params(cfg)


def test_count_params_at_full_size():
    cfg = get_config(ARCH)
    assert TM.count_params(cfg) == 1_535_383_040 == RM.count_params(cfg)


def test_encode_matches_reference(whisper):
    cfg, params, model = whisper
    fr = _frames(cfg)
    with torch.no_grad():
        got = TM.encode(model, _t(fr), cfg)
    _close(got, RM.encode(params, jnp.asarray(fr), cfg))


@pytest.mark.parametrize("frames", [T, 27])
def test_prefill_encdec_cross_kv_matches_reference(whisper, frames):
    """The cross K/V of the frames given replace the cache's, also at a
    frame count other than the one `init_cache` was made for; the self
    cache is kept."""
    cfg, params, model = whisper
    fr = _frames(cfg, frames)
    want = RM.prefill_encdec(params, {"frames": jnp.asarray(fr)}, cfg,
                             RM.init_cache(cfg, B, T))
    cache = TM.init_cache(cfg, B, T, device="cpu")
    self_k = cache["self"]["k"]
    got = TM.prefill_encdec(model, {"frames": _t(fr)}, cache, cfg)
    assert got is cache and got["self"]["k"] is self_k
    for key in ("k", "v"):
        assert got["cross"][key].shape == (cfg.dec_layers, B, frames,
                                           cfg.n_kv, cfg.head_dim)
        _close(got["cross"][key], want["cross"][key])


def test_serve_prefill_step_gives_zero_logits(whisper):
    cfg, params, model = whisper
    fr = _frames(cfg)
    cache = TM.init_cache(cfg, B, T, device="cpu")
    logits, cache = tserve.prefill_step(model, {"frames": _t(fr)}, cache)
    want, rcache = rserve.prefill_step(params, {"frames": jnp.asarray(fr)},
                                       RM.init_cache(cfg, B, T), cfg=cfg)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, 1, cfg.vocab) and not logits.any()
    assert want.shape == logits.shape and not np.asarray(want).any()
    _close(cache["cross"]["v"], rcache["cross"]["v"])


def test_decode_steps_match_reference(whisper):
    """Prefill, then 6 decode steps (greedy on the reference's logits):
    logits, self and cross caches."""
    cfg, params, model = whisper
    fr = _frames(cfg)
    rcache = RM.prefill_encdec(params, {"frames": jnp.asarray(fr)}, cfg,
                               RM.init_cache(cfg, B, T))
    tcache = TM.prefill_encdec(model, {"frames": _t(fr)},
                               TM.init_cache(cfg, B, T, device="cpu"), cfg)
    step = jax.jit(lambda p, c, t, i: RM.decode_step(p, c, t, i, cfg))
    nxt = np.full((B, 1), 3, np.int32)
    for pos in range(6):
        want, rcache = step(params, rcache, jnp.asarray(nxt), pos)
        got, tcache = TM.decode_step(model, tcache, _t(nxt), pos, cfg)
        assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab)
        _close(got, want, msg=f"pos {pos}")
        nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for part in ("self", "cross"):
        for key in ("k", "v"):
            _close(tcache[part][key], rcache[part][key], msg=part + key)


def test_serve_step_matches_greedy_decode(whisper):
    cfg, _, model = whisper
    cache = TM.init_cache(cfg, B, T, device="cpu")
    _, cache = tserve.prefill_step(model, {"frames": _t(_frames(cfg))},
                                   cache)
    ref = {p: {k: v.clone() for k, v in c.items()} for p, c in cache.items()}
    tok = torch.full((B, 1), 3, dtype=torch.int32)
    nxt, cache = tserve.serve_step(model, cache, tok, 0)
    logits, _ = TM.decode_step_encdec(model, ref, tok, 0)
    assert torch.equal(nxt[:, 0], torch.argmax(logits[:, -1], -1).int())
    assert torch.equal(cache["self"]["k"], ref["self"]["k"])


def test_decode_equals_the_teacher_forced_logits(whisper):
    """`logits_encdec` (no cache) over a token sequence equals prefill
    then one decode step a token, position by position."""
    cfg, _, model = whisper
    batch = _port(_batch(cfg, seed=6))
    with torch.no_grad():
        full = TM.logits_encdec(model, batch, cfg)
    cache = TM.prefill_encdec(model, {"frames": batch["frames"]},
                              TM.init_cache(cfg, B, T, device="cpu"))
    for pos in range(SD):
        step, cache = TM.decode_step(model, cache,
                                     batch["tokens"][:, pos:pos + 1], pos)
        _close(step[:, 0], full[:, pos].numpy(), msg=f"pos {pos}")


def test_decode_past_the_context_raises(whisper):
    cfg, _, model = whisper
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    tok = torch.ones((1, 1), dtype=torch.int32)
    TM.decode_step_encdec(model, cache, tok, TM.MAX_WHISPER_DEC - 1)
    for pos in (TM.MAX_WHISPER_DEC, TM.MAX_WHISPER_DEC + 5, -1):
        with pytest.raises(ValueError, match="context"):
            TM.decode_step(model, cache, tok, pos)
    fr = torch.zeros((1, 8, cfg.d_model))
    toks = torch.ones((1, TM.MAX_WHISPER_DEC + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="context"):
        TM.forward_train(model, {"frames": fr, "tokens": toks,
                                 "labels": toks})


def test_reference_clamps_decode_past_the_context():
    """ROADMAP.md Queue 3: the reference's `decode_step_encdec` at pos =
    448 runs, reads pos_dec[447] and overwrites self-cache slot 447
    (`dynamic_slice` clamps the start), which the port refuses
    (test_decode_past_the_context_raises)."""
    cfg = ref_smoke_config(ARCH)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    cache = RM.prefill_encdec(params, {"frames": jnp.asarray(
        _frames(cfg, 8)[:1])}, cfg, RM.init_cache(cfg, 1, 8))
    step = jax.jit(lambda p, c, t, i: RM.decode_step_encdec(p, c, t, i,
                                                            cfg))
    last = RM.MAX_WHISPER_DEC - 1
    _, at_447 = step(params, cache, jnp.full((1, 1), 5, jnp.int32), last)
    b = jnp.full((1, 1), 9, jnp.int32)
    lg_448, past = step(params, at_447, b, last + 1)
    lg_447, redo = step(params, at_447, b, last)
    np.testing.assert_array_equal(np.asarray(past["self"]["k"]),
                                  np.asarray(redo["self"]["k"]))
    np.testing.assert_array_equal(np.asarray(lg_448), np.asarray(lg_447))
    assert not np.array_equal(np.asarray(past["self"]["k"][:, :, last]),
                              np.asarray(at_447["self"]["k"][:, :, last]))


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

def _loss_and_grads(model, batch, cfg):
    model.zero_grad(set_to_none=True)
    loss, metrics = TM.forward_train(model, batch, cfg)
    loss.backward()
    return loss.detach(), metrics, {n: p.grad.clone()
                                    for n, p in model.named_parameters()}


def test_forward_train_loss_and_grads_match_reference(whisper):
    """The loss within 1e-4 (with and without a loss mask), and every
    leaf's grad within 1e-4 of that leaf's largest |grad| of
    `jax.grad`."""
    cfg, params, model = whisper
    batch = _batch(cfg)
    batch["loss_mask"] = (np.random.default_rng(7).random((B, SD)) < 0.7
                          ).astype(np.float32)
    want, _ = jax.jit(lambda p, b: RM.forward_train(p, b, cfg))(
        params, _jax(batch))
    with torch.no_grad():
        got, met = TM.forward_train(model, _port(batch), cfg)
    assert abs(float(got) - float(want)) < 1e-4
    assert float(met["xent"]) == float(got) and float(met["moe_aux"]) == 0
    del batch["loss_mask"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RM.forward_train(p, _jax(batch), cfg)[0]))(params)
    model = TM.params_from_reference(tp.tree_to_numpy(params), cfg,
                                     device="cpu")
    got_loss, _, got = _loss_and_grads(model, _port(batch), cfg)
    assert abs(float(got_loss) - float(loss)) < 1e-4
    want_g = TM.reference_state(tp.tree_to_numpy(grads), cfg)
    assert got.keys() == want_g.keys()
    for n, g in got.items():
        scale = float(np.abs(want_g[n]).max())
        np.testing.assert_allclose(g.numpy(), want_g[n], rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


def test_remat_grads_equal_no_remat(whisper):
    """`cfg.remat` checkpoints each encoder and decoder layer: the loss
    and every grad bit for bit the same."""
    cfg, _, model = whisper
    batch = _port(_batch(cfg, seed=8))
    loss0, _, g0 = _loss_and_grads(model, batch,
                                   dataclasses.replace(cfg, remat=False))
    loss1, _, g1 = _loss_and_grads(model, batch,
                                   dataclasses.replace(cfg, remat=True))
    assert torch.equal(loss0, loss1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_recomputes_with_the_weights_functional_call_gave(whisper):
    """Under remat, `decoder_loss_fn` (CoCoA-DP's loss, through
    `functional_call`) differentiates in the weights it was handed."""
    cfg, _, model = whisper
    model = TM.params_from_reference(
        tp.tree_to_numpy(RM.init_params(jax.random.PRNGKey(1), cfg)),
        dataclasses.replace(cfg, remat=True), device="cpu")
    batch = _port(_batch(cfg, seed=9))
    theta = {n: (p.detach() * 1.5).requires_grad_()
             for n, p in model.named_parameters()}
    loss = decoder_loss_fn(model)(theta, batch)
    grads = torch.autograd.grad(loss, list(theta.values()))
    plain = TM.init_params(cfg, device="cpu")
    with torch.no_grad():
        for n, p in plain.named_parameters():
            p.copy_(theta[n])
    _, _, want = _loss_and_grads(plain, batch, cfg)
    for (n, _), g in zip(theta.items(), grads):
        torch.testing.assert_close(g, want[n], rtol=1e-5, atol=1e-7,
                                   msg=n)


@pytest.fixture(scope="module", params=[3e-4, 1e-4])
def reference_steps(request, whisper):
    """The reference's loss, grad_norm and params after each of 3
    `train_step`s (AdamW) on one repeated batch, at the rate given."""
    cfg, params, _ = whisper
    lr = request.param
    batch = _batch(cfg, seed=10)
    step = jax.jit(lambda p, o, b: ref_train_step(p, o, b, cfg=cfg, lr=lr))
    p, o, after = params, ref_adamw_init(params), []
    for _ in range(3):
        p, o, m = step(p, o, _jax(batch))
        after.append((TM.reference_state(tp.tree_to_numpy(p), cfg),
                      float(m["loss"]), float(m["grad_norm"])))
    return lr, batch, after


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_reference(whisper, reference_steps, steps):
    """1 and 3 `train_step`s at lr 3e-4 and 1e-4: each step's loss and
    grad_norm, and every parameter after the last, against the
    reference's."""
    cfg, params, _ = whisper
    lr, batch, after = reference_steps
    model = TM.params_from_reference(tp.tree_to_numpy(params), cfg,
                                     device="cpu")
    opt = init_opt(model)
    for t in range(steps):
        model, opt, got = train_step(model, opt, _port(batch), cfg=cfg,
                                     lr=lr)
        _, loss, gnorm = after[t]
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5,
                                   err_msg=f"step {t + 1}")
        np.testing.assert_allclose(float(got["grad_norm"]), gnorm,
                                   rtol=1e-4, err_msg=f"step {t + 1}")
    want = after[steps - 1][0]
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=1e-5, err_msg=n)
    assert int(opt.step) == steps


def test_serving_records_no_graph_and_the_engine_refuses(whisper):
    cfg, _, model = whisper
    assert all(p.requires_grad for p in model.parameters())
    cache = TM.init_cache(cfg, B, T, device="cpu")
    logits, cache = tserve.prefill_step(model, {"frames": _t(_frames(cfg))},
                                        cache)
    nxt, cache = tserve.serve_step(model, cache,
                                   torch.ones((B, 1), dtype=torch.int32), 0)
    assert not nxt.requires_grad
    for part in cache.values():
        assert all(not c.requires_grad for c in part.values())
    with pytest.raises(NotImplementedError, match="launch.serve"):
        ServingEngine(cfg, model, device="cpu")


def test_model_defaults_to_cuda():
    cfg = smoke_config(ARCH)
    if torch.cuda.is_available():
        assert TM.init_params(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_cache(cfg, 1, 8)
