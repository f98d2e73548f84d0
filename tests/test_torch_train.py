"""The port's LM training step (`repro_torch.launch.train`) and CoCoA-DP on
the decoder, against `tests/test_system.py::test_lm_trainer_learns` and
the reference's `train_step` / `make_round_fn` on the same weights
(`params_from_reference`) and numpy batches; remat, the kernels' refusal
of a gradient, and serving without an autograd graph."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.launch.train import train_step as ref_train_step
from repro.models import model as RM
from repro.optim import localdp as ref_localdp
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import smoke_config
from repro_torch.data import TokenStream
from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serving_runtime import ServingEngine
from repro_torch.launch.train import init_opt, run_training, train_step
from repro_torch.models import model as TM
from repro_torch.optim.localdp import (LocalDPConfig, decoder_loss_fn,
                                       init_state, make_round_fn)

import torch_parity as tp

ARCHS = ("stablelm-1.6b", "falcon-mamba-7b", "gemma2-27b",
         "recurrentgemma-9b")
# the archs whose params after AdamW steps are held to the reference's;
# gemma2's and recurrentgemma's grads are held leaf by leaf instead
# (test_grads_match_reference): their smoke configs have grads of ~1e-8,
# the size of AdamW's eps, where the first step's m / (sqrt(v) + eps)
# turns a float32 rounding of the grad into ~5% of lr.
STEP_ARCHS = ARCHS[:2]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _batch(cfg, B=2, S=32, seed=3):
    toks = np.random.default_rng(seed).integers(1, cfg.vocab, (B, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port(batch):
    return {k: _t(v) for k, v in batch.items()}


def _named(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def test_lm_trainer_learns():
    """Tiny LM memorizes a repeating sequence (loss drops markedly)."""
    cfg = smoke_config("stablelm-1.6b")
    model = TM.init_params(cfg, device="cpu")
    opt = init_opt(model)
    toks = np.tile(np.arange(32) % 17 + 1, (4, 2)).astype(np.int32)
    batch = _port({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    l0 = None
    for _ in range(40):
        model, opt, m = train_step(model, opt, batch, cfg=cfg, lr=3e-3)
        if l0 is None:
            l0 = float(m["loss"])
    l1 = float(m["loss"])
    assert np.isfinite(l1)
    assert l1 < 0.5 * l0


@pytest.fixture(scope="module", params=STEP_ARCHS)
def reference_steps(request):
    """The reference's weights and its params, loss and grad_norm after 1
    and 3 `train_step`s (float32 smoke config, lr 3e-4)."""
    arch = request.param
    cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    init = tp.tree_to_numpy(params)
    opt = ref_adamw_init(params)
    batch = _batch(cfg)
    step = jax.jit(lambda p, o, b: ref_train_step(p, o, b, cfg=cfg))
    after = {}
    for t in range(1, 4):
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        after[t] = (tp.tree_to_numpy(params), float(m["loss"]),
                    float(m["grad_norm"]))
    return arch, init, batch, after


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_reference(reference_steps, steps):
    arch, init, batch, after = reference_steps
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    model = TM.params_from_reference(init, cfg, device="cpu")
    opt = init_opt(model)
    for _ in range(steps):
        model, opt, m = train_step(model, opt, _port(batch), cfg=cfg)
    want_params, loss, gnorm = after[steps]
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=1e-4)
    assert float(m["xent"]) == float(m["loss"])
    assert float(m["moe_aux"]) == 0.0
    want = _named(TM.params_from_reference(want_params, cfg, device="cpu"))
    for n, p in _named(model).items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)
    assert int(opt.step) == steps


def _loss_and_grads(model, batch, cfg):
    model.zero_grad(set_to_none=True)
    loss, _ = TM.forward_train(model, batch, cfg)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    """Every leaf's grad within 1e-4 of that leaf's largest |grad| of
    `jax.grad` of the reference's loss (float32; the windowed and RG-LRU
    backward through plain torch autograd), and one `train_step`'s loss
    and grad_norm the reference's."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RM.forward_train(p, jbatch, cfg)[0]))(params)
    init = tp.tree_to_numpy(params)
    model = TM.params_from_reference(init, cfg, device="cpu")
    got_loss, got = _loss_and_grads(model, _port(batch), cfg)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want = _named(TM.params_from_reference(tp.tree_to_numpy(grads), cfg,
                                           device="cpu"))
    assert got.keys() == want.keys()
    for n, g in got.items():
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=n)
    _, _, m = jax.jit(lambda p, o, b: ref_train_step(p, o, b, cfg=cfg))(
        params, ref_adamw_init(params), jbatch)
    model = TM.params_from_reference(init, cfg, device="cpu")
    _, _, got_m = train_step(model, init_opt(model), _port(batch), cfg=cfg)
    np.testing.assert_allclose(float(got_m["loss"]), float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(m["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_grads_equal_no_remat_bit_for_bit(arch, policy):
    cfg = smoke_config(arch)
    model = TM.init_params(cfg, device="cpu")
    batch = _port(_batch(cfg, seed=5))
    loss0, g0 = _loss_and_grads(model, batch,
                                dataclasses.replace(cfg, remat=False))
    loss1, g1 = _loss_and_grads(
        model, batch, dataclasses.replace(cfg, remat=True,
                                          remat_policy=policy))
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def _product_shape(op, args):
    """The output shape of a matmul op from its inputs' shapes (None for
    any other op)."""
    aten = torch.ops.aten
    if op is aten.mm.default:
        return (args[0].shape[0], args[1].shape[1])
    if op is aten.addmm.default:
        return (args[1].shape[0], args[2].shape[1])
    if op is aten.bmm.default:
        return (args[0].shape[0], args[0].shape[1], args[1].shape[2])
    return None


def test_remat_dots_keeps_no_batched_product(monkeypatch):
    """remat "dots" keeps the products without batch dimensions (the
    projections, mm) and recomputes the batched ones (the attention's
    einsums, bmm), as the reference's dots_with_no_batch_dims_saveable:
    no (B, KV, G, C, T) score is kept for the backward."""
    from torch.utils.checkpoint import CheckpointPolicy
    cfg = dataclasses.replace(smoke_config("stablelm-1.6b"), remat=True,
                              remat_policy="dots")
    B, S = 2, 32
    KV, G = cfg.n_kv, cfg.n_heads // cfg.n_kv
    C = min(cfg.q_chunk, S)
    model = TM.init_params(cfg, device="cpu")
    batch = _port(_batch(cfg, B=B, S=S, seed=5))
    seen = {CheckpointPolicy.MUST_SAVE: [],
            CheckpointPolicy.PREFER_RECOMPUTE: []}
    real = TM._dots_saveable

    def policy(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        shape = _product_shape(op, args)
        if not ctx.is_recompute and shape is not None:
            seen[out].append((op, shape))
        return out

    monkeypatch.setattr(TM, "_dots_saveable", policy)
    _loss_and_grads(model, batch, cfg)
    saved = seen[CheckpointPolicy.MUST_SAVE]
    recomputed = seen[CheckpointPolicy.PREFER_RECOMPUTE]
    # wq, wk, wv, the attention's wo, and the swiglu's wg, wi, wo
    assert len(saved) == 7 * cfg.n_layers
    assert all(op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
               and len(shape) == 2 for op, shape in saved)
    score = (B * KV, G * C, S)              # (B, KV, G, C, T) as bmm gives it
    assert [shape for op, shape in recomputed].count(score) == cfg.n_layers
    assert all(op is torch.ops.aten.bmm.default for op, _ in recomputed)


def test_remat_recomputes_with_the_weights_functional_call_gave():
    """Under `torch.func.functional_call` (CoCoA-DP's local steps) the
    remat backward uses the swapped-in weights, not the module's own."""
    cfg = smoke_config("stablelm-1.6b")
    model = TM.init_params(cfg, device="cpu")
    batch = _port(_batch(cfg, seed=6))
    other = {n: (p * 1.5).requires_grad_() for n, p in _named(model).items()}
    grads = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss = decoder_loss_fn(model)(other, batch)
        grads[remat] = torch.autograd.grad(loss, list(other.values()))
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("make", ["adding", "averaging"])
def test_localdp_round_on_the_decoder_matches_reference(make):
    """One CoCoA-DP round on smoke stablelm (float32, K = 2 workers, H = 2)
    with the forward_train loss, against the reference's round."""
    cfg = dataclasses.replace(ref_smoke_config("stablelm-1.6b"),
                              dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab, (2, 2, 17))
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    kw = dict(H=2, inner_lr=1e-2)
    rcfg = getattr(ref_localdp.LocalDPConfig, make)(2, **kw)
    rf = jax.jit(ref_localdp.make_round_fn(
        lambda p, b: RM.forward_train(p, b, cfg)[0], rcfg))
    rs = rf(ref_localdp.init_state(params, rcfg),
            {k: jnp.asarray(v) for k, v in batches.items()})
    model = TM.params_from_reference(tp.tree_to_numpy(params), cfg,
                                     device="cpu")
    tcfg = getattr(LocalDPConfig, make)(2, **kw)
    ts = make_round_fn(decoder_loss_fn(model), tcfg)(
        init_state(_named(model), tcfg), _port(batches))
    want = _named(TM.params_from_reference(tp.tree_to_numpy(rs.params),
                                           cfg, device="cpu"))
    for n, p in ts.params.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_reference_flash_kernel_has_no_gradient():
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 128, 2, 64))
                           .astype(np.float32)) for _ in range(3))
    with pytest.raises(AssertionError):
        jax.grad(lambda q: ref_flash(q, k, v, interpret=True).sum())(q)


@pytest.mark.parametrize("arch,flag", [("stablelm-1.6b",
                                        "use_flash_attention"),
                                       ("falcon-mamba-7b", "use_fused_ssm")])
def test_train_step_through_a_kernel_raises(arch, flag):
    cfg = dataclasses.replace(smoke_config(arch), **{flag: True})
    model = TM.init_params(cfg, device="cpu")
    before = {n: p.clone() for n, p in _named(model).items()}
    with pytest.raises(NotImplementedError, match=f"{flag}=False"):
        train_step(model, init_opt(model), _port(_batch(cfg)), cfg=cfg)
    assert all(torch.equal(p, before[n]) for n, p in _named(model).items())
    with torch.no_grad():                       # scoring still runs
        loss, _ = TM.forward_train(model, _port(_batch(cfg)), cfg)
    assert torch.isfinite(loss)


def test_kernel_wrappers_refuse_grad_on_cpu_tensors():
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((1, 8, 2, 32)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        fa.flash_attention(q.clone().requires_grad_(), q, q)
    B, S, di, N = 1, 4, 8, 2
    args = [_t(rng.standard_normal(s).astype(np.float32)) for s in
            ((B, S, di), (B, S, di), (B, S, N), (B, S, N), (di, N), (di,))]
    args[4] = args[4].requires_grad_()
    with pytest.raises(NotImplementedError, match="use_fused_ssm"):
        ss.ssm_scan(*args)
    with torch.no_grad():                       # the no-grad path as it was
        assert torch.equal(fa.flash_attention(q, q, q),
                           fa.flash_attention_plain(q, q, q))
        assert torch.equal(ss.ssm_scan(*args), ss.ssm_scan_plain(*args))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_cuda_tensors():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_train.py`")
    q = torch.zeros((1, 64, 2, 64), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        fa.flash_attention(q, q.detach(), q.detach())
    z = torch.zeros((1, 4, 128), device="cuda", requires_grad=True)
    bc = torch.zeros((1, 4, 16), device="cuda")
    with pytest.raises(NotImplementedError, match="use_fused_ssm"):
        ss.ssm_scan(z, z.detach(), bc, bc, torch.zeros((128, 16),
                                                       device="cuda"),
                    torch.zeros(128, device="cuda"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_records_no_graph(arch):
    cfg = smoke_config(arch)
    model = TM.init_params(cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    toks = _t(np.arange(1, 9, dtype=np.int64)[None])
    cache = TM.init_cache(cfg, 1, 16, device="cpu")
    logits, cache = tserve.prefill_step(model, {"tokens": toks}, cache)
    assert not logits.requires_grad and logits.grad_fn is None
    nxt, cache = tserve.serve_step(model, cache, toks[:, -1:], 8)
    assert not nxt.requires_grad
    for layer in cache:
        assert all(not c.requires_grad for c in layer.values())
    eng = ServingEngine(cfg, model, slots=2, s_max=32, device="cpu")
    reqs = [eng.submit(np.array([3, 5, 7]), max_new=4) for _ in range(3)]
    eng.run_until_drained()
    assert all(len(r.out) == 4 for r in reqs)
    for layer in eng.cache:
        assert all(not c.requires_grad for c in layer.values())


def test_run_training_on_a_one_card_mesh_names_the_process_mesh():
    """A sharded step needs one rank a mesh position: a one-card mesh of
    more than one position raises, naming the process mesh (the sharded
    run itself: test_torch_sharded_steps.py)."""
    cfg = smoke_config("stablelm-1.6b")
    with pytest.raises(ValueError, match="process mesh"):
        run_training(cfg, make_test_mesh((2, 1), device="cpu"), iter(()),
                     steps=1, device="cpu")


def test_run_training_on_the_cpu_logs_and_calls_back(capsys):
    cfg = smoke_config("stablelm-1.6b")
    seen = []
    stream = iter(TokenStream(cfg.vocab, 2, 16, seed=0, corpus_len=4096))
    model, opt, m = run_training(
        cfg, None, stream, steps=4, lr=3e-3, log_every=2, device="cpu",
        on_step=lambda t, model, opt, m: seen.append((t, float(m["loss"]))))
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["step 2", "step 4"]
    assert "grad_norm=" in out[0] and "xent=" in out[0]
    assert [t for t, _ in seen] == [1, 2, 3, 4]
    assert int(opt.step) == 4 and model.device.type == "cpu"
    # resuming from step 4 continues the same model and state
    model, opt, _ = run_training(cfg, None, stream, steps=6, log_every=10,
                                 params=model, opt=opt, start_step=4)
    assert int(opt.step) == 6


@pytest.mark.parametrize("arch", ["gemma-7b", "gemma3-27b",
                                  "recurrentgemma-9b"])
def test_run_training_runs_the_windowed_archs(arch):
    """`run_training`, unchanged, on the archs with windows and RG-LRU
    blocks (their steps are held to the reference's above): a falling
    loss from the same few batches."""
    cfg = smoke_config(arch)
    toks = np.tile(np.arange(40) % 13 + 1, (2, 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    run_training(cfg, None, iter([batch] * 6), steps=6, lr=3e-3,
                 log_every=10, device="cpu",
                 on_step=lambda t, model, opt, m: losses.append(
                     float(m["loss"])))
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_run_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train on it")
    with pytest.raises(RuntimeError, match="cuda"):
        run_training(smoke_config("stablelm-1.6b"), None, iter(()), steps=1)
