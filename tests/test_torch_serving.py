"""The port's serving path held against the reference's: the engines must
give identical token ids and identical live counts at every engine step
(float32, the reference's weights carried across by
`params_from_reference`; greedy argmax over logits that agree to ~1e-6).

Also records a fault of the reference engine: `ServingEngine` slices each
cache leaf for one slot on `axis = ndim - 4` (serving_runtime.py:64-72),
which is the batch axis of the stacked attention caches (n_periods, B, S,
KV, hd) but the layer axis of the stacked SSM caches (n_periods, B, di, N)
and (n_periods, B, W-1, di), so the reference engine cannot serve a mamba
model. The RG-LRU caches of recurrentgemma, (n_periods, B, L) and
(n_periods, B, W-1, L), meet the same fault. The port keeps one cache per
layer and slices the batch axis (its recurrentgemma requests are held to
one-row reference loops in tests/test_torch_windows.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_runtime import ServingEngine as TEngine
from repro_torch.models import model as TM

from torch_parity import tree_to_numpy

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.launch.serving_runtime import ServingEngine as REngine  # noqa
from repro.models import model as RM  # noqa: E402

PROMPT_LENS = (5, 9, 7, 4, 11, 6)     # tests/test_serving_runtime.py:19-21


def _weights(arch, **change):
    cfg = dataclasses.replace(smoke_config(arch), **change)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, TM.params_from_reference(tree_to_numpy(params), cfg,
                                                 device="cpu")


@pytest.mark.parametrize("flash", [True, False])
def test_engine_gives_the_reference_tokens_and_live_counts(flash):
    cfg, params, model = _weights("stablelm-1.6b", use_flash_attention=flash)
    ref = REngine(cfg, params, slots=3, s_max=64)
    port = TEngine(cfg, model, slots=3, s_max=64, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, (p,)).astype(np.int32)
               for p in PROMPT_LENS]
    rreqs = [ref.submit(p, max_new=6) for p in prompts]
    treqs = [port.submit(p, max_new=6) for p in prompts]
    live = []
    for _ in range(100):
        a, b = ref.step(), port.step()
        live.append((a, b))
        if a == 0 and not ref.queue:
            break
    assert all(a == b for a, b in live), live
    assert [a for a, _ in live][:3] == [3, 3, 3]
    for r, t in zip(rreqs, treqs):
        assert t.done and r.done
        assert t.rid == r.rid and t.out == r.out, (t.out, r.out)
        assert len(t.out) == 6


def test_serve_steps_match_reference():
    cfg, params, model = _weights("stablelm-1.6b", use_flash_attention=True)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 10))
    rcache = RM.init_cache(cfg, 2, 16)
    rlog, rcache = rserve.prefill_step(params, {"tokens": jnp.asarray(toks)},
                                       rcache, cfg=cfg)
    tcache = TM.init_cache(cfg, 2, 16, device="cpu")
    tlog, tcache = tserve.prefill_step(model, {"tokens": torch.from_numpy(
        toks)}, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), rtol=1e-4,
                               atol=1e-5)
    nxt = jnp.argmax(rlog[:, -1], axis=-1).astype(jnp.int32)[:, None]
    rn, _ = rserve.serve_step(params, rcache, nxt, 10, cfg=cfg)
    tn, _ = tserve.serve_step(model, tcache, torch.from_numpy(np.array(nxt)),
                              10)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))


def test_reference_engine_slices_ssm_caches_on_the_layer_axis():
    """Confirmed: for every stacked SSM leaf the reference's slot axis
    (ndim - 4 = 0) is the layer axis, and the first engine step raises
    (the conv tail keeps all 3 slots while the prompt has 1 row)."""
    cfg, params, _ = _weights("falcon-mamba-7b")
    eng = REngine(cfg, params, slots=3, s_max=64)
    n_full, _ = RM._split_layers(cfg)
    for leaf in jax.tree.leaves(eng.cache["scan"]):
        axis = leaf.ndim - 4 if leaf.ndim >= 4 else 0
        assert axis == 0 and leaf.shape[0] == n_full != eng.B
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    with pytest.raises(TypeError, match="concatenate"):
        eng.step()


def test_reference_engine_slices_rglru_caches_on_the_layer_axis():
    """Confirmed: recurrentgemma's stacked RG-LRU leaves are sliced on
    their layer axis (ndim - 4 <= 0 -> 0), its stacked attention rings on
    the batch axis; the first engine step raises (the conv tail keeps
    both slots while the prompt has 1 row: (2, 3, 64) against (1, 40,
    64))."""
    cfg, params, _ = _weights("recurrentgemma-9b")
    eng = REngine(cfg, params, slots=2, s_max=96)
    n_full, _ = RM._split_layers(cfg)
    for j, spec in enumerate(cfg.pattern):
        for leaf in jax.tree.leaves(eng.cache["scan"][j]):
            axis = leaf.ndim - 4 if leaf.ndim >= 4 else 0
            if spec.mixer == "rglru":
                assert axis == 0 and leaf.shape[0] == n_full != eng.B
            else:
                assert axis == 1 and leaf.shape[1] == eng.B
    rng = np.random.default_rng(0)
    for p in (40, 9, 50):
        eng.submit(rng.integers(1, 500, (p,)).astype(np.int32), max_new=3)
    with pytest.raises(TypeError, match=r"concatenate.*\(2, 3, 64\).*"
                                        r"\(1, 40, 64\)"):
        eng.step()


def test_port_engine_serves_a_mamba_model():
    """The port slices the batch axis: each request gets the tokens of a
    one-row greedy loop on the reference model."""
    cfg, params, model = _weights("falcon-mamba-7b")
    port = TEngine(cfg, model, slots=2, s_max=32, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 500, (p,)).astype(np.int32) for p in (5, 8, 3)]
    reqs = [port.submit(p, max_new=4) for p in prompts]
    port.run_until_drained()
    for p, r in zip(prompts, reqs):
        cache = RM.init_cache(cfg, 1, 32)
        logits, cache = RM.prefill(params, {"tokens": jnp.asarray(p[None])},
                                   cfg, cache)
        want = [int(jnp.argmax(logits[0, -1]))]
        for step in range(3):
            logits, cache = RM.decode_step(
                params, cache, jnp.asarray([[want[-1]]], jnp.int32),
                len(p) + step, cfg)
            want.append(int(jnp.argmax(logits[0, -1])))
        assert r.done and r.out == want


def test_engine_defaults_to_cuda():
    cfg = smoke_config("stablelm-1.6b")
    model = TM.init_params(cfg, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="model is on cpu"):
            TEngine(cfg, model)
        eng = TEngine(cfg, TM.init_params(cfg))       # both default to cuda
        assert eng.cache[0]["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine(cfg, model)
