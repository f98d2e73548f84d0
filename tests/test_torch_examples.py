"""The port's five examples (`examples/torch_*.py`) against the
reference's (`examples/*.py`) on the CPU, the same inputs on both sides.

The reference's side runs in one child through
`torch_parity.reference_in_child`: each example's own calls (`solve` with
the solver the port's example uses, the features, prefill and decode, the
jitted train step). The port's side calls its example's functions, fed
the reference's visit orders (`torch_parity.reference_visit_orders`) and
weights (`models.model.params_from_reference`, the reference's
`init_params(PRNGKey(0))` made here):
- quickstart: `tiny`, K = 8, the three configs through `sdca_kernel`, 10
  rounds certified every 5: gaps and primals within GAP_RTOL = 1e-4 (as
  `test_torch_cocoa.py`), train accuracy within 1e-6;
- lasso_sparse: `tiny_sparse`, squared loss under `l1s:1e-4`, H 256,
  `sdca_sparse_kernel` (the fused soft-threshold prox), 10 rounds: gaps,
  the final (P, D, gap) within GAP_RTOL, w within 1e-4, the nonzeros
  equal;
- linear_probe: smoke gemma-7b, 256 sequences of 32: the pooled features
  within FEAT_TOL = 1e-5 relative, then the probe on the reference's
  features through `sdca_kernel`, 10 rounds: gaps within GAP_RTOL;
- serve_batched: smoke gemma2-27b (rings and a global cache), 4 prompts of
  24 and 24 generated: the prefill's logits within 1e-5 relative, every
  generated token equal;
- lm_pretrain: a cut config of the example's family (2 layers, d 64) at B
  2 x S 32, 3 AdamW steps at lr 3e-4: each step's loss within 1e-5
  relative and the weights after within 1e-5 absolute (as
  `test_torch_train.py`'s steps); the 20M and 100M configs'
  parameter counts equal; and, port alone, a run stopped at its step-3
  checkpoint and resumed to step 6 equal to an uninterrupted 6 steps.
Each example's `main` also runs once on the CPU at a small size and
prints its result lines.
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import torch_parity as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP_RTOL = 1e-4
FEAT_TOL = 1e-5
LOGITS_TOL = 1e-5
K = 8
QS_ROUNDS = 10
LASSO = dict(dataset="tiny_sparse", workers=8, lam=1e-4, eps_smooth=1e-4,
             H=256, rounds=10, eps_gap=1e-4)
PROBE_N, PROBE_ROUNDS = 256, 10
SERVE = dict(arch="gemma2-27b", B=4, P=24, G=24)
LM_B, LM_S, LM_STEPS = 2, 32, 3
LM_CUT = dict(name="lmcut", family="dense", n_layers=2, d_model=64,
              n_heads=2, n_kv=2, head_dim=32, d_ff=128, vocab=512,
              tie_embeddings=True, dtype="float32", q_chunk=32,
              loss_chunk=32, remat=False)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REF = """
import jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.core import CoCoAConfig, duality, get_regularizer, primal_w, solve
from repro.core.losses import get_loss
from repro.data import load, partition
from repro.data.sparse import partition_sparse
from repro.data.tokens import TokenStream
from repro.launch.serve import prefill_step, serve_step
from repro.launch.train import make_jitted_train_step
from repro.models import model as M
from repro.models.config import Block, ModelConfig
from repro.optim.adamw import adamw_init
import functools

def hist(prefix, r):
    out[prefix + "round"] = np.asarray(r.history["round"])
    out[prefix + "gap"] = np.asarray(r.history["gap"])
    out[prefix + "primal"] = np.asarray(r.history["primal"])

def acc(Xp, yp, mk, w):
    z = np.asarray(jnp.einsum("kid,d->ki", Xp, w))
    return float((np.sign(z) == np.asarray(yp))[np.asarray(mk) > 0].mean())

# quickstart: the three configs through the dense kernel
K = {K}
X, y = load("tiny")
Xp, yp, mk = partition(X, y, K, seed=0)
common = dict(loss="hinge", lam=1e-3, H=512, solver="sdca_kernel")
for i, cfg in enumerate([CoCoAConfig.adding(K, **common),
                         CoCoAConfig.averaging(K, **common),
                         CoCoAConfig(gamma=1.0, sigma_p=1.0, **common)]):
    r = solve(cfg, Xp, yp, mk, rounds={qs_rounds}, eps_gap=1e-3,
              gap_every=5)
    hist(f"qs{{i}}_", r)
    out[f"qs{{i}}_acc"] = np.asarray(acc(Xp, yp, mk, r.state.w))

# lasso_sparse through the sparse kernel
a = {lasso!r}
csr, y = load(a["dataset"])
sh, yp, mk = partition_sparse(csr, y, a["workers"], seed=0)
reg_spec = f"l1s:{{a['eps_smooth']}}"
cfg = CoCoAConfig.adding(a["workers"], loss="squared", lam=a["lam"],
                         H=a["H"], reg=reg_spec, solver="sdca_sparse_kernel")
r = solve(cfg, sh, yp, mk, rounds=a["rounds"], eps_gap=a["eps_gap"],
          gap_every=2)
hist("lasso_", r)
p, d, g = duality.gap_at_v(r.state.w, r.state.alpha, sh, yp, mk,
                           get_loss("squared"), a["lam"],
                           get_regularizer(reg_spec))
out["lasso_pdg"] = np.asarray([float(p), float(d), float(g)])
out["lasso_w"] = np.asarray(primal_w(r.state, cfg))

# linear_probe: the features, then the probe on them
cfg = smoke_config("gemma-7b")
params = M.init_params(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(0)
n, S = {probe_n}, 32
toks = rng.integers(1, cfg.vocab, (n, S)).astype(np.int32)
labels = np.where(toks.sum(axis=1) % 2 == 0, 1.0, -1.0).astype(np.float32)

@jax.jit
def features(tokens):
    x = M._embed_inputs(params, {{"tokens": tokens}}, cfg)
    ctx = {{"positions": M._positions(cfg, {{}}, tokens.shape[0], S),
           "pos": None, "decode": False}}
    h, _, _ = M._run_stack(params, x, cfg, ctx, None)
    return h[:, -1]

feats = np.concatenate([np.asarray(features(toks[i:i + 256]))
                        for i in range(0, n, 256)])
out["probe_raw"] = feats
feats = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-9)
out["probe_feats"] = feats
Xp, yp, mk = partition(feats.astype(np.float32), labels, K, seed=0)
r = solve(CoCoAConfig.adding(K, loss="smooth_hinge1", lam=1e-3, H=512,
                             solver="sdca_kernel"),
          Xp, yp, mk, rounds={probe_rounds}, eps_gap=1e-3, gap_every=5)
hist("probe_", r)

# serve_batched: prefill and greedy decode
s = {serve!r}
cfg = smoke_config(s["arch"])
params = M.init_params(jax.random.PRNGKey(0), cfg)
B, P, G = s["B"], s["P"], s["G"]
rng = np.random.default_rng(0)
prompts = rng.integers(1, cfg.vocab, (B, P)).astype(np.int32)
cache = M.init_cache(cfg, B, P + G)
pre = jax.jit(functools.partial(prefill_step, cfg=cfg))
dec = jax.jit(functools.partial(serve_step, cfg=cfg))
logits, cache = pre(params, {{"tokens": prompts}}, cache)
out["serve_logits"] = np.asarray(logits[:, -1], np.float32)
tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
outs = [np.asarray(tok)]
for t in range(P, P + G - 1):
    tok, cache = dec(params, cache, tok, t)
    outs.append(np.asarray(tok))
out["serve_tokens"] = np.concatenate(outs, axis=1)

# lm_pretrain: a cut config of its family, the jitted step on one device
# (a mesh of Auto axes: the example's own jax.make_mesh((1, 1)) makes
# Explicit axes on jax 0.9, and its step then fails in the embedding's
# gather, ROADMAP.md Queue 3)
cfg = ModelConfig(pattern=(Block(mlp="swiglu"),), **{lm_cut!r})
params = M.init_params(jax.random.PRNGKey(0), cfg)
opt = adamw_init(params)
from jax.sharding import AxisType
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
step = make_jitted_train_step(cfg, mesh, lr=3e-4, donate=False)
stream = TokenStream(cfg.vocab, {lm_b}, {lm_s}, seed=0)
losses = []
for t in range({lm_steps}):
    params, opt, m = step(params, opt, stream.batch_at(t))
    losses.append(float(m["loss"]))
out["lm_losses"] = np.asarray(losses)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["lm_param/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
for size, kw in (("20m", dict(n_layers=6, d_model=384, n_heads=6, n_kv=6,
                              head_dim=64, d_ff=1536, vocab=8_000)),
                 ("100m", dict(n_layers=10, d_model=640, n_heads=10,
                               n_kv=10, head_dim=64, d_ff=2560,
                               vocab=32_000))):
    c = ModelConfig(name="lm" + size, family="dense",
                    pattern=(Block(mlp="swiglu"),), tie_embeddings=True,
                    dtype="float32", q_chunk=128, loss_chunk=128,
                    remat=False, **kw)
    out["lm_count_" + size] = np.asarray(M.count_params(c))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded: its reductions in one order on every run,
    as `test_torch_lm_kernels.py` runs them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    return tp.reference_in_child(_REF.format(
        K=K, qs_rounds=QS_ROUNDS, lasso=LASSO, probe_n=PROBE_N,
        probe_rounds=PROBE_ROUNDS,
        serve=SERVE, lm_cut=LM_CUT, lm_b=LM_B, lm_s=LM_S,
        lm_steps=LM_STEPS), devices=1, timeout=600)


def _reference_params(cfg):
    """The reference's `init_params(PRNGKey(0), cfg)` as numpy."""
    import jax
    from repro.configs import smoke_config as ref_smoke
    from repro.models import model as RM
    return tp.tree_to_numpy(RM.init_params(jax.random.PRNGKey(0),
                                           ref_smoke(cfg.name)))


def _same_history(ref, prefix, hist):
    np.testing.assert_array_equal(hist["round"], ref[prefix + "round"])
    np.testing.assert_allclose(hist["gap"], ref[prefix + "gap"],
                               rtol=GAP_RTOL)
    np.testing.assert_allclose(hist["primal"], ref[prefix + "primal"],
                               rtol=GAP_RTOL)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_quickstart_matches_the_reference(reference):
    qs = _example("quickstart")
    hook = tp.reference_visit_orders(0, QS_ROUNDS, K, 1024 // K, 512,
                                     "permutation")
    runs = qs.run("cpu", rounds=QS_ROUNDS, visit_orders=lambda i: hook)
    assert [name for name, _, _ in runs] == [n for n, _ in qs.configs()]
    for i, (_, r, acc) in enumerate(runs):
        _same_history(reference, f"qs{i}_", r.history)
        assert acc == pytest.approx(float(reference[f"qs{i}_acc"]),
                                    abs=1e-6)
    # CoCoA+ certifies below CoCoA's gap; naive adding stalls far above
    gaps = [r.history["gap"][-1] for _, r, _ in runs]
    assert gaps[0] < gaps[1] < gaps[2]


def test_lasso_sparse_matches_the_reference(reference):
    ex = _example("lasso_sparse")
    args = ex.parser().parse_args(
        ["--device", "cpu"] + [f"--{k.replace('_', '-')}={v}"
                               for k, v in LASSO.items()])
    nk = -(-1024 // LASSO["workers"])
    hook = tp.reference_visit_orders(0, LASSO["rounds"], LASSO["workers"],
                                     nk, LASSO["H"], "permutation")
    cfg, r, pdg, w = ex.lasso(args, visit_orders=hook)
    assert cfg.solver == "sdca_sparse_kernel"
    _same_history(reference, "lasso_", r.history)
    np.testing.assert_allclose(pdg, reference["lasso_pdg"], rtol=GAP_RTOL)
    want = reference["lasso_w"]
    np.testing.assert_allclose(tp.to_np(w), want, rtol=1e-4, atol=1e-6)
    assert int((tp.to_np(w) != 0).sum()) == int((want != 0).sum())
    assert 0 < int((want != 0).sum()) < want.size


def test_linear_probe_matches_the_reference(reference):
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    ex = _example("linear_probe")
    cfg = smoke_config("gemma-7b")
    model = M.params_from_reference(_reference_params(cfg), cfg,
                                    device="cpu")
    toks, labels = ex.tokens_and_labels(cfg, PROBE_N)
    raw = tp.to_np(ex.features(model, cfg, torch.from_numpy(toks)))
    assert _rel(raw, reference["probe_raw"]) <= FEAT_TOL
    feats = ex.pooled_features(model, cfg, toks, "cpu")
    assert _rel(feats, reference["probe_feats"]) <= FEAT_TOL
    hook = tp.reference_visit_orders(0, PROBE_ROUNDS, K, PROBE_N // K, 512,
                                     "permutation")
    r, acc = ex.probe(reference["probe_feats"], labels, "cpu",
                      rounds=PROBE_ROUNDS, visit_orders=hook)
    _same_history(reference, "probe_", r.history)
    assert 0.0 < acc <= 1.0


def test_serve_batched_matches_the_reference(reference):
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    ex = _example("serve_batched")
    cfg = smoke_config(SERVE["arch"])
    model = M.params_from_reference(_reference_params(cfg), cfg,
                                    device="cpu")
    prompts, emb = ex.prompts_for(cfg, SERVE["B"], SERVE["P"])
    assert emb is None
    logits, gen, _, _ = ex.generate(model, cfg, prompts, emb, SERVE["G"],
                                    "cpu")
    assert _rel(tp.to_np(logits), reference["serve_logits"]) <= LOGITS_TOL
    np.testing.assert_array_equal(tp.to_np(gen), reference["serve_tokens"])


def _lm_cut():
    from repro_torch.models.config import Block, ModelConfig
    return ModelConfig(pattern=(Block(mlp="swiglu"),), **LM_CUT)


def _reference_lm_params(ref, cfg):
    """The reference's trained cut model from the child's flattened
    leaves ("['scan'][0]['attn']['wq']"), nested again."""
    tree: dict = {}
    for key, arr in ref.items():
        if not key.startswith("lm_param/"):
            continue
        parts = [p.strip("'") for p in
                 key[len("lm_param/"):].strip("[]").split("][")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for top in ("scan", "rest"):        # list indices back into lists
        tree[top] = [tree.get(top, {})[str(i)]
                     for i in range(len(tree.get(top, {})))]
    return tree


def test_lm_pretrain_matches_the_reference(reference, tmp_path):
    import jax
    from repro.models import model as RM
    from repro.models.config import Block as RBlock, ModelConfig as RConfig
    from repro_torch.models import model as M
    ex = _example("lm_pretrain")
    cfg = _lm_cut()
    rcfg = RConfig(pattern=(RBlock(mlp="swiglu"),), **LM_CUT)
    model = M.params_from_reference(tp.tree_to_numpy(RM.init_params(
        jax.random.PRNGKey(0), rcfg)), cfg, device="cpu")
    model, losses = ex.pretrain(cfg, steps=LM_STEPS, batch=LM_B, seq=LM_S,
                                ckpt=tmp_path, device="cpu", model=model,
                                log_every=1)
    np.testing.assert_allclose([losses[t + 1] for t in range(LM_STEPS)],
                               reference["lm_losses"], rtol=1e-5)
    want = M.reference_state(_reference_lm_params(reference, cfg), cfg)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(tp.to_np(got[n]), want[n], rtol=0,
                                   atol=1e-5, err_msg=n)
    for size in ("20m", "100m"):
        assert M.count_params(ex.config(size)) == int(
            reference[f"lm_count_{size}"])


def test_lm_pretrain_resumes_from_its_checkpoint(tmp_path, capsys):
    ex = _example("lm_pretrain")
    cfg = _lm_cut()
    kw = dict(batch=LM_B, seq=LM_S, device="cpu", log_every=1,
              ckpt_every=3)
    ex.pretrain(cfg, steps=4, ckpt=tmp_path / "a", **kw)
    assert (tmp_path / "a" / cfg.name / "step_3").is_dir()
    resumed, losses = ex.pretrain(cfg, steps=6, ckpt=tmp_path / "a", **kw)
    assert "resumed from checkpoint step 3" in capsys.readouterr().out
    assert sorted(losses) == [4, 5, 6]
    whole, want = ex.pretrain(cfg, steps=6, ckpt=tmp_path / "b", **kw)
    assert losses == {t: want[t] for t in (4, 5, 6)}
    for n, t in whole.state_dict().items():
        assert torch.equal(resumed.state_dict()[n], t), n


@pytest.mark.parametrize("name,argv,lines", [
    ("quickstart", [], ["CoCoA+  (adding, sigma'=K): rounds=", "certificate"]),
    ("lasso_sparse", ["--dataset", "tiny_sparse", "--rounds", "4",
                      "--H", "128"], ["round 4: gap=", "final: P=",
                                      "nonzeros"]),
    ("linear_probe", [], ["probe: rounds=", "certificate: primal"]),
    ("serve_batched", ["--batch", "2", "--gen", "4"],
     ["prefill 2x24:", "tok/s batch", "req1: prompt="]),
    ("lm_pretrain", ["--steps", "2", "--batch", "2", "--seq", "32",
                     "--ckpt", "{tmp}"], ["model: 17.2M params", "done;"]),
], ids=["quickstart", "lasso_sparse", "linear_probe", "serve_batched",
        "lm_pretrain"])
def test_example_main_runs_on_the_cpu(name, argv, lines, tmp_path, capsys,
                                      monkeypatch):
    ex = _example(name)
    if name in ("quickstart", "linear_probe"):    # their sizes, cut here
        monkeypatch.setattr(ex, "ROUNDS", 5)
    if name == "linear_probe":
        monkeypatch.setattr(ex, "N", 128)
    ex.main([a.format(tmp=tmp_path) for a in argv] + ["--device", "cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)
