"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

The port may not import jax, so everything that needs both sides lives
here: numpy input makers, jax <-> numpy <-> torch converters, and the
reference's key derivation turned into explicit visit orders. jax is
imported only inside the functions that use it, so the card-only tests
can import this module on a machine without jax. Reference
round t draws from `rng, sub = split(state.rng)` and worker k from
`fold_in(sub, k)` (repro/core/cocoa.py:305-309); the kernel solvers walk
`permutation(key_k, nk)` (repro/kernels/ops.py:88, :206), the eager
solvers `randint(key_k, (H,), 0, nk)` (repro/core/solvers.py:126, :311).
"""
from __future__ import annotations

import numpy as np
import torch


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_arrays(ref_state) -> dict:
    """A reference `CoCoAState`'s leaves as numpy (the rng key included,
    which `state_from_reference` drops)."""
    return {k: to_np(v) for k, v in ref_state._asdict().items()
            if v is not None}


def round_keys(key, rounds: int):
    """The per-round `sub` keys a reference solve derives from `key`."""
    import jax
    subs = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def visit_orders_from_keys(subs, K: int, nk: int, H: int, kind: str):
    """One torch (K, nk) permutation or (K, H) row-id tensor per round."""
    import jax
    out = []
    for sub in subs:
        rows = []
        for k in range(K):
            kk = jax.random.fold_in(sub, k)
            if kind == "permutation":
                rows.append(np.asarray(jax.random.permutation(kk, nk)))
            else:
                rows.append(np.asarray(jax.random.randint(kk, (H,), 0, nk)))
        out.append(torch.as_tensor(np.stack(rows).astype(np.int64)))
    return out


def reference_visit_orders(seed_or_key, rounds: int, K: int, nk: int, H: int,
                           kind: str):
    """`solve(visit_orders=...)` hook replaying a reference solve's visit
    orders from `seed` (or from a carried state's rng key)."""
    import jax
    key = (jax.random.PRNGKey(seed_or_key)
           if isinstance(seed_or_key, int) else seed_or_key)
    orders = visit_orders_from_keys(round_keys(key, rounds), K, nk, H, kind)
    return lambda t: orders[t]


COMM_RNG_SALT = 0x5EED     # repro/comm/aggregate.py: comm_rng's fold_in salt


def comm_draws_from_keys(keys, kind: str, d: int, slots: int = 0):
    """The draws the reference's compressors take from per-worker keys, as
    the port's explicit inputs: rand-k's `choice(key, d, (slots,),
    replace=False)` index sets (K, slots) or QSGD's `uniform(key, (d,))`
    (K, d) (its `bernoulli` is `uniform < p`)."""
    import jax
    if kind == "randk":
        rows = [np.asarray(jax.random.choice(kk, d, (min(slots, d),),
                                             replace=False)) for kk in keys]
        return torch.as_tensor(np.stack(rows).astype(np.int64))
    if kind == "qsgd":
        rows = [np.asarray(jax.random.uniform(kk, (d,))) for kk in keys]
        return torch.as_tensor(np.stack(rows))
    return None


def reference_comm_draws(seed: int, rounds: int, K: int, d: int, kind: str,
                         slots: int = 0):
    """`solve(comm_draws=...)` hook replaying a reference solve's compressor
    draws: round t, worker k draws from fold_in(fold_in(sub_t, k), salt)
    (repro/core/cocoa.py's `comm_rng` of the worker key)."""
    import jax
    out = []
    for sub in round_keys(jax.random.PRNGKey(seed), rounds):
        keys = [jax.random.fold_in(jax.random.fold_in(sub, k), COMM_RNG_SALT)
                for k in range(K)]
        out.append(comm_draws_from_keys(keys, kind, d, slots))
    return lambda t: out[t]


def dense_block(rng: np.random.Generator, K: int, nk: int, d: int,
                pad_rows: int = 0):
    """(X (K, nk, d), y, alpha, mask) with ||x|| <= 1, labels in {-1, 1},
    feasible hinge duals, and the last `pad_rows` rows of each worker zero
    with mask 0."""
    X = rng.standard_normal((K, nk, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    y = np.where(rng.random((K, nk)) < 0.5, -1.0, 1.0).astype(np.float32)
    alpha = (y * rng.random((K, nk)) * 0.5).astype(np.float32)
    mask = np.ones((K, nk), np.float32)
    if pad_rows:
        X[:, nk - pad_rows:] = 0.0
        mask[:, nk - pad_rows:] = 0.0
        alpha[:, nk - pad_rows:] = 0.0
    return X, y, alpha, mask


def ell_block(rng: np.random.Generator, K: int, nk: int, d: int, r_max: int):
    """Padded-ELL (cols, vals) (K, nk, r_max) with the cases the kernels must
    get right: rows with duplicate column ids, rows with a real column-0
    entry next to (col 0, val 0) padding, and ragged row lengths."""
    nnz = rng.integers(1, r_max + 1, size=(K, nk))
    cols = rng.integers(0, d, size=(K, nk, r_max)).astype(np.int32)
    vals = rng.standard_normal((K, nk, r_max)).astype(np.float32)
    cols[:, 0::3, 1] = cols[:, 0::3, 0]                  # duplicate ids
    cols[:, 1::3, 0] = 0                                 # real column 0
    nnz[:, 1::3] = np.minimum(nnz[:, 1::3], r_max - 1)   # ... next to padding
    nnz[:, 0::3] = np.maximum(nnz[:, 0::3], 2)
    live = np.arange(r_max)[None, None, :] < nnz[..., None]
    cols = np.where(live, cols, 0).astype(np.int32)
    vals = np.where(live, vals, 0.0).astype(np.float32)
    vals /= np.maximum(np.linalg.norm(vals, axis=-1, keepdims=True), 1e-12)
    return cols, vals, nnz.astype(np.int32)


def tree_to_numpy(tree):
    """A reference pytree (dicts, lists, tuples of jax arrays) as the same
    structure of numpy arrays; bfloat16 leaves become float32 (numpy has no
    bfloat16 of torch's), which `params_from_reference` casts back."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def reference_cache_layers(cache, cfg) -> list:
    """A reference decoder cache ({"scan": per-pattern-position caches
    stacked over the periods, "rest": the remainder's}) as one dict of
    numpy arrays per layer, the port's layout."""
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    layers = [None] * cfg.n_layers
    for j, period in enumerate(cache.get("scan", ())):
        for i in range(n_full):
            layers[i * P + j] = {k: np.asarray(v[i])
                                 for k, v in period.items()}
    for i, c in enumerate(cache["rest"]):
        layers[n_full * P + i] = {k: np.asarray(v) for k, v in c.items()}
    return layers


def reference_in_child(code: str, *, devices: int = 4,
                       timeout: int = 600) -> dict:
    """Run reference code in a child process with `devices` forced host
    devices (a mesh the parent's single CPU device cannot give) and return
    the numpy arrays it saves.

    The child starts from the repo root and imports the root `conftest`
    first, so the jax 0.9 shim is in place before `repro` loads. `code`
    fills a dict `out` of arrays; the child saves it as an .npz, which this
    returns as a dict."""
    import os
    import subprocess
    import sys
    import tempfile
    import textwrap

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.npz")
        script = ("import conftest\nimport numpy as np\nout = {}\n"
                  + textwrap.dedent(code)
                  + f"\nnp.savez({path!r}, **out)\n")
        env = dict(os.environ)
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices}")
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src"),
                                             root])
        p = subprocess.run([sys.executable, "-c", script], cwd=root,
                           env=env, capture_output=True, text=True,
                           timeout=timeout)
        if p.returncode != 0:
            raise RuntimeError(f"reference child failed (exit "
                               f"{p.returncode}):\n{p.stderr[-4000:]}")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


# ----------------------------------------------------------------------------
# process meshes: a `launch.mesh.spawn_ranks` target (imports no jax, so a
# spawned rank starts in torch's import time alone)
# ----------------------------------------------------------------------------

def job_data(job: dict):
    """The global (X, y, mask) of a process-mesh job on the CPU: the
    dataset `job["data"]` partitioned over `job["K"]` workers (sparse
    specs as `FeatureShards` when `job["M"]` > 1)."""
    from repro_torch.data import DATASETS, load, partition, partition_sparse
    name, K, M = job["data"], job["K"], job.get("M", 1)
    if DATASETS[name].format == "sparse":
        csr, y = load(name)
        return partition_sparse(csr, y, K, seed=0, M=M, device="cpu")
    X, y = load(name)
    return partition(X, y, K, seed=0, device="cpu")


def job_orders(job: dict):
    """`solve`'s visit_orders hook of a job (None: the port's own draws)."""
    orders = job.get("orders")
    if orders is None:
        return None
    return lambda t: torch.as_tensor(orders[t])


def solve_on_ranks(rank: int, world: int, jobs: list) -> list:
    """Each job's `solve` on a process mesh of `job["shape"]` over
    `job["axes"]`, on `job["device"]` (default the CPU; "cuda:0" puts
    every rank on one card). A job is a dict: `shape`, `axes`, `cfg`
    (CoCoAConfig keywords), `data`, `K`, `M`, `rounds`, `seed`,
    `orders` (per-round numpy visit orders, or None) and, for a deadline
    solver, `budgets` (per-round (K,) step budgets). Returns, per job,
    the history, the rank's state slices (the momentum leaves None where
    the run has none), the measured hops as numpy and the sparse
    dispatch's last launch (`kernels.ops.LAST_SPARSE_CONFIG`),
    or {"error": message} when the mesh or `solve` raised ValueError."""
    torch.set_num_threads(1)
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_process_mesh
    out = []
    for job in jobs:
        X, y, mask = job_data(job)
        ops.LAST_SPARSE_CONFIG = None
        try:
            mesh = make_process_mesh(job["shape"], job["axes"],
                                     device=job.get("device", "cpu"))
            budgets = job.get("budgets")
            r = solve(CoCoAConfig(**job["cfg"]), X, y, mask,
                      rounds=job["rounds"], seed=job.get("seed", 0),
                      visit_orders=job_orders(job), mesh=mesh,
                      budget_fn=None if budgets is None else (
                          lambda t: torch.as_tensor(budgets[t])))
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        res = {k: np.asarray(v) for k, v in r.history.items()}
        res.update(w=to_np(r.state.w), alpha=to_np(r.state.alpha),
                   ef=to_np(r.state.ef), coords=mesh.coords(),
                   measured=dict(r.tracer.measured),
                   sparse_config=ops.LAST_SPARSE_CONFIG)
        for leaf in ("v_prev", "alpha_prev", "accel_a"):
            x = getattr(r.state, leaf)
            res[leaf] = None if x is None else to_np(x)
        out.append(res)
    return out


def cli_on_ranks(rank: int, world: int, argvs: list) -> list:
    """`launch.cocoa_train.main` on each argv in turn on every rank of a
    spawned process group; returns the histories as lists."""
    torch.set_num_threads(1)
    from repro_torch.launch import cocoa_train
    return [{k: list(v) for k, v in cocoa_train.main(argv).items()}
            for argv in argvs]


# ----------------------------------------------------------------------------
# CoCoA-DP (optim.localdp): tests/test_optim.py's two-layer tanh network
# ----------------------------------------------------------------------------

def mlp_problem(K=4, n_per=64, d=8, seed=0):
    """(params, Xs (K, n_per, d), ys (K, n_per, 1)) as numpy, drawn as
    `tests/test_optim.py::_mlp_problem` draws them."""
    rng = np.random.default_rng(seed)
    Xs = rng.standard_normal((K, n_per, d)).astype(np.float32)
    w_star = rng.standard_normal((d, 1)).astype(np.float32)
    ys = (np.tanh(Xs @ w_star) + 0.01 * rng.standard_normal(
        (K, n_per, 1)).astype(np.float32)).astype(np.float32)
    params = {"w1": rng.standard_normal((d, 16)).astype(np.float32) * 0.3,
              "w2": rng.standard_normal((16, 1)).astype(np.float32) * 0.3}
    return params, Xs, ys


def mlp_loss(p, batch):
    """The port's loss of `mlp_problem`: mean squared error of
    tanh(X w1) w2."""
    X, y = batch
    h = torch.tanh(X @ p["w1"])
    return torch.mean((h @ p["w2"] - y) ** 2)


def localdp_on_ranks(rank: int, world: int, params: dict, Xs, ys,
                     cfg: dict, rounds: int) -> dict:
    """`make_round_sharded(mlp_loss, LocalDPConfig(**cfg), mesh)` for
    `rounds` rounds on a (world,) data mesh of CPU ranks; the final params
    as numpy."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.optim.localdp import LocalDPConfig, make_round_sharded
    mesh = make_process_mesh((world,), ("data",), device="cpu")
    rf = make_round_sharded(mlp_loss, LocalDPConfig(**cfg), mesh)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    batches = (torch.from_numpy(Xs), torch.from_numpy(ys))
    for _ in range(rounds):
        p = rf(p, batches)
    return {k: to_np(v) for k, v in p.items()}


# ----------------------------------------------------------------------------
# the sharded LM steps (`launch.train.make_jitted_train_step`,
# `launch.serve.make_jitted_serve_fns`): one job runs on a process mesh or,
# with mesh=None, in one process, on the same weights and inputs
# ----------------------------------------------------------------------------

def lm_batch(cfg, B: int, S: int, seed: int, *, train: bool = True) -> dict:
    """A batch from `seed`: tokens and labels (B, S); an embeddings
    model's embeds (B, S, d) and, under M-RoPE, (3, B, S) positions
    (temporal, height, width streams); an encoder-decoder's frames
    (B, S, d) and S decoder tokens. Without `train`, the prefill inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.is_encdec():
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        if not train:
            out = {"frames": out["frames"]}
    elif cfg.input_mode == "embeddings":
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        out.pop("tokens")
    if cfg.mrope_sections is not None:
        t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        out["positions"] = np.stack([t, t // 2, t % 4])
    if not train:
        out.pop("labels", None)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def _lm_cache_arrays(cache, full) -> dict:
    if isinstance(cache, dict):
        return {f"{part}.{k}": to_np(full(v)) for part, leaves in cache.items()
                for k, v in leaves.items()}
    return {f"{i}.{k}": to_np(full(v)) for i, layer in enumerate(cache)
            for k, v in layer.items()}


def lm_job(job: dict, mesh=None) -> dict:
    """Train, score, prefill and decode one smoke config as `job` says,
    sharded on `mesh` (a process mesh) or in one process (None); the
    results as numpy (whole tensors). job keys: arch; cfg (overrides of
    `smoke_config`); B, S; steps (train steps); ref_state (weights by
    `reference_state` name, else `init_params` seed 0); serve_cfg and mode
    (the serving config's overrides and the serve mode), S_max (cache
    length, the frame count of an encoder-decoder), decode (steps,
    teacher-forced); score_cfg (a scoring forward under no_grad);
    run_training (steps of `launch.train.run_training`); checks (on a
    mesh: `shard_state` / `gather_state` round trip, the kernels refuse a
    DTensor, a further step updates the model and the AdamW state it was
    given in place)."""
    import dataclasses
    import functools
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as SV
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    full = Sh.full
    base = smoke_config(job["arch"])
    cfg = dataclasses.replace(base, **job.get("cfg", {}))
    B, S = job["B"], job["S"]
    out = {}

    def fresh(c, state=None):
        model = M.init_params(c, seed=0, device="cpu")
        if state is not None:
            model.load_state_dict({k: torch.as_tensor(v)
                                   for k, v in state.items()})
        if mesh is not None:
            specs = Sh.param_specs(model, c, mesh, "train")
            local = Sh.shard_state(state if state is not None
                                   else model.state_dict(), specs, mesh)
            Sh.place_model(model, specs, mesh, local_state=local,
                           layout=Sh.layout_for(mesh, "train"))
        return model

    def params_of(model):
        # copies: a replicated leaf's whole value is the param itself
        return {k: to_np(v).copy() for k, v in Sh.gather_state(
            dict(model.named_parameters())).items()}

    if job.get("steps"):
        model = fresh(cfg, job.get("ref_state"))
        opt = T.init_opt(model)
        step = (T.make_jitted_train_step(cfg, mesh) if mesh is not None
                else functools.partial(T.train_step, cfg=cfg))
        for s in range(job["steps"]):
            model, opt, m = step(model, opt, lm_batch(cfg, B, S, s))
            out[f"loss{s}"] = to_np(m["loss"])
            out[f"grad_norm{s}"] = to_np(m["grad_norm"])
            if s == 0:          # the grads stay on the params until the next
                out["grads"] = {k: to_np(v) for k, v in Sh.gather_state(
                    {n: p.grad for n, p in model.named_parameters()
                     if p.grad is not None}).items()}
        out["params"] = params_of(model)
        if mesh is not None and job.get("checks"):
            init = M.init_params(cfg, seed=0, device="cpu").state_dict()
            specs = Sh.param_specs(init, cfg, mesh, "train")
            back = Sh.gather_state(Sh.shard_state(init, specs, mesh), specs,
                                   mesh)
            out["state_round_trip"] = all(
                torch.equal(back[k], init[k]) for k in init)
            out["kernels_refuse_dtensors"] = _kernels_refuse_dtensors(mesh)
            kept, masters = params_of(model), dict(opt.master)
            got_model, got_opt, _ = step(model, opt, lm_batch(cfg, B, S, 99))
            now = params_of(model)
            out["updated_in_place"] = (
                got_model is model
                and all(got_opt.master[k] is t for k, t in masters.items())
                and any(not np.array_equal(kept[k], now[k]) for k in kept))

    if job.get("run_training"):
        from repro_torch.data.tokens import TokenStream
        model, _, m = T.run_training(
            cfg, mesh, iter(TokenStream(cfg.vocab, B, S, seed=3)),
            steps=job["run_training"], log_every=10 ** 9, device="cpu")
        out["run_training_loss"] = to_np(m["loss"])
        out["run_training_params"] = params_of(model)

    if job.get("score_cfg") is not None:
        c = dataclasses.replace(cfg, **job["score_cfg"])
        model = fresh(c)
        batch = lm_batch(c, B, S, 50)
        with torch.no_grad():
            if mesh is None:
                loss, _ = M.forward_train(model, batch, c)
            else:
                batch = Sh.place_tree(batch, Sh.batch_specs(
                    batch, c, mesh, "train"), mesh,
                    Sh.layout_for(mesh, "train"))
                with Sh.installed(c, mesh, "train", gather=True):
                    loss, _ = M.forward_train(model, batch, c)
        out["score"] = to_np(full(loss))

    if job.get("decode") is not None:
        c = dataclasses.replace(cfg, **job.get("serve_cfg", {}))
        model = fresh(c)
        cache = M.init_cache(c, B, job["S_max"], device="cpu")
        batch = lm_batch(c, B, S, 100, train=False)
        if mesh is None:
            prefill = functools.partial(SV.prefill_step, cfg=c)
            decode = functools.partial(SV.serve_step, cfg=c)
        else:
            pre, dec = SV.make_jitted_serve_fns(c, mesh, job["mode"])
            prefill, decode = pre(cache, batch), dec(cache)
        logits, cache = prefill(model, batch, cache)
        out["prefill_logits"] = to_np(logits)
        toks = torch.from_numpy(np.random.default_rng(101).integers(
            0, c.vocab, (B, job["decode"])).astype(np.int32))
        pos0 = 0 if c.is_encdec() else S
        nxt = []
        for i in range(job["decode"]):
            n, cache = decode(model, cache, toks[:, i:i + 1], pos0 + i)
            nxt.append(to_np(n))
        out["next_tokens"] = np.concatenate(nxt, axis=1)
        out["cache"] = _lm_cache_arrays(cache, full)
    return out


def _kernels_refuse_dtensors(mesh) -> bool:
    """Both LM kernels' wrappers raise TypeError on DTensors (which must
    reach them as local shards) rather than run their plain versions."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch import sharding as Sh

    def dt(*shape):
        return Sh.from_local(torch.zeros(shape), mesh, Sh.P())
    calls = [lambda: flash_attention(*(dt(1, 4, 2, 32) for _ in range(3))),
             lambda: ssm_scan(dt(1, 4, 8), dt(1, 4, 8), dt(1, 4, 2),
                              dt(1, 4, 2), dt(8, 2), dt(8))]
    for call in calls:
        try:
            call()
        except TypeError as e:
            if "DTensor" not in str(e):
                return False
        else:
            return False
    return True


def lm_jobs_on_ranks(rank: int, world: int, jobs: list, shape, axes):
    """Every job of `jobs` (`lm_job`) on a `shape` process mesh of CPU
    ranks; rank 0 returns {job name: results}, the others None."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh(tuple(shape), tuple(axes), device="cpu")
    out = {job["name"]: lm_job(job, mesh) for job in jobs}
    return out if rank == 0 else None


# ----------------------------------------------------------------------------
# the expert-parallel MoE (`models.layers._moe_forward_shardmap`) and the
# dry run's tally (`launch.dryrun`): spawned targets
# ----------------------------------------------------------------------------

def moe_params(arrays: dict, cfg):
    """A port MoE weight group from the reference's `init_moe` arrays
    ({"router", "wi", "wg", "wo", "shared": {"wi", "wg", "wo"}})."""
    from repro_torch.models import layers as L
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    p = {k: t(arrays[k]) for k in ("router", "wi", "wg", "wo")}
    if "shared" in arrays:
        p["shared"] = L.Params(**{k: t(v)
                                  for k, v in arrays["shared"].items()})
    return L.Params(**p)


def moe_ep_job(job: dict, mesh=None) -> dict:
    """`layers.moe_forward` of smoke llama4-scout at `job["cf"]` on the
    reference's weights `job["params"]` and tokens `job["x"]`: on `mesh`
    expert-parallel (dp "data", tp "model", fsdp "data",
    `job["gather"]`), else portable in `job["groups"]` groups. The whole
    (out, aux) as numpy."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.launch import sharding as Sh
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(smoke_config("llama4-scout-17b-a16e"),
                              capacity_factor=job["cf"])
    p = moe_params(job["params"], cfg)
    x = torch.from_numpy(job["x"])
    try:
        if mesh is None:
            L.set_moe_ctx(groups=job.get("groups", 1))
            with torch.no_grad():
                out, aux = L.moe_forward(p, x, cfg, cfg.d_ff)
            return {"out": to_np(out), "aux": to_np(aux)}
        from torch.distributed.tensor.experimental import \
            implicit_replication
        layout = Sh.layout_for(mesh, "serve")
        Sh.place_model(p, Sh.param_specs(p, cfg, mesh, "serve"), mesh,
                       layout=layout)
        x = Sh.place(x, mesh, Sh.P("data", None, None), layout)
        L.set_moe_ctx(mesh=mesh, dp="data", tp="model", fsdp="data",
                      gather_weights=job["gather"])
        with torch.no_grad(), implicit_replication():
            out, aux = L.moe_forward(p, x, cfg, cfg.d_ff)
        return {"out": to_np(Sh.full(out)), "aux": to_np(Sh.full(aux))}
    finally:
        L.set_moe_ctx()


def _group_mean_aux(prob, eid, E):
    """The load-balance aux as the expert-parallel step takes it: each
    dispatch group's E · Σ_e mean(prob)_e · mean(onehot)_e, averaged over
    the groups (the reference's pmean over the data shards), where the
    portable dispatch takes the means over all groups' tokens."""
    import torch.nn.functional as F
    G = prob.shape[0] if prob.dim() == 3 else 1
    prob = prob.reshape(G, -1, E)
    onehot = F.one_hot(eid.reshape(G, -1), E).float()
    return E * torch.mean(torch.sum(prob.mean(1) * onehot.mean(1), -1))


def moe_train_job(job: dict, mesh=None) -> dict:
    """One `train_step` of smoke llama4-scout (seed-0 weights, the batch
    of `lm_batch(cfg, B, S, 0)`): on `mesh` through
    `make_jitted_train_step` with the expert-parallel MoE as the dry run
    sets it, else in one process with the portable dispatch in
    `job["groups"]` groups and the aux averaged over the groups
    (`_group_mean_aux`), the twin of the sharded step. Loss, xent, aux,
    grad norm and the whole grads."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import train as T
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = dataclasses.replace(smoke_config("llama4-scout-17b-a16e"),
                              **job.get("cfg", {}))
    model = M.init_params(cfg, seed=0, device="cpu")
    batch = lm_batch(cfg, job["B"], job["S"], 0)
    pooled = L._aux
    try:
        if mesh is None:
            L.set_moe_ctx(groups=job["groups"])
            L._aux = _group_mean_aux
            _, _, m = T.train_step(model, T.init_opt(model), batch,
                                     cfg=cfg)
        else:
            specs = Sh.param_specs(model, cfg, mesh, "train")
            Sh.place_model(model, specs, mesh,
                           layout=Sh.layout_for(mesh, "train"))
            L.set_moe_ctx(**DR.moe_ctx_for(cfg, mesh, "train", True))
            step = T.make_jitted_train_step(cfg, mesh)
            _, _, m = step(model, T.init_opt(model), batch)
    finally:
        L.set_moe_ctx()
        L._aux = pooled
    grads = Sh.gather_state({n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None})
    out = {k: to_np(v) for k, v in m.items()}
    out["grads"] = {k: to_np(v) for k, v in grads.items()}
    return out


def moe_ep_on_ranks(rank: int, world: int, jobs: list, shape, axes,
                    train_jobs=()):
    """Every job of `jobs` (`moe_ep_job`) and `train_jobs`
    (`moe_train_job`) on a `shape` process mesh of CPU ranks; rank 0
    returns the lists of results, the others None."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh(tuple(shape), tuple(axes), device="cpu")
    out = ([moe_ep_job(j, mesh) for j in jobs],
           [moe_train_job(j, mesh) for j in train_jobs])
    return out if rank == 0 else None


def step_tally_job(job: dict, mesh) -> dict:
    """The collectives (`comm.collectives.tally_since`) of one step of a
    smoke config on `mesh`, a real process mesh or a fake world, through
    `launch.dryrun.prepare_step` as the dry run runs it: job keys arch,
    kind (train / prefill / decode), B, S. On a real mesh the inputs are
    the seed-0 weights and `lm_batch`'s; on a fake world their "meta"
    stand-ins; job["mode"] (default: train or serve by the kind) picks
    serve_long. Returns {"tally": {"kind/g/routed": [count, result bytes,
    bytes handed]}}."""
    from repro_torch.comm import collectives as col
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as T
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = smoke_config(job["arch"])
    kind, B, S = job["kind"], job["B"], job["S"]
    mode = job.get("mode", "train" if kind == "train" else "serve")
    if mesh.device.type == "meta":
        args = DR.step_inputs(cfg, kind, B, S)
    else:
        model = M.init_params(cfg, seed=0, device="cpu")
        if kind == "train":
            args = (model, T.init_opt(model), lm_batch(cfg, B, S, 0))
        elif kind == "prefill":
            args = (model, lm_batch(cfg, B, S, 0, train=False),
                    M.init_cache(cfg, B, S, device="cpu"))
        else:
            args = (model, M.init_cache(cfg, B, S, device="cpu"),
                    torch.zeros((B, 1), dtype=torch.int32), None)
    L.set_moe_ctx(**DR.moe_ctx_for(cfg, mesh, mode, kind != "decode"))
    try:
        step, step_args, _ = DR.prepare_step(kind, cfg, mesh, mode, args)
        snap = col.tally()
        step(*step_args)
        rec = col.tally_since(snap)
    finally:
        L.set_moe_ctx()
    return {"tally": {f"{k}/{g}/{int(r)}": list(v)
                      for (k, g, r), v in sorted(rec.items())}}


def step_tally_on_ranks(rank: int, world: int, jobs: list, shape, axes):
    """`step_tally_job` for every job on a `shape` process mesh of CPU
    ranks; every rank returns its tallies."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh(tuple(shape), tuple(axes), device="cpu")
    return [step_tally_job(j, mesh) for j in jobs]


# ----------------------------------------------------------------------------
# decode over a sequence-sharded cache (`models.shards.decode_over_shards`,
# serve_long): spawned targets and their one-process twins
# ----------------------------------------------------------------------------

def _long_case_arrays(case: dict):
    """q (B,1,H,hd), k and v (B,S,KV,hd) and one cache row (B,1,KV,hd)
    from the case's seed."""
    rng = np.random.default_rng(case["seed"])
    B, S, KV, H, hd = (case[k] for k in ("B", "S", "KV", "H", "hd"))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    row = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (q, k, v, row))


def long_case_plain(case: dict) -> dict:
    """One process: `decode_attention` (`decode_attention_ring` on a ring)
    over the whole cache, and the cache with the row written at
    case["write"]."""
    from repro_torch.models import layers as L
    q, k, v, row = _long_case_arrays(case)
    if case["ring"]:
        out = L.decode_attention_ring(q, k, v, case["pos"],
                                      window=case["S"],
                                      softcap=case.get("softcap"))
    else:
        out = L.decode_attention(q, k, v, case["pos"],
                                 window=case.get("window"),
                                 softcap=case.get("softcap"))
    k[:, case["write"]:case["write"] + 1] = row
    return {"out": to_np(out), "written": to_np(k)}


def long_case_sharded(case: dict, mesh) -> dict:
    """The same on `mesh`: the cache placed by case["spec"] (a
    `launch.sharding.P` as a tuple), q with its heads over "model" as
    `attn_qkv` makes it, `decode_over_shards` and `write_rows`; the whole
    results."""
    import functools
    from repro_torch.launch import sharding as Sh
    from repro_torch.models import layers as L
    from repro_torch.models import shards
    q, k, v, row = _long_case_arrays(case)
    spec = Sh.P(*case["spec"])
    kd, vd = Sh.place(k, mesh, spec), Sh.place(v, mesh, spec)
    qd = Sh.place(q, mesh, Sh.P(None, None, "model", None))
    valid = functools.partial(L.decode_valid, case["pos"], length=case["S"],
                              window=case.get("window"), ring=case["ring"])
    with torch.no_grad():
        out = shards.decode_over_shards(qd, kd, vd, valid,
                                        softcap=case.get("softcap"))
        shards.write_rows(kd, Sh.place(row, mesh, Sh.P()), case["write"])
    return {"out": to_np(Sh.full(out)), "written": to_np(Sh.full(kd))}


def long_decode_job(job: dict, mesh=None) -> dict:
    """Decode steps of a smoke config in serve_long's layout (`mesh`, a
    process mesh) or in one process (None), over a cache filled from the
    seed: job keys arch, B, S_max, positions (one step each). Returns the
    logits of every step (n, B, 1, V) and the whole cache after."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import sharding as Sh
    from repro_torch.models import model as M
    cfg = smoke_config(job["arch"])
    B, positions = job["B"], job["positions"]
    model = M.init_params(cfg, seed=0, device="cpu")
    cache = M.init_cache(cfg, B, job["S_max"], device="cpu")
    rng = np.random.default_rng(7)
    for layer in cache:
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                     .astype(np.float32)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, len(positions)))
                            .astype(np.int32))
    if mesh is not None:
        mode = "serve_long"
        layout = Sh.layout_for(mesh, mode)
        Sh.place_model(model, Sh.param_specs(model, cfg, mesh, mode), mesh,
                       layout=layout)
        cache = Sh.place_tree(cache, Sh.cache_specs(cache, cfg, mesh, mode),
                              mesh, layout)
    logits = []
    for i, pos in enumerate(positions):
        tok = toks[:, i:i + 1]
        if mesh is None:
            with torch.inference_mode():
                lg, cache = M.decode_step(model, cache, tok, pos, cfg)
        else:
            tok = Sh.place_tree({"tokens": tok}, Sh.batch_specs(
                {"tokens": tok}, cfg, mesh, mode), mesh, layout)["tokens"]
            with Sh.installed(cfg, mesh, mode, gather=False), \
                    torch.no_grad():
                lg, cache = M.decode_step(model, cache, tok, pos, cfg)
        logits.append(to_np(Sh.full(lg)))
    return {"logits": np.stack(logits),
            "cache": _lm_cache_arrays(cache, Sh.full)}


def long_decode_on_ranks(rank: int, world: int, cases: list, jobs: list,
                         shape, axes):
    """`long_case_sharded` for every case and `long_decode_job` for every
    job on a `shape` process mesh of CPU ranks; rank 0 returns them."""
    torch.set_num_threads(1)
    from repro_torch.comm import collectives as col
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh(tuple(shape), tuple(axes), device="cpu")
    out = {"cases": [long_case_sharded(c, mesh) for c in cases], "jobs": {}}
    for job in jobs:
        snap = col.tally()
        out["jobs"][job["arch"]] = long_decode_job(job, mesh)
        out["jobs"][job["arch"]]["handed"] = col.tally_bytes(
            col.tally_since(snap))
    return out if rank == 0 else None
