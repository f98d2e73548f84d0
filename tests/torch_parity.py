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
    the run has none) and the measured hops as numpy,
    or {"error": message} when the mesh or `solve` raised ValueError."""
    torch.set_num_threads(1)
    from repro_torch.core import CoCoAConfig, solve
    from repro_torch.launch.mesh import make_process_mesh
    out = []
    for job in jobs:
        X, y, mask = job_data(job)
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
                   measured=dict(r.tracer.measured))
        for leaf in ("v_prev", "alpha_prev", "accel_a"):
            x = getattr(r.state, leaf)
            res[leaf] = None if x is None else to_np(x)
        out.append(res)
    return out
