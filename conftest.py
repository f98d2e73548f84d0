"""Repo-root pytest hooks: make the JAX reference package importable on jax 0.9.

`src/repro/core/solvers.py:86` guards its vmap rule for
`optimization_barrier` with `prim in batching.primitive_batchers`. On jax
0.9 that object is a `PrimitiveBatchersProxy` with `__setitem__` but no
`__contains__`, so `import repro.core` raises `TypeError`, and every module
reaching it (the kernels, the CoCoA driver, the PyTorch port's parity tests)
fails to import. jax 0.9 already ships a batching rule for the barrier, so
answering "present" for every key is exact: the guard then skips
installing its own rule, which is all it was there to do.

The JAX package itself stays untouched. The shim runs here, before any test
module imports `repro`. Child processes that tests spawn load no conftest
and still hit the import error.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _install_batchers_contains_shim():
    try:
        from jax.interpreters import batching
    except ImportError:          # no jax: the reference tests cannot run anyway
        return
    proxy_cls = type(batching.primitive_batchers)
    if not hasattr(proxy_cls, "__contains__"):
        proxy_cls.__contains__ = lambda self, key: True


_install_batchers_contains_shim()
