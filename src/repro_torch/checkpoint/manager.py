"""Checkpointing: npz + JSON manifest, async writer. Port of
`repro.checkpoint.manager`, in the reference's on-disk format, so either
package restores the other's checkpoints.

Layout per step:
    <dir>/step_<N>/manifest.json     keys, shapes, dtypes, the caller's extra
    <dir>/step_<N>/host0.npz         flat {path: array}

A step is written under `<dir>/.tmp_step_<N>` and published with one
rename. The flat keys are the reference's `jax.tree_util` paths: nested
dicts (keys sorted, as jax flattens them), lists, tuples and NamedTuples
of tensors, joined with "/" -- `{"w": ., "b": [., .]}` gives "w", "b/0",
"b/1" -- and None leaves are skipped. A leaf is stored as numpy after a
copy to the host; bfloat16 and the float8 types, which npz cannot hold,
as their uint16 / uint8 bits with the dtype's name in the manifest (the
reference's `_to_storable`).

Restore reads only the keys the template holds (extra keys in the file
are ignored), so a template without a leaf reads an older checkpoint
and a leaf the file lacks raises KeyError.
"""
from __future__ import annotations

import json
import pathlib
import queue
import shutil
import threading
from typing import Optional

import numpy as np
import torch

# dtypes npz cannot hold: stored as unsigned bits of the same width
_BITS = {torch.bfloat16: (torch.int16, np.uint16),
         torch.float8_e4m3fn: (torch.int8, np.uint8),
         torch.float8_e5m2: (torch.int8, np.uint8)}
_BY_NAME = {str(dt).replace("torch.", ""): dt for dt in _BITS}


class _Host:
    """A leaf already copied to the host: its storable array and dtype
    name (the async writer's snapshot)."""
    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        self.array, self.dtype = array, dtype


def _to_storable(leaf):
    """(numpy array, dtype name) of a tensor, numpy array or scalar."""
    if isinstance(leaf, _Host):
        return leaf.array, leaf.dtype
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: the snapshot must not follow later
        # in-place writes to the leaf
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _BITS:
            signed, unsigned = _BITS[t.dtype]
            return (t.view(signed).numpy().view(unsigned),
                    str(t.dtype).replace("torch.", ""))
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, a.dtype.name


def _from_storable(a: np.ndarray, name: str) -> torch.Tensor:
    if name in _BY_NAME:
        signed = np.dtype(f"int{a.dtype.itemsize * 8}")
        return torch.from_numpy(np.array(a).view(signed)).view(_BY_NAME[name])
    return torch.from_numpy(np.array(a))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, prefix=()):
    """(path, leaf) pairs in jax's flattening order; None is no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _walk(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _flatten(tree) -> dict:
    return dict(_walk(tree))


def _rebuild(tree, leaf_of, prefix=()):
    """`tree`'s structure with every leaf replaced by leaf_of(path, leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_of, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, k), leaf_of,
                                     prefix + (k,)) for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_of, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaf_of("/".join(prefix), tree)


def _structure(tree) -> str:
    """A readable outline of the tree for the manifest (jax writes its
    treedef's repr there; neither package reads it back)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{k}={_structure(getattr(tree, k))}" for k in tree._fields) + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _host_tree(tree):
    """`tree` with every leaf as its storable numpy array and dtype name:
    the snapshot a save writes."""
    return _rebuild(tree, lambda _, leaf: _Host(*_to_storable(leaf)))


def _steps(path: pathlib.Path):
    return sorted(int(p.name.split("_")[1]) for p in path.glob("step_*"))


def save_tree(path, step: int, tree, extra: Optional[dict] = None
              ) -> pathlib.Path:
    """Write `tree` as `<path>/step_<step>` and return that directory. The
    leaves are copied to the host first (a synchronize of their card)."""
    path = pathlib.Path(path)
    tmp = path / f".tmp_step_{step}"
    final = path / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, leaf in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_storable(leaf)
    np.savez(tmp / "host0.npz", **arrays)
    manifest = {
        "step": step,
        "treedef": _structure(tree),
        "keys": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                 for k, a in arrays.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic publish
    return final


def restore_tree(path, like, step: Optional[int] = None, device=None):
    """Restore into the structure of `like` (nested dicts, lists, tuples
    and NamedTuples whose leaves are tensors or placeholders). Each leaf
    lands on `device`; without one, on the device of `like`'s tensor
    there (the CPU for a placeholder). `step` None: the newest. Returns
    (tree, manifest)."""
    path = pathlib.Path(path)
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    d = path / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "host0.npz") as data:
        def leaf_of(key, leaf):
            t = _from_storable(data[key], manifest["keys"][key]["dtype"])
            to = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            return t.to(to)

        tree = _rebuild(like, leaf_of)
    return tree, manifest


class CheckpointManager:
    """Async, retention-limited checkpointer: keeps the newest `keep`
    steps. With `async_write` a daemon thread writes; `save` copies the
    snapshot to the host on the caller's thread first (a synchronize of
    the card the leaves live on, so the snapshot is the state as of the
    call) and blocks only while two snapshots already wait."""

    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = None
        self._error: Optional[Exception] = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_tree(self.dir, step, host_tree, extra)
                self._gc()
            except Exception as e:     # raised again by wait()
                self._error = self._error or e
            finally:
                self._q.task_done()

    def _gc(self):
        for s in _steps(self.dir)[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        if self.async_write:
            self._q.put((step, _host_tree(tree), extra))
        else:
            save_tree(self.dir, step, tree, extra)
            self._gc()

    def wait(self) -> None:
        """Block until every queued snapshot is on disk; raises the first
        error the writer met."""
        if self.async_write:
            self._q.join()
        if self._error is not None:
            raise RuntimeError(f"checkpoint write failed under "
                               f"{self.dir}") from self._error

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.dir)
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None, device=None):
        return restore_tree(self.dir, like, step, device)
