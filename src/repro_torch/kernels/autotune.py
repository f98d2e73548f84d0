"""The sparse SDCA kernel's launch configuration: explicit > cache > default.

Port of `repro.kernels.autotune` (schema v3). The cache maps (kernel,
backend, d, r_max, density, reg family, model_shards) to a winning config
{"block_rows", "buffer_depth"}; the dispatch in `kernels.ops` consults it
when the caller leaves a knob unset. Removing the file changes speed, never
results: every knob keeps the visit order.

What the knobs mean here:

    buffer_depth  the 1-D kernel's ring (csrc/sparse_sdca_pipelined.cu):
                  1 fetches each row in its own step, >= 2 prefetches the
                  next rows. On a cache miss 4 on the card, where it was
                  the fastest depth measured (PERF.md), and the
                  reference's 1 elsewhere, where no kernel runs
    block_rows    the z-exchange schedule's block (its staleness window and
                  its exchange size); the 1-D kernel walks row by row
                  through the visit permutation and only records it

The reference's third knob, `slot_unroll`, unrolls a TPU loop over a row's
slots; the port's kernels give each slot a thread, so it has no
counterpart, and a cache entry's `slot_unroll` is ignored.

The backend key is the device type ("cuda" / "cpu"). The cache file is the
port's own, `kernels/autotune_cache.json` beside this module; the
environment variable `REPRO_TORCH_AUTOTUNE_CACHE` names another (call
`reset_cache()` after changing it). The sweep that fills the cache is a
benchmark's and is not ported yet.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Dict, List, Optional

AUTOTUNE_SCHEMA_VERSION = 3
# v1 entries read with buffer_depth=1; v1/v2 with reg="l2", model_shards=1
_READABLE_SCHEMAS = (1, 2, 3)

_DEFAULT_PATH = pathlib.Path(__file__).with_name("autotune_cache.json")
ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"

# knob defaults used on a cache miss
DEFAULT_CONFIG = {"block_rows": 128, "buffer_depth": 1}

# cache-miss ring on the card (PERF.md, the 1-D kernel's depths)
CUDA_DEFAULT_BUFFER_DEPTH = 4

# cache-miss block for the M > 1 z-exchange schedule: block_rows is its
# staleness window, so it starts an order of magnitude below the default
ZX_DEFAULT_BLOCK_ROWS = 16

_CONFIG_KEYS = tuple(sorted(DEFAULT_CONFIG))


def cache_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(ENV_VAR, str(_DEFAULT_PATH)))


class AutotuneCache:
    """JSON-persisted map (kernel, backend, d, r_max, density, reg,
    model_shards) -> config. `lookup` returns a copy of the winning config
    or None. A missing or corrupt file reads as empty."""

    def __init__(self, path: Optional[pathlib.Path] = None):
        self.path = pathlib.Path(path) if path is not None else cache_path()
        self._entries: Optional[List[Dict]] = None

    def _load(self) -> List[Dict]:
        if self._entries is not None:
            return self._entries
        self._entries = []
        try:
            payload = json.loads(self.path.read_text())
            if payload.get("schema") in _READABLE_SCHEMAS:
                self._entries = list(payload.get("entries", []))
                for e in self._entries:
                    e.setdefault("config", {}).setdefault("buffer_depth", 1)
                    e.setdefault("reg", "l2")
                    e.setdefault("model_shards", 1)
        except (OSError, ValueError):
            pass
        return self._entries

    def _save(self) -> None:
        payload = {"schema": AUTOTUNE_SCHEMA_VERSION,
                   "entries": self._entries or []}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(payload, indent=1) + "\n")

    @staticmethod
    def _key(kernel: str, backend: str, d: int, r_max: int,
             density: float, reg: str = "l2", model_shards: int = 1) -> tuple:
        return (kernel, backend, int(d), int(r_max),
                round(float(density), 6), str(reg), int(model_shards))

    def record(self, kernel: str, backend: str, *, d: int, r_max: int,
               density: float, config: Dict, wall_s: float,
               reg: str = "l2", model_shards: int = 1) -> Dict:
        """Insert or replace the winner for one shape and persist."""
        entry = {
            "kernel": kernel, "backend": backend, "d": int(d),
            "r_max": int(r_max), "density": round(float(density), 6),
            "reg": str(reg), "model_shards": int(model_shards),
            "config": {k: int(config.get(k, DEFAULT_CONFIG[k]))
                       for k in _CONFIG_KEYS},
            "wall_s": float(wall_s),
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        key = self._key(kernel, backend, d, r_max, density, reg,
                        model_shards)
        self._entries = [e for e in self._load()
                         if self._key(e["kernel"], e["backend"], e["d"],
                                      e["r_max"], e["density"], e["reg"],
                                      e["model_shards"]) != key]
        self._entries.append(entry)
        self._save()
        return entry

    def lookup(self, kernel: str, backend: str, *, d: int, r_max: int,
               density: Optional[float] = None, reg: str = "l2",
               model_shards: int = 1) -> Optional[Dict]:
        """Exact match on (kernel, backend, d, r_max, reg, model_shards);
        among those the entry whose density is closest to `density`
        (default the ELL upper bound r_max / d)."""
        if density is None:
            density = r_max / max(d, 1)
        best, best_gap = None, float("inf")
        for e in self._load():
            if (e["kernel"], e["backend"], e["d"], e["r_max"], e["reg"],
                    e["model_shards"]) != (kernel, backend, int(d),
                                           int(r_max), str(reg),
                                           int(model_shards)):
                continue
            gap = abs(e["density"] - density)
            if gap < best_gap:
                best, best_gap = e, gap
        return dict(best["config"]) if best else None

    def entries(self) -> List[Dict]:
        return [dict(e) for e in self._load()]


_CACHE: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    """The process-wide cache (its path resolved at first use)."""
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache()
    return _CACHE


def reset_cache() -> None:
    """Drop the process-wide cache so the next lookup re-reads the path."""
    global _CACHE
    _CACHE = None


def resolve_sparse_config(*, d: int, r_max: int,
                          block_rows: Optional[int],
                          buffer_depth: Optional[int] = None,
                          backend: str,
                          reg_family: str = "l2",
                          model_shards: int = 1) -> Dict:
    """{"block_rows", "buffer_depth", "source"}: each knob from its
    explicit value, else the cache entry, else the default (with
    `ZX_DEFAULT_BLOCK_ROWS` at model_shards > 1 and
    `CUDA_DEFAULT_BUFFER_DEPTH` on "cuda"). `source` is "explicit",
    "cache", "default", "explicit+cache" or "explicit+default", with the
    reference's strings."""
    explicit = {k: v for k, v in (("block_rows", block_rows),
                                  ("buffer_depth", buffer_depth))
                if v is not None}
    if len(explicit) == len(DEFAULT_CONFIG):
        base, source = {}, "explicit"
    else:
        hit = get_cache().lookup("sparse_sdca", backend, d=d, r_max=r_max,
                                 reg=reg_family, model_shards=model_shards)
        if hit:
            base = {k: hit[k] for k in _CONFIG_KEYS}
        else:
            base = dict(DEFAULT_CONFIG)
            if int(model_shards) > 1:
                base["block_rows"] = ZX_DEFAULT_BLOCK_ROWS
            if backend == "cuda":
                base["buffer_depth"] = CUDA_DEFAULT_BUFFER_DEPTH
        filled = "cache" if hit else "default"
        source = f"explicit+{filled}" if explicit else filled
    base.update({k: int(v) for k, v in explicit.items()})
    base["source"] = source
    return base
