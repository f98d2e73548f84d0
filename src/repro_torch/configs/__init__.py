"""Architecture registry (`repro.configs` counterpart): every arch's exact
config plus the reduced smoke variants for CPU tests.

Usage: get_config("gemma2-27b"), smoke_config("recurrentgemma-9b"), ARCHS.
"paper-svm" is the paper's CoCoA+ workload, a `CoCoAWorkload`, not a
model: `get_config` returns it, and ARCHS leaves it out.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import Block, ModelConfig  # noqa: F401  (re-export)

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma3-27b": "gemma3_27b",
    "gemma-7b": "gemma_7b",
    "gemma2-27b": "gemma2_27b",
    "stablelm-1.6b": "stablelm_1_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "llama4-scout-17b-a16e": "llama4_scout",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "whisper-large-v3": "whisper_large_v3",
    # the paper's own workload (convex ERM / CoCoA+) lives in paper_svm.py
    "paper-svm": "paper_svm",
}

ARCHS = tuple(k for k in _MODULES if k != "paper-svm")


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers, small vocab --
    runs a real forward step on CPU in seconds."""
    cfg = get_config(name)
    P = len(cfg.pattern)
    n_layers = P + 1 if P > 1 else 2      # 1 full period + 1 remainder block
    pattern = tuple(
        dataclasses.replace(
            b,
            window=min(b.window, 32) if b.window else b.window,
            d_ff=96 if b.d_ff is not None else None)
        for b in cfg.pattern)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        pattern=pattern,
        d_model=64,
        n_heads=4 if cfg.n_heads else cfg.n_heads,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv else cfg.n_kv,
        head_dim=16 if cfg.head_dim else cfg.head_dim,
        d_ff=128,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        d_inner=128 if cfg.d_inner else 0,
        dt_rank=8 if cfg.dt_rank else 0,
        lru_width=64 if cfg.lru_width else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        dec_layers=2 if cfg.dec_layers else 0,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
        q_chunk=32,
        loss_chunk=32,
        seq_chunk=32,
        dtype="float32",
        remat=False,
    )
