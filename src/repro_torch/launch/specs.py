"""Shape-only stand-ins for every (architecture x input-shape) cell
(`repro.launch.specs` counterpart): tensors on the "meta" device, which
carry shapes and dtypes and no values, in place of `ShapeDtypeStruct`s.

Shapes (assignment sheet):
    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill (fills KV cache)
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524,288 global_batch 1     -> serve_step, sub-quadratic
                 archs only (skips recorded, never silent)

[vlm]/[audio] cells feed precomputed patch/frame embeddings (frontend stub);
whisper decode cells = self-KV over its 448-token decoder context + cross-KV
over seq_len frames.

No analogue here: nothing. The sharding specs the reference lowers these
cells with are ported (`launch/sharding.py`); lowering the cells on the
256- and 512-rank production meshes (the reference's `launch/dryrun.py`)
is not (ROADMAP.md Queue 1 item 13f).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs import get_config
from ..models import model as M
from ..models.config import ModelConfig
from .train import init_opt

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode_long"),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    kind: str          # train | prefill | decode | decode_long
    skip: Optional[str] = None   # reason, if the cell is skipped


def cell_for(arch: str, shape: str) -> Cell:
    cfg = get_config(arch)
    info = SHAPES[shape]
    kind = info["kind"]
    skip = None
    pure_full_attn = all(b.mixer == "attn" and b.window is None
                         for b in cfg.pattern)
    if shape == "long_500k" and pure_full_attn:
        skip = ("pure full-attention config: 500k decode needs sub-quadratic "
                "attention (assignment skip rule; see DESIGN.md)")
    if shape == "long_500k" and cfg.is_encdec():
        skip = "enc-dec decoder context is 448 tokens (whisper); cell n/a"
    return Cell(arch, shape, cfg, kind, skip)


def all_cells():
    from ..configs import ARCHS
    return [cell_for(a, s) for a in ARCHS for s in SHAPES]


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(cfg: ModelConfig) -> M.Model:
    """The model built on "meta": every weight's shape and dtype."""
    return M.init_params(cfg, device="meta")


def abstract_opt(params: M.Model):
    """`adamw_init` of the meta weights (`launch.train.init_opt`)."""
    return init_opt(params)


def train_batch_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encdec():
        return {"frames": _meta((B, S, cfg.d_model), dt),
                "tokens": _meta((B, M.MAX_WHISPER_DEC), torch.int32),
                "labels": _meta((B, M.MAX_WHISPER_DEC), torch.int32)}
    batch: Dict[str, Any] = {"labels": _meta((B, S), torch.int32)}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = _meta((B, S, cfg.d_model), dt)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.mrope_sections is not None:
        batch["positions"] = _meta((3, B, S), torch.int32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    b = train_batch_specs(cfg, B, S)
    b.pop("labels", None)
    if cfg.is_encdec():
        b.pop("tokens", None)
    return b


def abstract_cache(cfg: ModelConfig, B: int, S: int):
    return M.init_cache(cfg, B, S, device="meta")


def cell_inputs(cell: Cell):
    """Returns (fn_kind, tuple_of_abstract_args)."""
    info = SHAPES[cell.shape]
    B, S = info["batch"], info["seq"]
    cfg = cell.cfg
    params = abstract_params(cfg)
    if cell.kind == "train":
        return ("train", (params, abstract_opt(params),
                          train_batch_specs(cfg, B, S)))
    if cell.kind == "prefill":
        return ("prefill", (params, prefill_batch_specs(cfg, B, S),
                            abstract_cache(cfg, B, S)))
    # decode: cache of size S, one new token written at position `pos`
    cache = abstract_cache(cfg, B, S)
    tokens = _meta((B, 1), torch.int32)
    pos = _meta((), torch.int32)
    return ("decode", (params, cache, tokens, pos))
