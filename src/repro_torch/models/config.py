"""Architecture configuration for the assigned model zoo.

A model is a token/embedding frontend + a repeated *pattern* of blocks +
final norm + LM head. Each block = (temporal mixer, channel MLP). Mixers:
full/windowed attention (GQA/MQA, softcap, qk-norm, partial/M-RoPE), mamba1
selective SSM, RG-LRU. MLPs: geglu / swiglu / gelu / MoE (top-1 + optional
shared expert) / none (mamba blocks are mixer-only).

Heterogeneous layer stacks (local:global attention, rglru:attn, dense:moe)
are expressed as a repeating `pattern`; the runtime scans over whole periods
(compile-time O(#distinct periods), not O(#layers)) and applies any
non-divisible remainder unscanned.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Block:
    mixer: str = "attn"            # "attn" | "ssm" | "rglru"
    window: Optional[int] = None   # attention window (None = global/causal-full)
    mlp: Optional[str] = "geglu"   # "geglu"|"swiglu"|"gelu"|"moe"|None
    d_ff: Optional[int] = None     # per-block override (llama4-maverick dense)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[Block, ...] = (Block(),)

    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    rope_pct: float = 1.0
    rope_base: float = 10_000.0
    rope_base_global: Optional[float] = None   # gemma3: global layers use 1M
    mrope_sections: Optional[Tuple[int, ...]] = None  # qwen2-vl M-RoPE
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scale
    post_norms: bool = False       # gemma2/3 sandwich norms

    # MoE
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False

    # mamba1 SSM
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0

    # RG-LRU
    lru_width: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0            # 0 -> decoder-only
    dec_layers: int = 0

    # modality frontend stub: "tokens" | "embeddings"
    input_mode: str = "tokens"

    dtype: str = "bfloat16"
    # memory-bounding chunk sizes (see models/layers.py, models/model.py)
    q_chunk: int = 512
    loss_chunk: int = 1024
    seq_chunk: int = 512           # chunked linear-recurrence scan
    remat: bool = True
    remat_policy: str = "nothing"  # "nothing" | "dots" (save matmul outputs)
    # Pallas kernel paths (TPU deployments; validated in interpret mode).
    # use_flash_attention applies to global-causal self-attention blocks in
    # train/prefill (standard arange positions); windowed/decode keep the
    # jnp paths. use_fused_ssm replaces the chunked associative scan.
    use_flash_attention: bool = False
    use_fused_ssm: bool = False

    # does any full-attention (windowless) block exist? (long_500k gate)
    def has_global_attn(self) -> bool:
        return any(b.mixer == "attn" and b.window is None for b in self.pattern)

    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def blocks(self) -> Tuple[Block, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    def param_count(self) -> int:
        """Total params (for 6ND roofline bookkeeping)."""
        from . import model as _m
        return _m.count_params(self)

    def active_param_count(self) -> int:
        from . import model as _m
        return _m.count_params(self, active_only=True)
