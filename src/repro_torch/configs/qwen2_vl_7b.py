"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H GQA(kv=4) d_ff=18944
vocab=152064; M-RoPE (sections 16/24/24), qkv bias. [arXiv:2409.12191]
Modality frontend is a STUB: input_specs() provides precomputed patch
embeddings (input_mode="embeddings") per the assignment."""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28, n_kv=4, head_dim=128,
    d_ff=18944,
    vocab=152_064,
    pattern=(Block(mlp="swiglu"),),
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    rope_base=1_000_000.0,
    tie_embeddings=False,
    input_mode="embeddings",
)
