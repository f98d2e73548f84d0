"""stablelm-1.6b [dense]: 24L d_model=2048 32H MHA(kv=32) head_dim=64
d_ff=5632 SwiGLU vocab=100352; LayerNorm, partial rotary 25%.
[hf:stabilityai/stablelm-2-1_6b] Pure full attention -> long_500k skipped."""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32, n_kv=32, head_dim=64,
    d_ff=5632,
    vocab=100_352,
    pattern=(Block(mlp="swiglu"),),
    norm="layernorm",
    rope_pct=0.25,
    tie_embeddings=False,
)
