"""recurrentgemma-9b [hybrid]: 38L d_model=4096; pattern 2x RG-LRU : 1x
local attention (window 2048, MQA kv=1, head_dim=256), d_ff=12288 GeGLU,
vocab=256000, lru_width=4096. [arXiv:2402.19427] Hybrid -> long_500k runs
(recurrent state + windowed KV keep per-token cost bounded)."""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16, n_kv=1, head_dim=256,
    d_ff=12288,
    vocab=256_000,
    pattern=(Block(mixer="rglru"), Block(mixer="rglru"),
             Block(mixer="attn", window=2048)),
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    embed_scale=True,
)
