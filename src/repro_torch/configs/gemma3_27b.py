"""gemma3-27b [dense]: 62L d_model=5376 32H GQA(kv=16) d_ff=21504
vocab=262144; 5 local(1024):1 global pattern, qk-norm, dual rope bases
(10k local / 1M global), sandwich norms. [hf:google/gemma-3-27b]"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32, n_kv=16, head_dim=128,
    d_ff=21504,
    vocab=262144,
    pattern=(Block(window=1024),) * 5 + (Block(window=None),),
    qk_norm=True,
    rope_base=10_000.0,
    rope_base_global=1_000_000.0,
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
)
