"""gemma2-27b [dense]: 46L d_model=4608 32H GQA(kv=16) d_ff=36864
vocab=256000; alternating local(4096)/global, attn softcap 50, final logit
softcap 30, sandwich norms. [arXiv:2408.00118]"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32, n_kv=16, head_dim=128,
    d_ff=36864,
    vocab=256_000,
    pattern=(Block(window=4096), Block(window=None)),
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
)
