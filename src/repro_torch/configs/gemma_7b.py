"""gemma-7b [dense]: 28L d_model=3072 16H MHA(kv=16) head_dim=256
d_ff=24576 GeGLU vocab=256000. [arXiv:2403.08295] Pure full attention ->
long_500k skipped."""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16, n_kv=16, head_dim=256,
    d_ff=24576,
    vocab=256_000,
    pattern=(Block(),),
    tie_embeddings=True,
    embed_scale=True,
)
