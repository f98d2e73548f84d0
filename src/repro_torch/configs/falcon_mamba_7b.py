"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free mamba1, ssm_state=16,
vocab=65024. [arXiv:2410.05355] Pure SSM -> long_500k cell runs (O(1)/token
state decode, no KV cache)."""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0, n_kv=0, head_dim=0,      # attention-free
    d_ff=0,
    vocab=65024,
    pattern=(Block(mixer="ssm", mlp=None),),
    ssm_state=16,
    d_inner=8192,                        # 2 * d_model (mamba1 expand=2)
    dt_rank=256,                         # ceil(d_model / 16)
    conv_width=4,
    tie_embeddings=False,
    seq_chunk=256,
)
