"""whisper-large-v3 [audio]: enc-dec, 32+32L d_model=1280 20H MHA d_ff=5120
vocab=51866, GELU, LayerNorm. [arXiv:2212.04356] Conv frontend is a STUB:
input_specs() provides precomputed frame embeddings. Decoder self-context is
448 tokens (as shipped); decode_32k = cross-KV over seq_len frames.
Full attention -> long_500k skipped."""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20, n_kv=20, head_dim=64,
    d_ff=5120,
    vocab=51_866,
    pattern=(Block(mlp="gelu"),),
    norm="layernorm",
    enc_layers=32,
    dec_layers=32,
    tie_embeddings=True,
    input_mode="embeddings",
)
