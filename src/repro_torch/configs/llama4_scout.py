"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H GQA(kv=8) vocab=202048;
MoE 16 experts top-1 + shared expert, expert d_ff=8192, every layer MoE.
[hf:meta-llama/Llama-4-Scout-17B-16E] Early fusion -> text-token path here;
given config is full attention -> long_500k skipped (DESIGN.md)."""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv=8, head_dim=128,
    d_ff=8192,
    vocab=202_048,
    pattern=(Block(mlp="moe"),),
    n_experts=16,
    top_k=1,
    shared_expert=True,
    capacity_factor=1.25,
    rope_base=500_000.0,
    tie_embeddings=False,
)
