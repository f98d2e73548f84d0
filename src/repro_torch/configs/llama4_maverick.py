"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H GQA(kv=8)
vocab=202048; MoE 128 experts top-1 + shared expert (d_ff=8192/expert),
alternating dense(16384)/MoE layers (interleave step 2, as shipped).
[hf:meta-llama/Llama-4-Maverick-17B-128E]"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv=8, head_dim=128,
    d_ff=8192,
    vocab=202_048,
    pattern=(Block(mlp="swiglu", d_ff=16384), Block(mlp="moe")),
    n_experts=128,
    top_k=1,
    shared_expert=True,
    capacity_factor=1.25,
    rope_base=500_000.0,
    tie_embeddings=False,
)
