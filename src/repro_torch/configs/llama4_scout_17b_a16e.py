"""llama4-scout-17b-a16e [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) per-expert d_ff=8192, 16 routed experts top-1
plus one shared expert, vocab=202048. ~109B total / ~17B active parameters.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    num_experts=16, top_k=1, moe_d_ff=8192, shared_expert_d_ff=8192,
    capacity_factor=1.25,
    activation="silu", rope_theta=500_000.0, tie_embeddings=False,
    sharding_mode="tp+fsdp", remat_group=12,
)
