"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408, 60 routed experts top-4,
4 shared experts (fused: 4 x 1408 = 5632 hidden), vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    num_experts=60, top_k=4, moe_d_ff=1408, shared_expert_d_ff=5632,
    capacity_factor=1.25,
    activation="silu", tie_embeddings=False,
    sharding_mode="tp+fsdp", remat_group=4,
)
