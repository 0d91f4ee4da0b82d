"""zamba2-7b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 (d_inner=7168, ssm_state=64) with one shared attention block
(32H kv=32, d_ff=14336 MLP) applied every 6 Mamba2 layers (13 applications).
The shared block's KV cache is the only attention state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    block_pattern="ssm+shared_attn", shared_attn_every=6,
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    activation="gelu", tie_embeddings=True,
    sharding_mode="tp+fsdp", remat_group=6,
)
