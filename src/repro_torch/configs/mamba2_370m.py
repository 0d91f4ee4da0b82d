"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=1024 (attn-free, d_inner=2048, ssm_state=128, 32 heads of dim 64)
vocab=50280.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    block_pattern="ssm",
    n_layers=48, d_model=1024, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
    sharding_mode="tp",
)
