"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The ViT frontend is a
stub: the model takes precomputed patch embeddings (InternViT-300M output
width 1024, 256 patch positions) through a projection, in front of the
tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553,
    activation="silu", rope_theta=1_000_000.0, tie_embeddings=True,
    frontend="vlm_stub", frontend_dim=1024, frontend_len=256,
    sharding_mode="tp",
)
