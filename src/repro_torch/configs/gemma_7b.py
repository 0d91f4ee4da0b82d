"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (kv=16, head_dim=256) d_ff=24576 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    activation="gelu", scale_embeddings=True, tie_embeddings=True,
    sharding_mode="tp+fsdp", remat_group=7,
)
