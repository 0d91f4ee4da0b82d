"""gemma2-9b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8, head_dim=256) d_ff=14336 vocab=256000.
Sliding window 4096 on alternating layers; attn softcap 50, final softcap 30;
sandwich (pre+post) norms; GeGLU; embeddings scaled by sqrt(d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    window=4096, local_global_pattern=True,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    activation="gelu", scale_embeddings=True, tie_embeddings=True,
    sharding_mode="tp+fsdp", remat_group=6,
)
