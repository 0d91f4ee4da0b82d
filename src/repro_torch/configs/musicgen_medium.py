"""musicgen-medium [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
The EnCodec/codebook-interleaving frontend is a stub: the model takes
precomputed frame embeddings (the summed codebook embeddings, width 1536)
through a projection, in place of tokens.
Sinusoidal positions, untied LM head over the 2048-entry codebook.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048,
    activation="gelu", pos_embedding="sinusoidal", tie_embeddings=False,
    frontend="audio_stub", frontend_dim=1536,
    vocab_pad_to=128,
    sharding_mode="tp+fsdp",  # attn weights replicated on model (24H): FSDP storage keeps moments sharded
)
