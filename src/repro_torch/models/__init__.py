"""The model stack: configuration, layers, Mamba2 block and assembly."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    param_count,
    prefill,
)
