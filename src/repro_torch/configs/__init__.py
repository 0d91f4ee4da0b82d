"""Architecture registry of the port: ``--arch <id>`` resolves here.

``ARCHS`` lists the architectures the port runs: the dense GQA models,
gemma2's alternating local/global layers, Mamba2 and the zamba2 hybrid.
The JAX package's other four (the two MoE archs, the VLM and audio
frontends) come with later slices of the model stack.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS: dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG
