"""Architecture registry of the port: ``--arch <id>`` resolves here.

``ARCHS`` lists the architectures the port runs, the JAX package's ten:
the dense GQA models, gemma2's alternating local/global layers, the two
MoE archs, Mamba2, the zamba2 hybrid, and the VLM and audio stub
frontends.
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
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG
