"""Architecture registry of the port: ``--arch <id>`` resolves here.

``ARCHS`` lists the architectures the port runs. The JAX package's other
eight (MoE, the zamba2 hybrid, gemma2's local/global layers, the VLM and
audio frontends) come with later slices of the model stack.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS: dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG
