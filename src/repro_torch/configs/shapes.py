"""Assigned input shapes and ``meta`` stand-ins for every model input.

Counterpart of ``repro.configs.shapes``. Four shapes per LM architecture
(40 cells):
  train_4k     seq_len=4096   global_batch=256   (train_step)
  prefill_32k  seq_len=32768  global_batch=32    (serve prefill)
  decode_32k   seq_len=32768  global_batch=128   (serve decode: 1 new token,
                                                  KV/SSM cache of seq_len)
  long_500k    seq_len=524288 global_batch=1     (long-context decode;
                                                  SSM/hybrid archs only)

``input_specs`` returns (step_kind, spec tree) where every tensor leaf is
a ``meta`` tensor of the reference's ``jax.ShapeDtypeStruct``'s shape and
dtype: no storage, placeable on a device mesh as a DTensor. The decode
state comes from the port's ``init_decode_state`` on ``meta``, whose cache
position ``pos`` is a host integer (the reference's is an int32 scalar).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_decode_state


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SUBQUADRATIC = ("ssm", "ssm+shared_attn")


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason when skipped."""
    if shape == "long_500k" and cfg.block_pattern not in SUBQUADRATIC:
        return False, "full-attention arch: long_500k requires sub-quadratic attention (DESIGN.md §5)"
    return True, ""


def _token_batch(cfg: ModelConfig, B: int, S: int, with_labels: bool):
    """Token/embedding specs honouring the modality stubs."""
    batch: dict = {}
    if cfg.frontend == "audio_stub":
        batch["embeds"] = _meta((B, S, cfg.frontend_dim), torch.bfloat16)
    elif cfg.frontend == "vlm_stub":
        batch["embeds"] = _meta((B, cfg.frontend_len, cfg.frontend_dim), torch.bfloat16)
        batch["tokens"] = _meta((B, S - cfg.frontend_len), torch.int32)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if with_labels:
        batch["labels"] = _meta((B, S), torch.int32)
    return batch


def decode_state_specs(cfg: ModelConfig, B: int, S: int):
    """The decode cache on ``meta``, as ``init_decode_state`` lays it out
    (``pos`` a host integer)."""
    return init_decode_state(cfg, B, S, device="meta")


def input_specs(cfg: ModelConfig, shape: str):
    """Returns (kind, specs) for the given cell. ``specs`` matches the step
    function signature for that kind (see launch/steps.py)."""
    sp = SHAPES[shape]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape} skipped: {why}")
    B, S = sp.global_batch, sp.seq_len
    if sp.kind == "train":
        return "train", {"batch": _token_batch(cfg, B, S, with_labels=True)}
    if sp.kind == "prefill":
        return "prefill", {"batch": _token_batch(cfg, B, S, with_labels=False)}
    # decode: one new token + a cache of length S
    new_tok: dict = {}
    if cfg.frontend == "audio_stub":
        new_tok["embeds"] = _meta((B, 1, cfg.frontend_dim), torch.bfloat16)
    else:
        new_tok["tokens"] = _meta((B, 1), torch.int32)
    return "decode", {"batch": new_tok, "state": decode_state_specs(cfg, B, S)}
