"""Step functions: prefill and decode, as the serving loop calls them.

Counterpart of ``repro.launch.steps`` (the training step comes with the
training slice). Each is a plain function of (params, [state], batch); PyTorch runs
eagerly, so there is nothing to compile.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import decode_step, prefill, tree_map

PyTree = Any


def _cast_params(params: PyTree, cfg: ModelConfig) -> PyTree:
    """float32 leaves with two or more dimensions in ``cfg.compute_dtype``;
    vectors (norm scales, SSM constants) stay float32. Leaves already in
    another type pass through, so casting twice changes nothing."""
    cd = dtype_of(cfg.compute_dtype)
    return tree_map(
        lambda p: p.to(cd) if p.dtype == torch.float32 and p.dim() >= 2 else p,
        params)


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: PyTree, batch: PyTree):
        return prefill(_cast_params(params, cfg), cfg,
                       tokens=batch.get("tokens"), embeds=batch.get("embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params: PyTree, state: PyTree, batch: PyTree):
        return decode_step(_cast_params(params, cfg), cfg, state,
                           tokens=batch.get("tokens"), embeds=batch.get("embeds"))

    return serve_step


def make_prefill_decode(cfg: ModelConfig):
    """Cache-filling prefill: the whole (B, S) prompt goes through the decode
    cache and the last-position logits come back ready for sampling.
    Attention archs run all S positions in one multi-token ``decode_step``;
    recurrent archs step through the prompt (tokens, or frame embeddings
    when the batch has them) one position at a time, carrying only the
    latest logits."""

    def prefill_decode(params: PyTree, state: PyTree, batch: PyTree):
        p = _cast_params(params, cfg)
        if cfg.block_pattern == "attn":
            return decode_step(p, cfg, state, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"))
        toks, embs = batch.get("tokens"), batch.get("embeds")
        xs = toks if embs is None else embs
        logits = torch.zeros((xs.shape[0], cfg.padded_vocab),
                             dtype=torch.float32, device=xs.device)
        for t in range(xs.shape[1]):
            x_t = xs[:, t:t + 1]
            logits, state = decode_step(p, cfg, state,
                                        tokens=x_t if embs is None else None,
                                        embeds=x_t if embs is not None else None)
        return logits, state

    return prefill_decode
