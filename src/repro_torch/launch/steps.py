"""Step functions: train, prefill and decode, as the trainer and the
serving loop call them.

Counterpart of ``repro.launch.steps``. Each is a plain function of
(params, [opt_state | state], batch); PyTorch runs eagerly, so there is
nothing to compile. The train step takes plain tensors or DTensors laid
out by ``parallel.sharding`` (``launch.train.train(mesh=...)``).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import decode_step, loss_fn, prefill, tree_map
from repro_torch.optim import adam
from repro_torch.parallel import ctx

PyTree = Any


def _cast_params(params: PyTree, cfg: ModelConfig,
                 compute_shardings: PyTree | None = None) -> PyTree:
    """float32 leaves with two or more dimensions in ``cfg.compute_dtype``;
    vectors (norm scales, SSM constants) stay float32. Leaves already in
    another type pass through, so casting twice changes nothing. With
    ``compute_shardings`` (a tree of ``parallel.sharding.Layout``, ``None``
    leaves kept) each copy is redistributed to its compute layout: under
    tp+fsdp one all-gather over the data axes a step, whose backward
    reduce-scatters the gradient."""
    cd = dtype_of(cfg.compute_dtype)
    cast = tree_map(
        lambda p: p.to(cd) if p.dtype == torch.float32 and p.dim() >= 2 else p,
        params)
    if compute_shardings is None:
        return cast
    return adam.tree_map(ctx.redistribute, cast, compute_shardings)


def loss_and_grads(params: PyTree, cfg: ModelConfig, batch: PyTree,
                   compute_shardings: PyTree | None = None):
    """(loss, metrics, grads): the loss of the compute-type copies of the
    float32 masters (``_cast_params``) and its gradient back to the masters
    by autograd, a tree like ``params`` (zeros for a leaf the loss does not
    reach, as the reference's ``value_and_grad`` gives). On DTensors the
    loss is replicated before the backward, and each gradient comes back
    in its master's layout (the sum over the batch's shards)."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(_cast_params(params, cfg, compute_shardings), cfg, batch)
    loss = ctx.replicated(loss)
    leaves = adam.tree_leaves(params)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else ctx.placed_like(g, p)
               for p, g in zip(leaves, got)}
    return (loss.detach(), {k: ctx.replicated(v).detach() for k, v in metrics.items()},
            tree_map(lambda p: by_leaf[id(p)], params))


def make_train_step(cfg: ModelConfig, adam_cfg: adam.AdamConfig | None = None,
                    compute_shardings: PyTree | None = None, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`loss_and_grads`, one Adam update
    (``optim.adam.update``, clipping included) and the metrics ``ce``,
    ``aux``, ``loss`` and ``grad_norm`` (the square root of the float32 sum
    of squares over every leaf, before clipping). It returns new params
    and state: the update holds the old and the new params, mu and nu at
    once (at llama3.2-1b, float32, about 15 GB of them). With ``donate``,
    as the reference's trainer donates them to its jitted step, the update
    writes the given params and moments in place (``optim.adam.update_``,
    the same bits) and returns them: one copy of the state. A non-finite
    loss then leaves them untouched (a host read of the loss), which is
    what the trainer's retry needs. ``compute_shardings``
    (``parallel.sharding.to_shardings`` of ``compute_specs``) lays out the
    compute copies, see :func:`_cast_params`."""
    acfg = adam_cfg or adam.AdamConfig()

    def train_step(params: PyTree, opt_state: adam.AdamState, batch: PyTree):
        loss, metrics, grads = loss_and_grads(params, cfg, batch, compute_shardings)
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in adam.tree_leaves(grads)))
        if not donate:
            params, opt_state = adam.update(grads, opt_state, params, acfg)
        elif loss.device.type == "meta" or math.isfinite(float(loss)):
            # a meta loss (a step traced by ``parallel.roofline``) has no
            # value to read: its update is traced as a finite loss's
            opt_state = adam.update_(grads, opt_state, params, acfg)
        return params, opt_state, {**metrics, "loss": loss, "grad_norm": gn}

    return train_step


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
