"""Model assembly: parameter init, forward (prefill), decode step.

Counterpart of ``repro.models.transformer`` for the ``attn`` (llama-style
dense GQA, gemma's and gemma2's variants) and ``ssm`` (Mamba2) block
patterns and the ``ssm+shared_attn`` hybrid (zamba2: groups of
``shared_attn_every`` Mamba2 layers, each followed by one weight-shared
attention block). Parameters keep the JAX package's keys and its stacked
leading layer axis; the layer ``scan`` is a Python loop over that axis.
MoE layers, the VLM/audio frontends and ``loss_fn`` (training) raise
NotImplementedError: later slices of the model stack port them.

Decode caches are preallocated; ``decode_step`` writes them in place and
keeps the cache position ``pos`` as a host integer, so no step reads the
device to find it.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict[str, Any]

_LATER = "ported in a later slice of the model stack"


def tree_map(fn: Callable[[Tensor], Any], tree: Any) -> Any:
    """``fn`` applied to every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list[Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet (MoE
    layers, the frontends, non-float32 parameters), ValueError for an
    unknown block pattern."""
    if cfg.block_pattern not in ("attn", "ssm", "ssm+shared_attn"):
        raise ValueError(f"unknown block pattern {cfg.block_pattern!r}")
    if cfg.num_experts:
        raise NotImplementedError(f"MoE layers are {_LATER}")
    if cfg.frontend != "none" or cfg.pos_embedding != "rope":
        raise NotImplementedError(f"frontends and sinusoidal positions are {_LATER}")
    if cfg.param_dtype != "float32":
        raise NotImplementedError(f"non-float32 parameters are {_LATER} (with MoE)")


def _shared_app(cfg: ModelConfig, i: int) -> int | None:
    """The shared attention application that follows layer ``i`` of the
    hybrid (after every ``shared_attn_every`` layers; the tail has none),
    else None."""
    if cfg.block_pattern != "ssm+shared_attn" or (i + 1) % cfg.shared_attn_every:
        return None
    return (i + 1) // cfg.shared_attn_every - 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn_layers(key: Tensor, cfg: ModelConfig) -> Params:
    """``key`` (L, 2): one key per layer, every leaf (L, ...)."""
    k = prng.split(key, 3)
    lead = tuple(key.shape[:-1])
    p: Params = {
        "ln1": torch.zeros((*lead, cfg.d_model), device=key.device),
        "ln2": torch.zeros((*lead, cfg.d_model), device=key.device),
        "attn": L.init_attn(k[..., 0, :], cfg),
        "mlp": L.init_mlp(k[..., 1, :], cfg),
    }
    if cfg.post_norm:
        p["ln1_post"] = torch.zeros((*lead, cfg.d_model), device=key.device)
        p["ln2_post"] = torch.zeros((*lead, cfg.d_model), device=key.device)
    return p


def init_params(key: Tensor, cfg: ModelConfig) -> Params:
    """The JAX package's ``init_params``: the same key splits, each leaf
    drawn with ``prng.normal`` (within its ulp bound of ``jax.random``) on
    the key's device, one layer and at most ``L.DRAW_BLOCK`` elements at a
    time (``L.normal_leaf``); the hybrid's shared block from ``keys[4]``."""
    check_supported(cfg)
    keys = prng.split(key, 8)
    d = cfg.d_model
    params: Params = {
        "final_norm": torch.zeros(d, device=key.device),
        "embed": L.normal_leaf(keys[0], (cfg.padded_vocab, d), L.inv_sqrt(d)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal_leaf(keys[1], (d, cfg.padded_vocab), L.inv_sqrt(d))
    layer_keys = prng.split(keys[3], cfg.n_layers)
    if cfg.block_pattern == "attn":
        params["layers"] = _init_attn_layers(layer_keys, cfg)
    else:
        params["layers"] = {
            "ln": torch.zeros((cfg.n_layers, d), device=key.device),
            "ssm": S.init_ssm(layer_keys, cfg),
        }
        if cfg.block_pattern == "ssm+shared_attn":
            params["shared_attn"] = _init_attn_layers(keys[4], cfg)
    return params


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _layer(layers: Params, i: int) -> Params:
    return tree_map(lambda v: v[i], layers)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(lp: Params, x: Tensor, cfg: ModelConfig, idx: int, positions: Tensor,
                kv_cache=None, cache_pos=None):
    """Attention block ``idx`` (even blocks are gemma2's local layers)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, cache = L.attention(lp["attn"], h, cfg,
                           layer_is_local=cfg.local_global_pattern and idx % 2 == 0,
                           positions=positions, kv_cache=kv_cache, cache_pos=cache_pos)
    if cfg.post_norm:
        a = L.rmsnorm(a, lp["ln1_post"], cfg.norm_eps)
    x = x + a
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    m = L.mlp(lp["mlp"], h, cfg)
    if cfg.post_norm:
        m = L.rmsnorm(m, lp["ln2_post"], cfg.norm_eps)
    return x + m, cache


def _ssm_layer(lp: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    return x + S.ssm_block(lp["ssm"], L.rmsnorm(x, lp["ln"], cfg.norm_eps), cfg)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, cfg: ModelConfig, tokens: Tensor | None,
                 embeds: Tensor | None = None) -> Tensor:
    if embeds is not None or tokens is None:
        raise NotImplementedError(f"frontend embeddings are {_LATER}")
    cd = L.dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cd)
    if cfg.scale_embeddings:
        # sqrt(d_model) in float32, rounded to the compute type, as a host
        # scalar (a tensor made on the card would synchronise its stream).
        x = x * float(torch.tensor(float(np.sqrt(np.float32(cfg.d_model)))).to(cd))
    return x


def _head_logits(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """LM-head matmul on (already final-normed) hidden states -> f32 logits,
    vocab padding masked."""
    cd = L.dtype_of(cfg.compute_dtype)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = L.softcap(x @ head.to(cd), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = torch.where(pad, L.NEG_INF, logits.float())
    return logits.float()


def logits_from_hidden(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    return _head_logits(params, cfg, L.rmsnorm(x, params["final_norm"], cfg.norm_eps))


def forward_hidden(params: Params, cfg: ModelConfig,
                   tokens: Tensor | None = None,
                   embeds: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Backbone forward -> (final-normed hidden (B, S, D), aux_loss)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.block_pattern == "attn":
            x, _ = _attn_block(lp, x, cfg, i, positions)
            continue
        x = _ssm_layer(lp, x, cfg)
        g = _shared_app(cfg, i)
        if g is not None:
            x, _ = _attn_block(params["shared_attn"], x, cfg, g, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: Params, cfg: ModelConfig, tokens: Tensor | None = None,
            embeds: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Returns (logits (B, S, Vp) f32, aux_loss)."""
    x, aux = forward_hidden(params, cfg, tokens=tokens, embeds=embeds)
    return _head_logits(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: dict[str, Tensor]):
    raise NotImplementedError(f"training (loss_fn) is {_LATER}")


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with static caches
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device) -> Params:
    """Preallocated decode caches on ``device``; ``pos`` is a host integer."""
    check_supported(cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    state: Params = {"pos": 0}
    if cfg.block_pattern == "attn":
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        state["k"] = torch.zeros(shape, dtype=cd, device=device)
        state["v"] = torch.zeros(shape, dtype=cd, device=device)
    else:
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        state["conv"] = torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                                    dtype=cd, device=device)
        state["ssd"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
            dtype=torch.float32, device=device)
        if cfg.block_pattern == "ssm+shared_attn":
            n_apps = cfg.n_layers // cfg.shared_attn_every
            shape = (n_apps, batch, max_len, cfg.n_kv_heads, cfg.hd)
            state["k"] = torch.zeros(shape, dtype=cd, device=device)
            state["v"] = torch.zeros(shape, dtype=cd, device=device)
    return state


def decode_step(params: Params, cfg: ModelConfig, state: Params,
                tokens: Tensor | None = None, embeds: Tensor | None = None):
    """One decode step: new token(s) (B, S) -> last-position logits (B, Vp),
    updated state (the same cache tensors, written in place). For the
    attention pattern S may exceed 1 — the whole chunk goes through the KV
    cache in one call; the recurrent pattern is single-token (S == 1)."""
    x = embed_inputs(params, cfg, tokens, embeds)
    pos = int(state["pos"])
    Ssz = x.shape[1]
    if cfg.block_pattern != "attn" and Ssz != 1:
        raise ValueError(
            f"{cfg.block_pattern} decode_step is single-token (got S={Ssz}); "
            "use launch.steps.make_prefill_decode for multi-token prefill")
    positions = pos + torch.arange(Ssz, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.block_pattern == "attn":
            x, _ = _attn_block(lp, x, cfg, i, positions,
                               kv_cache=(state["k"][i], state["v"][i]), cache_pos=pos)
            continue
        h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
        y, conv, ssd = S.ssm_decode_step(lp["ssm"], h, cfg, state["conv"][i],
                                         state["ssd"][i])
        state["conv"][i] = conv
        state["ssd"][i] = ssd
        x = x + y
        g = _shared_app(cfg, i)
        if g is not None:
            x, _ = _attn_block(params["shared_attn"], x, cfg, g, positions,
                               kv_cache=(state["k"][g], state["v"][g]), cache_pos=pos)
    # Only the last position is read: the head runs on it alone.
    logits = logits_from_hidden(params, cfg, x[:, -1:])[:, 0]
    return logits, {**state, "pos": pos + Ssz}


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor | None = None,
            embeds: Tensor | None = None) -> Tensor:
    """Prefill forward: returns last-position logits (B, Vp). The head runs
    on the last position only; at llama's 128k vocab the (B, S, Vp) float32
    logits of ``forward`` would be gigabytes."""
    x, _ = forward_hidden(params, cfg, tokens=tokens, embeds=embeds)
    return _head_logits(params, cfg, x[:, -1:])[:, 0]
