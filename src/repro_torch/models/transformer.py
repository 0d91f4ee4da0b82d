"""Model assembly: parameter init, forward (train/prefill), loss, decode step.

Counterpart of ``repro.models.transformer`` for the ``attn`` (llama-style
dense GQA, gemma's and gemma2's variants, MoE layers) and ``ssm`` (Mamba2)
block patterns and the ``ssm+shared_attn`` hybrid (zamba2: groups of
``shared_attn_every`` Mamba2 layers, each followed by one weight-shared
attention block), with the ``vlm_stub`` (patch embeddings in front of the
tokens) and ``audio_stub`` (frame embeddings in place of them) frontends.
Parameters keep the JAX package's keys, its stacked leading layer axis
and ``cfg.param_dtype``; the layer ``scan`` is a Python loop over that
axis. ``loss_fn`` is the reference's next-token cross-entropy in
``ce_chunks`` sequence chunks, each chunk's head and CE recomputed in the
backward (``torch.utils.checkpoint``, as ``jax.checkpoint`` there); with
``cfg.remat`` and a parameter that requires grad, ``forward_hidden``
recomputes each group of ``remat_group`` layers (the hybrid: each SSM group
with its shared-attention application) in the backward too.

Decode caches are preallocated; ``decode_step`` writes them in place and
keeps the cache position ``pos`` as a host integer, so no step reads the
device to find it.

The same code trains on DTensor parameters (``launch.train`` over a mesh):
its plain constants become replicated DTensors (``parallel.ctx.like``),
the two kernels take each rank's shards (``ctx.on_local_shards``), and the
CE reduces vocab-split logits across the shards; on plain tensors none of
this changes a bit.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import ctx

Tensor = torch.Tensor
Params = dict[str, Any]

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
    """Raise ValueError for an unknown block pattern."""
    if cfg.block_pattern not in ("attn", "ssm", "ssm+shared_attn"):
        raise ValueError(f"unknown block pattern {cfg.block_pattern!r}")


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

def _zeros(cfg: ModelConfig, *shape: int, device) -> Tensor:
    return torch.zeros(shape, dtype=L.dtype_of(cfg.param_dtype), device=device)


def _init_attn_layers(key: Tensor, cfg: ModelConfig) -> Params:
    """``key`` (L, 2): one key per layer, every leaf (L, ...); the MLP
    from the layer's second key is a MoE layer when ``num_experts`` is
    set."""
    k = prng.split(key, 3)
    lead = tuple(key.shape[:-1])
    p: Params = {
        "ln1": _zeros(cfg, *lead, cfg.d_model, device=key.device),
        "ln2": _zeros(cfg, *lead, cfg.d_model, device=key.device),
        "attn": L.init_attn(k[..., 0, :], cfg),
    }
    if cfg.num_experts:
        p["moe"] = L.init_moe(k[..., 1, :], cfg)
    else:
        p["mlp"] = L.init_mlp(k[..., 1, :], cfg)
    if cfg.post_norm:
        p["ln1_post"] = _zeros(cfg, *lead, cfg.d_model, device=key.device)
        p["ln2_post"] = _zeros(cfg, *lead, cfg.d_model, device=key.device)
    return p


def init_params(key: Tensor, cfg: ModelConfig) -> Params:
    """The JAX package's ``init_params``: the same key splits, each leaf
    drawn in ``cfg.param_dtype`` with ``prng.normal`` (within its ulp bound
    of ``jax.random``) on the key's device, one layer and at most
    ``L.DRAW_BLOCK`` elements at a time (``L.normal_leaf``). No embedding
    table for the audio frontend, whose head is always its own; the
    frontend's projection from ``keys[2]``; the hybrid's shared block from
    ``keys[4]``."""
    check_supported(cfg)
    keys = prng.split(key, 8)
    d, dt, dev = cfg.d_model, L.dtype_of(cfg.param_dtype), key.device
    params: Params = {"final_norm": _zeros(cfg, d, device=dev)}
    if cfg.frontend != "audio_stub":
        params["embed"] = L.normal_leaf(keys[0], (cfg.padded_vocab, d), L.inv_sqrt(d), dt)
    if not cfg.tie_embeddings or cfg.frontend == "audio_stub":
        params["lm_head"] = L.normal_leaf(keys[1], (d, cfg.padded_vocab), L.inv_sqrt(d), dt)
    if cfg.frontend != "none":
        params["frontend"] = {"proj": L.normal_leaf(
            keys[2], (cfg.frontend_dim, d), L.inv_sqrt(cfg.frontend_dim), dt)}
    layer_keys = prng.split(keys[3], cfg.n_layers)
    if cfg.block_pattern == "attn":
        params["layers"] = _init_attn_layers(layer_keys, cfg)
    else:
        params["layers"] = {
            "ln": _zeros(cfg, cfg.n_layers, d, device=dev),
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
    """Attention block ``idx`` (even blocks are gemma2's local layers) ->
    (x, the MoE layer's aux loss or None, cache)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, cache = L.attention(lp["attn"], h, cfg,
                           layer_is_local=cfg.local_global_pattern and idx % 2 == 0,
                           positions=positions, kv_cache=kv_cache, cache_pos=cache_pos)
    if cfg.post_norm:
        a = L.rmsnorm(a, lp["ln1_post"], cfg.norm_eps)
    x = x + a
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        m, aux = L.moe(lp["moe"], h, cfg)
    else:
        m, aux = L.mlp(lp["mlp"], h, cfg), None
    if cfg.post_norm:
        m = L.rmsnorm(m, lp["ln2_post"], cfg.norm_eps)
    return x + m, aux, cache


def _ssm_layer(lp: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    return x + S.ssm_block(lp["ssm"], L.rmsnorm(x, lp["ln"], cfg.norm_eps), cfg)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, cfg: ModelConfig, tokens: Tensor | None,
                 embeds: Tensor | None = None) -> Tensor:
    """Frontend embeddings (B, Se, frontend_dim) through ``frontend.proj``,
    then the tokens' embeddings (B, St), concatenated on the sequence axis
    in that order; gemma's scale; sinusoidal positions from 0 on every
    call, a decode step's included, as the reference adds them."""
    cd = L.dtype_of(cfg.compute_dtype)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(cd) @ params["frontend"]["proj"].to(cd))
    if tokens is not None:
        parts.append(_lookup(params["embed"], tokens).to(cd))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.scale_embeddings:
        # sqrt(d_model) in float32, rounded to the compute type, as a host
        # scalar (a tensor made on the card would synchronise its stream).
        x = x * float(torch.tensor(float(np.sqrt(np.float32(cfg.d_model)))).to(cd))
    if cfg.pos_embedding == "sinusoidal":
        pos = L.sinusoidal_pos(torch.arange(x.shape[1], device=x.device), cfg.d_model)
        x = x + ctx.like(pos[None].to(cd), x)
    return x


def _lookup(table: Tensor, tokens: Tensor) -> Tensor:
    """``table[tokens]``. Tokens that are a DTensor split over the batch are
    gathered first and the rows split after: DTensor's sharding rule for
    the lookup's backward (``index_put``) rejects a split index in torch
    2.11."""
    if not ctx.split(tokens, 0):
        return table[tokens]
    return ctx.placed_like(table[ctx.replicated(tokens)], tokens)


def _logsumexp(x: Tensor) -> Tensor:
    """``torch.logsumexp`` over the last dim. On logits split over the
    vocab (a DTensor sharded on it) the max and the sum of exponentials
    are reduced across the shards, where DTensor's own rule would gather
    the (B, S, V) logits on every rank; the max is a constant to autograd,
    so the gradient is the softmax."""
    if not ctx.split(x, -1):
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    return (m + torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True)))[..., 0]


def _head_logits(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """LM-head matmul on (already final-normed) hidden states -> f32 logits,
    vocab padding masked."""
    cd = L.dtype_of(cfg.compute_dtype)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = L.softcap(x @ head.to(cd), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab:
        pad = ctx.like(torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab, logits)
        logits = torch.where(pad, L.NEG_INF, logits.float())
    return logits.float()


def logits_from_hidden(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    return _head_logits(params, cfg, L.rmsnorm(x, params["final_norm"], cfg.norm_eps))


def _unstacked(layers: Params) -> list[Params]:
    """The stacked layer leaves as one dict of views per layer, by one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer out of the stack would add a whole stack of
    zeros but one slice into the leaf's gradient for every layer."""
    per_leaf = tree_map(lambda v: v.unbind(0), layers)
    n = len(tree_leaves(per_leaf)[0])
    return [tree_map(lambda views: views[i], per_leaf) for i in range(n)]


def _layer_span(layers: list[Params], shared: Params | None, cfg: ModelConfig, x: Tensor,
                aux: Tensor, positions: Tensor, lo: int, hi: int) -> tuple[Tensor, Tensor]:
    """Layers ``lo..hi-1`` of ``layers`` (in the hybrid each followed by its
    application of the ``shared`` attention block, if any) -> (x, aux plus
    their MoE aux losses, added in layer order)."""
    for i in range(lo, hi):
        lp = ctx.constrain_layer_weights(layers[i])
        if cfg.block_pattern == "attn":
            x, a, _ = _attn_block(lp, x, cfg, i, positions)
        else:
            x, a = _ssm_layer(lp, x, cfg), None
            g = _shared_app(cfg, i)
            if g is not None:
                x, a, _ = _attn_block(shared, x, cfg, g, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def remat_spans(cfg: ModelConfig) -> list[tuple[int, int]]:
    """The layer spans ``(lo, hi)`` the backward recomputes, one checkpoint
    each, as the reference groups them (``_scan_layer_blocks``,
    ``forward_hidden``): ``remat_group`` layers at a time when it divides
    the layer count, else one; the hybrid's groups of ``shared_attn_every``
    SSM layers each with its shared attention application, then its tail
    grouped as the plain stacks are."""
    def grouped(lo: int, n: int) -> list[tuple[int, int]]:
        G = cfg.remat_group if cfg.remat_group > 0 and n % cfg.remat_group == 0 else 1
        return [(i, i + G) for i in range(lo, lo + n, G)]

    if cfg.block_pattern != "ssm+shared_attn":
        return grouped(0, cfg.n_layers)
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return ([(g * every, (g + 1) * every) for g in range(n_groups)]
            + grouped(n_groups * every, cfg.n_layers - n_groups * every))


def _trains(params: Params) -> bool:
    """Whether this forward records a graph for parameter gradients."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(params))


def forward_hidden(params: Params, cfg: ModelConfig,
                   tokens: Tensor | None = None,
                   embeds: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Backbone forward -> (final-normed hidden (B, S, D), aux_loss): the
    MoE layers' aux losses summed in layer order (0 without MoE). With
    ``cfg.remat`` and a graph to record, each span of :func:`remat_spans`
    is a non-reentrant checkpoint: only its input is kept, and the
    backward runs it again (the kernels' forwards among it). The
    reference's ``_grad_safe_barrier`` only keeps XLA from hoisting casts
    of the stash out of its backward loop; eager PyTorch schedules nothing,
    so it has no counterpart."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, embeds)
    positions = ctx.like(torch.arange(x.shape[1], device=x.device), x)
    aux = ctx.like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    layers, shared = _unstacked(params["layers"]), params.get("shared_attn")
    if cfg.remat and _trains(params):
        for lo, hi in remat_spans(cfg):
            x, aux = checkpoint(_layer_span, layers, shared, cfg, x, aux, positions, lo, hi,
                                use_reentrant=False)
    else:
        x, aux = _layer_span(layers, shared, cfg, x, aux, positions, 0, cfg.n_layers)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: Params, cfg: ModelConfig, tokens: Tensor | None = None,
            embeds: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Returns (logits (B, S, Vp) f32, aux_loss)."""
    x, aux = forward_hidden(params, cfg, tokens=tokens, embeds=embeds)
    return _head_logits(params, cfg, x), aux


def _ce_from_logits(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """(summed CE over the positions whose label is >= 0, their count)."""
    mask = (labels >= 0).float()
    safe = labels.long().clamp_min(0)
    lse = _logsumexp(logits)
    # gathered from vocab-sharded logits, a DTensor is a masked partial sum:
    # reduced before the index drops its last dim
    ll = ctx.replicated(torch.gather(logits, -1, safe[..., None]))[..., 0]
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def _chunk_ce(params: Params, cfg: ModelConfig, xs: Tensor, ls: Tensor):
    return _ce_from_logits(_head_logits(params, cfg, xs), ls)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict[str, Tensor]):
    """Next-token cross-entropy; label -100 positions are masked. Returns
    (ce + aux, {"ce", "aux"}).

    The loss is computed in ``ce_chunks`` sequence chunks, so that the
    float32 logits never exist beyond (B, S / chunks, V): at llama3.2-1b's
    vocab of 128,256 and 8 x 512 tokens the whole tensor would be 2.1 GB, a
    chunk's is 263 MB. When a parameter requires grad (the rule of
    :func:`forward_hidden`), each chunk's head and CE is a non-reentrant
    checkpoint, so the backward recomputes its logits instead of keeping
    them. Chunk sums are added in order, as the reference's scan adds
    them."""
    labels = batch["labels"]
    n_chunks = cfg.ce_chunks if labels.shape[1] % max(cfg.ce_chunks, 1) == 0 else 1
    if n_chunks <= 1:
        logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"))
        tot, cnt = _ce_from_logits(logits, labels)
    else:
        x, aux = forward_hidden(params, cfg, tokens=batch.get("tokens"),
                                embeds=batch.get("embeds"))
        C = x.shape[1] // n_chunks
        tot = cnt = ctx.like(torch.zeros((), dtype=torch.float32, device=x.device), x)
        trains = _trains(params)
        for c in range(n_chunks):
            xs, ls = x[:, c * C:(c + 1) * C], labels[:, c * C:(c + 1) * C]
            if trains:
                t, n = checkpoint(_chunk_ce, params, cfg, xs, ls, use_reentrant=False)
            else:
                t, n = _chunk_ce(params, cfg, xs, ls)
            tot, cnt = tot + t, cnt + n
    ce = tot / torch.clamp_min(cnt, 1.0)
    return ce + aux, {"ce": ce, "aux": aux}


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
    positions = ctx.like(pos + torch.arange(Ssz, device=x.device), x)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.block_pattern == "attn":
            x, _, _ = _attn_block(lp, x, cfg, i, positions,
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
            x, _, _ = _attn_block(params["shared_attn"], x, cfg, g, positions,
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
