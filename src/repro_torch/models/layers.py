"""Transformer building blocks: RMSNorm, RoPE, GQA attention, dense MLP.

Counterpart of ``repro.models.layers``. Parameters are plain dicts of
tensors with the JAX package's keys; activations are in
``cfg.compute_dtype``, reductions in float32.

Attention over a whole prompt goes through the ``flash_attention`` kernel
(its plain version on a CPU tensor): without a cache at every length, where
the JAX package picks ``_attend_direct`` or ``_attend_chunked`` (one
function, two XLA schedules), and through the KV cache at position 0. A
call at a later cache position (a decode step) keeps the grouped einsum of
``_attend_direct_g``. The mask takes the query positions to be
``cache_pos + 0..S-1``, as every caller passes them. gemma2's local and
global layers differ only by the window each call is given
(``layer_is_local``). MoE (``init_moe``, ``moe``) comes with a later slice.

Parameters are drawn leaf by leaf with :func:`normal_leaf`, one layer's key
at a time and a large leaf in blocks of rows, so that a full-size init
never holds the int64 temporaries of a whole stacked leaf.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict[str, Any]

NEG_INF = -1e9  # mask bias (bf16-safe)


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    return getattr(torch, name)


def inv_sqrt(n: int) -> float:
    """``1 / sqrt(n)`` rounded as the reference computes it in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


# Elements one ``prng.normal`` call draws at most: threefry's int64
# temporaries (several of 8 bytes per element) stay near half a gigabyte
# each. gemma2-9b's stacked ``w_gate`` alone is 2.16 G elements.
DRAW_BLOCK = 1 << 26


def normal_leaf(key: Tensor, shape: tuple[int, ...], mul: float) -> Tensor:
    """``prng.normal(key, shape) * mul`` for ``key`` ``(..., 2)`` with
    leading key axes (the layer axis), bit for bit: each leading key is
    drawn alone, and a draw of more than :data:`DRAW_BLOCK` elements in
    blocks of rows whose counters continue where the last block's
    stopped."""
    lead = tuple(key.shape[:-1])
    out = torch.empty((*lead, *shape), dtype=torch.float32, device=key.device)
    keys, rows_out = key.reshape(-1, 2), out.reshape(-1, *shape)
    row = math.prod(shape[1:])
    step = max(1, DRAW_BLOCK // max(row, 1))
    for i in range(keys.shape[0]):
        for r0 in range(0, shape[0], step):
            r1 = min(shape[0], r0 + step)
            rows_out[i, r0:r1] = prng.normal(keys[i], (r1 - r0, *shape[1:]),
                                             start=r0 * row) * mul
    return out


# ---------------------------------------------------------------------------
# norms / positions
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    # The variance accumulates in float32; the data path stays in x.dtype.
    var = torch.mean(torch.square(x).float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * (1.0 + scale.to(x.dtype))


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device) -> Tensor:
    """1 / theta**(i / half) in float32, the power rounded once from float64;
    made once per device (a copy to the card synchronises its stream)."""
    ex = np.arange(half, dtype=np.float32) / np.float32(half)
    pw = (np.float64(np.float32(theta)) ** ex.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.float32(1.0) / pw).to(device)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions: (..., S). Computed in float32."""
    freqs = _rope_freqs(x.shape[-1] // 2, float(theta), x.device)
    angles = positions[..., :, None, None].float() * freqs   # (..., S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: Tensor, cap: float) -> Tensor:
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attn(key: Tensor, cfg: ModelConfig) -> Params:
    """``key`` ``(..., 2)``: leading key axes (the layer axis) lead every
    leaf, as under ``vmap``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k = prng.split(key, 4)
    return {
        "wq": normal_leaf(k[..., 0, :], (d, h * hd), inv_sqrt(d)),
        "wk": normal_leaf(k[..., 1, :], (d, kv * hd), inv_sqrt(d)),
        "wv": normal_leaf(k[..., 2, :], (d, kv * hd), inv_sqrt(d)),
        "wo": normal_leaf(k[..., 3, :], (h * hd, d), inv_sqrt(h * hd)),
    }


def _mask_bias(q_pos: Tensor, k_pos: Tensor, window: int) -> Tensor:
    """Causal (+ optional sliding window) bias from positions; a window of
    0 or less means full causal attention."""
    delta = q_pos[:, None] - k_pos[None, :]
    ok = delta >= 0
    if window > 0:
        ok = ok & (delta < window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _repeat_kv(k: Tensor, rep: int) -> Tensor:
    """(B, T, KV, hd) -> (B, T, KV*rep, hd): head h reads KV head h // rep."""
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def _attend_direct_g(q, k, v, q_pos, k_pos, window, softcap_val, scale):
    """Grouped-query einsum without KV expansion — the decode path."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", qh, k).float() * scale
    scores = softcap(scores, softcap_val)
    scores = scores + _mask_bias(q_pos, k_pos, window)[None, None, None]
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", p, v)
    return out.reshape(B, S, H, hd)


def _attend_flash(q, k, v, window, softcap_val):
    """q (B, S, H, hd), k/v (B, T, H, hd) expanded -> (B, S, H, hd), causal
    from index 0, through the ``flash_attention`` kernel on (B*H, S, hd)."""
    B, S, H, hd = q.shape
    T = k.shape[1]

    def rows(t, n):
        return t.permute(0, 2, 1, 3).reshape(B * H, n, hd).contiguous()

    out = flash_attention(rows(q, S), rows(k, T), rows(v, T), causal=True,
                          window=window, softcap=softcap_val)
    return out.reshape(B, H, S, hd).permute(0, 2, 1, 3)


def attention(params: Params, x: Tensor, cfg: ModelConfig, *,
              layer_is_local: bool = False,
              positions: Tensor | None = None,
              kv_cache: tuple[Tensor, Tensor] | None = None,
              cache_pos: int | None = None):
    """GQA attention. Training/prefill when kv_cache is None (returns y,
    (k, v)); through the cache when it is given (returns y and the cache,
    whose tensors are written in place at ``cache_pos``, a host integer).
    With ``cfg.local_global_pattern`` (gemma2) a local layer attends within
    ``cfg.window`` and a global layer to every earlier position."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = dtype_of(cfg.compute_dtype)
    wq, wk, wv, wo = (params[n].to(cd) for n in ("wq", "wk", "wv", "wo"))
    if positions is None:
        positions = torch.arange(S, device=x.device)

    q = (x @ wq).reshape(B, S, H, hd)
    k = (x @ wk).reshape(B, S, KV, hd)
    v = (x @ wv).reshape(B, S, KV, hd)
    if cfg.pos_embedding == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    window = cfg.window if cfg.window > 0 else 0
    if cfg.local_global_pattern and not layer_is_local:
        window = 0
    rep = H // KV

    if kv_cache is not None:
        ck, cv = kv_cache                      # (B, T, KV, hd) preallocated
        pos = int(cache_pos)
        ck[:, pos:pos + S] = k.to(ck.dtype)
        cv[:, pos:pos + S] = v.to(cv.dtype)
        if pos == 0:
            # Keys at S and beyond lie after every query: causally masked,
            # they add nothing, so the kernel reads the first S rows.
            out = _attend_flash(q, _repeat_kv(ck[:, :S].to(cd), rep),
                                _repeat_kv(cv[:, :S].to(cd), rep), window,
                                cfg.attn_softcap)
        else:
            # Keys past pos + S are masked for every query; leave them out.
            n = pos + S
            out = _attend_direct_g(q, ck[:, :n].to(cd), cv[:, :n].to(cd),
                                   positions, torch.arange(n, device=x.device),
                                   window, cfg.attn_softcap, inv_sqrt(hd))
        y = out.reshape(B, S, H * hd) @ wo
        return y, (ck, cv)

    out = _attend_flash(q, _repeat_kv(k, rep), _repeat_kv(v, rep), window,
                        cfg.attn_softcap)
    y = out.reshape(B, S, H * hd) @ wo
    return y, (k, v)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def init_mlp(key: Tensor, cfg: ModelConfig, d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    k = prng.split(key, 3)
    return {
        "w_gate": normal_leaf(k[..., 0, :], (d, f), inv_sqrt(d)),
        "w_up": normal_leaf(k[..., 1, :], (d, f), inv_sqrt(d)),
        "w_down": normal_leaf(k[..., 2, :], (f, d), inv_sqrt(f)),
    }


def _act(cfg: ModelConfig):
    # jax.nn.gelu's default is the tanh approximation.
    return F.silu if cfg.activation == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def mlp(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    cd = dtype_of(cfg.compute_dtype)
    g = _act(cfg)(x @ params["w_gate"].to(cd))
    u = x @ params["w_up"].to(cd)
    return (g * u) @ params["w_down"].to(cd)
