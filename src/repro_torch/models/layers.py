"""Transformer building blocks: RMSNorm, RoPE, sinusoidal positions, GQA
attention, dense MLP, MoE with capacity-bounded dispatch.

Counterpart of ``repro.models.layers``. Parameters are plain dicts of
tensors with the JAX package's keys, drawn in ``cfg.param_dtype``;
activations are in ``cfg.compute_dtype``, reductions in float32.

Attention over a whole prompt goes through the ``flash_attention`` kernel
(its plain version on a CPU tensor): without a cache at every length, where
the JAX package picks ``_attend_direct`` or ``_attend_chunked`` (one
function, two XLA schedules), and through the KV cache at position 0. A
call at a later cache position (a decode step) keeps the grouped einsum of
``_attend_direct_g``. The mask takes the query positions to be
``cache_pos + 0..S-1``, as every caller passes them. gemma2's local and
global layers differ only by the window each call is given
(``layer_is_local``).

MoE (``init_moe``, ``moe``) routes, ranks, drops and combines as the
reference does, in plain PyTorch (the reference computes them outside any
Pallas kernel): top-k with ``jax.lax.top_k``'s tie order, capacity ranks
over the token-major flattening, over-capacity pairs dropped into a zero
slot, the expert products as batched matrix products. Over a device mesh
(DTensors) routing and the combine run group-local on each rank's local
tensors (``route``), and the expert products on DTensors where the
weights lie. Of the two ways to keep the routed experts from being
gathered, DTensor's own propagation was enough: with the dispatch
buffers replicated over ``model`` it slices them on the experts' dim
(llama4-scout's experts over ``model``) or contracts the hidden dim in
place (qwen2-moe), and where llama4-scout's hidden dim is also split over
``data`` it gathers the token buffers over ``data``, never the weights
(the collectives of ``tests/test_torch_sharded_train_moe.py``'s steps).
So no launcher installs the reference's dry-run layouts ``moe_eb`` and
``moe_hidden``; their hook sites stay for a caller's.

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
from repro_torch.parallel import ctx

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


def normal_leaf(key: Tensor, shape: tuple[int, ...], mul: float,
                dtype: torch.dtype = torch.float32) -> Tensor:
    """``prng.normal(key, shape, dtype) * mul`` for ``key`` ``(..., 2)``
    with leading key axes (the layer axis), bit for bit: each leading key
    is drawn alone, and a draw of more than :data:`DRAW_BLOCK` elements in
    blocks of rows whose counters continue where the last block's
    stopped. In a 16-bit type ``mul``, a weak float32 scalar in the
    reference, is rounded to the type before the product."""
    lead = tuple(key.shape[:-1])
    out = torch.empty((*lead, *shape), dtype=dtype, device=key.device)
    if key.device.type == "meta":
        return out          # shapes only (``parallel.sharding.param_shapes``)
    if dtype != torch.float32:
        mul = torch.tensor(mul, dtype=dtype).item()
    keys, rows_out = key.reshape(-1, 2), out.reshape(-1, *shape)
    row = math.prod(shape[1:])
    step = max(1, DRAW_BLOCK // max(row, 1))
    for i in range(keys.shape[0]):
        for r0 in range(0, shape[0], step):
            r1 = min(shape[0], r0 + step)
            rows_out[i, r0:r1] = prng.normal(keys[i], (r1 - r0, *shape[1:]),
                                             start=r0 * row, dtype=dtype) * mul
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
    freqs = ctx.like(_rope_freqs(x.shape[-1] // 2, float(theta), x.device), positions)
    angles = positions[..., :, None, None].float() * freqs   # (..., S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoidal_freqs(half: int, device: torch.device) -> Tensor:
    """1 / 10000**(i / half) in float32, the power rounded once from
    float64; made once per device."""
    ex = np.arange(half, dtype=np.float32) / np.float32(half)
    pw = (np.float64(10000.0) ** ex.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.float32(1.0) / pw).to(device)


def sinusoidal_pos(positions: Tensor, d: int) -> Tensor:
    """(..., S) positions -> (..., S, d) float32 ``[sin, cos]`` halves of
    the float32 angles, each rounded once from float64 (torch's float32
    ``sin`` on the CPU is off by 1e-4 at angles of a few hundred)."""
    ang = positions[..., None].float() * _sinusoidal_freqs(d // 2, positions.device)
    ang = ang.double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


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
    dt = dtype_of(cfg.param_dtype)
    return {
        "wq": normal_leaf(k[..., 0, :], (d, h * hd), inv_sqrt(d), dt),
        "wk": normal_leaf(k[..., 1, :], (d, kv * hd), inv_sqrt(d), dt),
        "wv": normal_leaf(k[..., 2, :], (d, kv * hd), inv_sqrt(d), dt),
        "wo": normal_leaf(k[..., 3, :], (h * hd, d), inv_sqrt(h * hd), dt),
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
    """Grouped-query einsum without KV expansion — the decode path. A
    DTensor q whose heads are split into parts that do not hold whole KV
    groups (32 heads over 16 ranks, 8 KV heads) is gathered on its heads
    first: the grouped view needs whole groups a part."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if KV % ctx.shards(q, 2):
        q = ctx.unsplit(q, 2)
    qh = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", qh, k).float() * scale
    scores = softcap(scores, softcap_val)
    scores = scores + _mask_bias(q_pos, k_pos, window)[None, None, None]
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", p, v)
    return out.reshape(B, S, H, hd)


def _attend_flash(q, k, v, window, softcap_val):
    """q (B, S, H, hd), k/v (B, T, H, hd) expanded -> (B, S, H, hd), causal
    from index 0, through the ``flash_attention`` kernel on (B*H, S, hd).
    DTensors go to the kernel as each rank's own batch rows and heads
    (``ctx.on_local_shards``)."""
    return ctx.on_local_shards(_attend_flash_local, [(q, 0, 2), (k, 0, 2), (v, 0, 2)],
                               (0, 2), window, softcap_val)


def _attend_flash_local(q, k, v, window, softcap_val):
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
        positions = ctx.like(torch.arange(S, device=x.device), x)

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
                                   positions, ctx.like(torch.arange(n, device=x.device), x),
                                   window, cfg.attn_softcap, inv_sqrt(hd))
        y = out.reshape(B, S, H * hd) @ wo
        return y, (ck, cv)

    kf, vf = _repeat_kv(k, rep), _repeat_kv(v, rep)
    if S % 16 == 0:
        # sequence-parallel attention, a no-op unless the attn_seq rules
        # are installed (``parallel.ctx``)
        q = ctx.constrain(q, "attn_seq_q")
        kf = ctx.constrain(kf, "attn_seq_kv")
        vf = ctx.constrain(vf, "attn_seq_kv")
    out = _attend_flash(q, kf, vf, window, cfg.attn_softcap)
    y = out.reshape(B, S, H * hd) @ wo
    return y, (k, v)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def init_mlp(key: Tensor, cfg: ModelConfig, d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    k = prng.split(key, 3)
    dt = dtype_of(cfg.param_dtype)
    return {
        "w_gate": normal_leaf(k[..., 0, :], (d, f), inv_sqrt(d), dt),
        "w_up": normal_leaf(k[..., 1, :], (d, f), inv_sqrt(d), dt),
        "w_down": normal_leaf(k[..., 2, :], (f, d), inv_sqrt(f), dt),
    }


def _act(cfg: ModelConfig):
    # jax.nn.gelu's default is the tanh approximation.
    return F.silu if cfg.activation == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def mlp(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    cd = dtype_of(cfg.compute_dtype)
    g = _act(cfg)(x @ params["w_gate"].to(cd))
    u = x @ params["w_up"].to(cd)
    return (g * u) @ params["w_down"].to(cd)


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity, index-only dispatch, gathered combine
# ---------------------------------------------------------------------------

def init_moe(key: Tensor, cfg: ModelConfig) -> Params:
    """The router, the stacked ``(E, d, f)`` experts and, with
    ``shared_expert_d_ff``, the shared expert; ``key`` ``(..., 2)`` split
    into 5 as the reference splits it."""
    d, f, e = cfg.d_model, cfg.expert_ff, cfg.num_experts
    k = prng.split(key, 5)
    dt = dtype_of(cfg.param_dtype)
    p = {
        "router": normal_leaf(k[..., 0, :], (d, e), inv_sqrt(d), dt),
        "w_gate": normal_leaf(k[..., 1, :], (e, d, f), inv_sqrt(d), dt),
        "w_up": normal_leaf(k[..., 2, :], (e, d, f), inv_sqrt(d), dt),
        "w_down": normal_leaf(k[..., 3, :], (e, f, d), inv_sqrt(f), dt),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = init_mlp(k[..., 4, :], cfg, cfg.shared_expert_d_ff)
    return p


# A check's hook into the routing, None when serving: when set, every
# ``moe_dispatch`` calls ``ROUTING_HOOK(probs, eidx)`` (the router's float32
# probabilities (G, Tg, E) and its top-k experts (G, Tg, K)) and dispatches
# to the experts it returns, with their gates. ``chip_smoke.py`` records the
# CPU's routing and replays it on the card, whose bfloat16 router product
# rounds otherwise and can part a near tie.
ROUTING_HOOK = None


def top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by their lower index first (a stable
    descending sort; ``torch.topk`` does not document its order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(params: Params, xt: Tensor, cfg: ModelConfig, cap: int):
    """Route and dispatch every token group at once (the reference's
    ``_moe_dispatch_group`` under ``vmap``). xt: (G, Tg, D). Returns the
    expert buffers (G, E, cap, D), ``dest`` (G, Tg*K), the gates (G, Tg, K)
    in the compute type and each group's aux loss (G,)."""
    E, K = cfg.num_experts, cfg.top_k
    cd = dtype_of(cfg.compute_dtype)
    G, Tg, D = xt.shape

    logits = (xt @ params["router"].to(cd)).float()                   # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, K)                                       # (G, Tg, K)
    if ROUTING_HOOK is not None:
        eidx = ROUTING_HOOK(probs, eidx)
        gate = torch.gather(probs, -1, eidx)
    gate = (gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)).to(cd)

    # Switch-style load-balancing loss per group.
    flat = eidx.reshape(G, Tg * K)
    me = probs.mean(dim=1)                                             # (G, E)
    ce = torch.zeros((G, E), dtype=torch.float32, device=xt.device).scatter_add_(
        1, flat, torch.ones(flat.shape, dtype=torch.float32, device=xt.device)) / (Tg * K)
    aux = cfg.router_aux_coef * E * (me * ce).sum(-1)

    # Rank of each (token, k) within its expert: an exclusive cumsum over
    # the token-major, k-minor flattening; a rank at or past ``cap`` drops
    # the pair into the slot E*cap, which the combine reads as zeros.
    onehot = F.one_hot(flat, E)                                        # (G, Tg*K, E)
    ranks = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.gather(ranks, 2, flat[..., None])[..., 0]
    dest = torch.where(rank < cap, flat * cap + rank, E * cap)

    # Index-only scatter of token ids into the slots, then one gather of
    # the activations; empty slots read the zero row Tg.
    src_tok = (torch.arange(Tg * K, device=xt.device) // K).expand(G, -1)
    slot = torch.full((G, E * cap + 1), Tg, dtype=torch.int64, device=xt.device)
    slot.scatter_(1, dest, src_tok)
    xpad = torch.cat([xt.to(cd), torch.zeros((G, 1, D), dtype=cd, device=xt.device)], dim=1)
    eb = torch.gather(xpad, 1, slot[:, :-1, None].expand(-1, -1, D)).reshape(G, E, cap, D)
    return eb, dest, gate, aux


def _dispatch_rows(x: Tensor, router: Tensor, cfg: ModelConfig, cap: int, Tg: int):
    """:func:`moe_dispatch` of the rows ``x`` (b, S, D), cut into groups of
    ``Tg`` tokens."""
    b, S, D = x.shape
    return moe_dispatch({"router": router}, x.reshape(b * S // Tg, Tg, D), cfg, cap)


def _combine_rows(dest: Tensor, out: Tensor, gate: Tensor, S: int) -> Tensor:
    """Each (token, k)'s expert output ``out`` (g, E, cap, D) gathered at
    its slot ``dest`` (a dropped pair reads the zero row E*cap) and
    weighted by its gate -> the rows (g*Tg / S, S, D)."""
    g, E, cap, D = out.shape
    Tg, K = gate.shape[1:]
    flat = torch.cat([out.reshape(g, E * cap, D),
                      torch.zeros((g, 1, D), dtype=out.dtype, device=out.device)], dim=1)
    gathered = torch.gather(flat, 1, dest[..., None].expand(-1, -1, D))
    y = torch.einsum("gtkd,gtk->gtd", gathered.reshape(g, Tg, K, D), gate)
    return y.reshape(g * Tg // S, S, D)


def _groups(cfg: ModelConfig, T: int) -> tuple[int, int]:
    """(G, capacity) for T tokens: ``moe_groups`` groups of ``T // G`` when
    it divides T, else 1."""
    G = cfg.moe_groups if T % cfg.moe_groups == 0 and T >= cfg.moe_groups else 1
    return G, max(1, int(cfg.capacity_factor * (T // G) * cfg.top_k / cfg.num_experts))


def route(params: Params, x: Tensor, cfg: ModelConfig):
    """Routing and dispatch of ``x`` (B, S, D) in its :func:`_groups`: the
    expert buffers (G, E, cap, D), ``dest`` (G, Tg*K), the gates (G, Tg, K)
    and each group's aux loss (G,), as :func:`moe_dispatch` gives them.

    Over a mesh (``x`` a DTensor) routing, ranks and slots are group-local,
    as in the reference: when ``x``'s batch rows are split over ``data``
    and the split divides G, each rank dispatches its own groups on its
    local tensors (``ctx.on_local_shards`` with ``groups=G``), and the
    four come back split by group; otherwise (and over ``model``, whatever
    layout DTensor gave ``x`` there) every rank dispatches the replicated
    tokens alike. The router's gradient from a rank's own groups is its
    part of a sum (``Partial``)."""
    B, S, _ = x.shape
    G, cap = _groups(cfg, B * S)
    return ctx.on_local_shards(_dispatch_rows, [(x, 0, None), (params["router"], None, None)],
                               [(0, None)] * 4, cfg, cap, B * S // G, groups=G)


def moe(params: Params, x: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """Returns (y, aux_loss). Tokens are routed top-k into per-expert
    capacity buffers per group of ``T // G`` tokens (:func:`route`);
    over-capacity pairs are dropped (the residual carries them). The
    shared expert is added after.

    Over a mesh the three expert products run on DTensors under the
    weights' layouts (see the module docstring), and the combine's gather
    runs group-local again, on the expert outputs in the slots' layout."""
    B, S, _ = x.shape
    cd = dtype_of(cfg.compute_dtype)
    G, _ = _groups(cfg, B * S)
    eb, dest, gate, aux = route(params, x, cfg)
    aux = aux.mean()
    eb = ctx.constrain(eb, "moe_eb")

    act = _act(cfg)
    g = ctx.constrain(act(torch.einsum("gecd,edf->gecf", eb, params["w_gate"].to(cd))),
                      "moe_hidden")
    u = ctx.constrain(torch.einsum("gecd,edf->gecf", eb, params["w_up"].to(cd)), "moe_hidden")
    out = ctx.constrain(torch.einsum("gecf,efd->gecd", g * u, params["w_down"].to(cd)),
                        "moe_eb")

    y = ctx.on_local_shards(_combine_rows, [(dest, 0, None), (out, 0, None), (gate, 0, None)],
                            (0, None), S, groups=G)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg)
    return y, aux
