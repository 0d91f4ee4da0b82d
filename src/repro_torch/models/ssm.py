"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

Counterpart of ``repro.models.ssm``, with the same split projections
(z, x, B, C, dt). The prefill forward runs the SSD scan through the
``ssd_scan`` kernel (its plain version on a CPU tensor), where the JAX
package computes the chunked form in XLA (``_ssd_chunked``): one function.
The kernel reads the one B/C group per batch row for all heads. Decode is
the O(1) recurrent form, ``state <- state * exp(dt*A) + dt * B outer x``,
in PyTorch.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, inv_sqrt, normal_leaf
from repro_torch.parallel import ctx

Tensor = torch.Tensor
Params = dict[str, Any]


def init_ssm(key: Tensor, cfg: ModelConfig) -> Params:
    """``key`` ``(..., 2)``: leading key axes (the layer axis) lead every
    leaf, as under ``vmap``; every leaf in ``cfg.param_dtype``."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ks = prng.split(key, 8)
    lead = tuple(key.shape[:-1])
    dev, dt = key.device, dtype_of(cfg.param_dtype)
    s = inv_sqrt(d)

    def const(v: np.ndarray) -> Tensor:
        t = torch.from_numpy(v.astype(np.float32)).to(dt)
        return t.to(dev).expand(*lead, -1).clone()

    def zeros(m: int) -> Tensor:
        return torch.zeros((*lead, m), dtype=dt, device=dev)

    # A_log = log(linspace(1, 16, h)) and dt_bias = log(expm1(0.01)) in
    # float32, each step rounded once from float64.
    lin = np.linspace(np.float32(1.0), np.float32(16.0), h, dtype=np.float32)
    dt_bias = np.log(np.expm1(np.float64(np.float32(0.01)))).astype(np.float32)
    return {
        "w_z": normal_leaf(ks[..., 0, :], (d, di), s, dt),
        "w_x": normal_leaf(ks[..., 1, :], (d, di), s, dt),
        "w_B": normal_leaf(ks[..., 2, :], (d, n), s, dt),
        "w_C": normal_leaf(ks[..., 3, :], (d, n), s, dt),
        "w_dt": normal_leaf(ks[..., 4, :], (d, h), s, dt),
        "conv_x": normal_leaf(ks[..., 5, :], (cfg.ssm_conv, di), 0.5, dt),
        "conv_B": normal_leaf(ks[..., 6, :], (cfg.ssm_conv, n), 0.5, dt),
        "conv_C": normal_leaf(ks[..., 7, :], (cfg.ssm_conv, n), 0.5, dt),
        "conv_bias_x": zeros(di),
        "conv_bias_B": zeros(n),
        "conv_bias_C": zeros(n),
        "A_log": const(np.log(lin.astype(np.float64))),
        "D": const(np.ones(h)),
        "dt_bias": const(np.full(h, dt_bias)),
        "norm_scale": zeros(di),
        "w_out": normal_leaf(key, (di, d), inv_sqrt(di), dt),
    }


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, state: Tensor | None = None):
    """Depthwise causal conv, kernel (K, C), x (B, S, C). Returns (y, new_state)
    where state is the last K-1 inputs (decode cache)."""
    K = w.shape[0]
    if state is None:
        pad = ctx.like(torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                                   device=x.device), x)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)            # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K)) + b
    return F.silu(y), xp[:, -(K - 1):, :]


def _ssd(xh: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, Q: int):
    """xh (B, S, H, P); dt (B, S, H) float32; A (H,); Bm/Cm (B, S, N), one
    group. Returns y (B, S, H, P) from the ``ssd_scan`` kernel on
    (B*H, S, P) rows, row b*H + h reading B/C row b. DTensors go to the
    kernel as each rank's own batch rows and heads, B/C whole on every
    head shard (``ctx.on_local_shards``)."""
    return ctx.on_local_shards(_ssd_local, [(xh, 0, 2), (dt, 0, 2), (A, None, 0),
                                            (Bm, 0, None), (Cm, 0, None)], (0, 2), Q)


def _ssd_local(xh: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, Q: int):
    Bsz, S, H, P = xh.shape
    y = ssd_scan(xh.permute(0, 2, 1, 3).reshape(Bsz * H, S, P).contiguous(),
                 dt.permute(0, 2, 1).reshape(Bsz * H, S).contiguous(),
                 A.repeat(Bsz).contiguous(), Bm.contiguous(), Cm.contiguous(),
                 chunk=Q)
    return y.reshape(Bsz, H, S, P).permute(0, 2, 1, 3)


def _gated_norm_out(params: Params, y: Tensor, z: Tensor, cfg: ModelConfig) -> Tensor:
    cd = dtype_of(cfg.compute_dtype)
    y = (y * F.silu(z)).to(cd)
    var = torch.mean(torch.square(y).float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + cfg.norm_eps).to(cd)
    y = (y * inv) * (1.0 + params["norm_scale"].to(cd))
    return y @ params["w_out"].to(cd)


def _projections(params: Params, x: Tensor, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    z = x @ params["w_z"].to(cd)
    xi = x @ params["w_x"].to(cd)
    Bm = x @ params["w_B"].to(cd)
    Cm = x @ params["w_C"].to(cd)
    dt = _softplus((x @ params["w_dt"].to(cd)).float() + params["dt_bias"].float())
    return z, xi, Bm, Cm, dt


def ssm_block(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Training/prefill forward. x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    cd = dtype_of(cfg.compute_dtype)
    z, xi, Bm, Cm, dt = _projections(params, x, cfg)
    xi, _ = _causal_conv(xi, params["conv_x"].to(cd), params["conv_bias_x"].to(cd))
    Bm, _ = _causal_conv(Bm, params["conv_B"].to(cd), params["conv_bias_B"].to(cd))
    Cm, _ = _causal_conv(Cm, params["conv_C"].to(cd), params["conv_bias_C"].to(cd))
    xi = xi.reshape(B, S, h, p)
    A = -torch.exp(params["A_log"].float())
    y = _ssd(xi, dt, A, Bm, Cm, min(cfg.ssm_chunk, S))
    y = y + params["D"].to(cd)[None, None, :, None] * xi
    return _gated_norm_out(params, y.reshape(B, S, di), z, cfg)


def ssm_decode_step(params: Params, x: Tensor, cfg: ModelConfig,
                    conv_state: Tensor, ssd_state: Tensor):
    """Single-token recurrent step. x: (B, 1, D).
    conv_state: (B, K-1, di + 2N); ssd_state: (B, H, N, P) float32."""
    B = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cd = dtype_of(cfg.compute_dtype)
    z, xi, Bm, Cm, dt = _projections(params, x, cfg)
    cs_x, cs_B, cs_C = (conv_state[..., :di], conv_state[..., di:di + n],
                        conv_state[..., di + n:])
    xi, cs_x = _causal_conv(xi, params["conv_x"].to(cd), params["conv_bias_x"].to(cd), cs_x)
    Bm, cs_B = _causal_conv(Bm, params["conv_B"].to(cd), params["conv_bias_B"].to(cd), cs_B)
    Cm, cs_C = _causal_conv(Cm, params["conv_C"].to(cd), params["conv_bias_C"].to(cd), cs_C)
    conv_state = torch.cat([cs_x.to(cd), cs_B.to(cd), cs_C.to(cd)], dim=-1)

    xi = xi.reshape(B, h, p)
    Bm1, Cm1 = Bm[:, 0], Cm[:, 0]                      # (B, N)
    A = -torch.exp(params["A_log"].float())
    dt1 = dt[:, 0]                                     # (B, H)
    dA = torch.exp(dt1 * A[None, :])
    upd = torch.einsum("bn,bhp->bhnp", Bm1.float(), (xi * dt1[..., None].to(cd)).float())
    ssd_state = ssd_state * dA[:, :, None, None] + upd
    y = torch.einsum("bhnp,bn->bhp", ssd_state, Cm1.float()).to(cd)
    y = y + params["D"].to(cd)[None, :, None] * xi
    return _gated_norm_out(params, y.reshape(B, 1, di), z, cfg), conv_state, ssd_state
