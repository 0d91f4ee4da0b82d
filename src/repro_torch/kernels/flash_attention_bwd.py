"""The gradient of streaming-softmax attention: the ``flash_attention_bwd``
CUDA kernel and its plain version.

The JAX package has no backward kernel (its training path differentiates
jnp attention); the port's models send attention through the
``flash_attention`` kernel, whose gradient on the card is this kernel
(``csrc/flash_attention_bwd.cu``): from q, k, v, the forward's output and
row log-sum-exp, and the output's gradient, it returns dq, dk, dv in q's
type, computed in float32 with the forward's causal, window and softcap
masks, without atomics (two runs give the same bits). The plain version is
autograd of :func:`repro_torch.kernels.flash_attention.flash_attention_ref`,
as ``jax.grad`` of ``repro.kernels.ref.flash_attention_ref`` is the
reference's. ``flash_attention``'s autograd function calls
:func:`flash_attention_bwd`; a CPU tensor goes to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, check_inputs,
                                                 flash_attention_ref, scale_of)

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def flash_attention_bwd_ref(q, k, v, dout, *, causal=True, window=0, softcap=0.0):
    """Plain PyTorch version: autograd of the plain forward. Returns
    (dq, dk, dv) in the inputs' types."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*ins, causal=causal, window=window, softcap=softcap)
        return torch.autograd.grad(out, ins, dout)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True, window=0, softcap=0.0):
    """q, out, dout ``(BH, S, hd)``; k, v ``(BH, T, hd)``, float32 or
    bfloat16; lse ``(BH, S)`` float32, the forward's row log-sum-exp (unread
    on the CPU, as is ``out``). Returns (dq, dk, dv) in q's type."""
    if not _build.on_card("flash_attention_bwd", q, dims=(3,)):
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal, window=window,
                                       softcap=softcap)
    check_inputs(q, k, v)
    BH, S, hd = q.shape
    T = k.shape[1]
    dev = q.device
    _build.check_inputs(dev, ("out", out, (BH, S, hd)), ("dout", dout, (BH, S, hd)),
                        dtype=q.dtype)
    _build.check_inputs(dev, ("lse", lse, (BH, S)))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    D = torch.empty((BH, S), dtype=torch.float32, device=dev)
    global LAUNCHES
    _build.launch("flash_attention_bwd", dev, q, k, v, out, dout, lse, D, dq, dk, dv,
                  BH, S, T, hd, DTYPES[q.dtype], scale_of(hd), int(bool(causal)),
                  max(int(window), 0), float(softcap))
    LAUNCHES += 1
    return dq, dk, dv
