"""The gradient of streaming-softmax attention: the ``flash_attention_bwd``
CUDA kernels and their plain version.

The JAX package has no backward kernel (its training path differentiates
jnp attention); the port's models send attention through the
``flash_attention`` kernel, whose gradient on the card is a kernel too: from
q, k, v, the forward's output and row log-sum-exp, and the output's
gradient, it returns dq, dk, dv in q's type with the forward's causal,
window and softcap masks, without atomics (two runs give the same bits).
A CPU tensor goes to the plain version, autograd of
:func:`repro_torch.kernels.flash_attention.flash_attention_ref`, as
``jax.grad`` of ``repro.kernels.ref.flash_attention_ref`` is the
reference's. A CUDA tensor goes to a kernel by this rule:

- bfloat16 at head dims up to ``TC_MAX_HEAD_DIM`` (128): the tensor-core
  kernel in ``csrc/flash_attention_bwd_tc.cu`` (wgmma; P and dS enter
  their products as bfloat16, every sum in float32), counted in
  ``TC_LAUNCHES``;
- bfloat16 at head dims 129-256: the CUDA-core kernel in
  ``csrc/flash_attention_bwd.cu`` (float32 arithmetic), since dK and dV of
  a 64-key tile at m64n256 would need 256 accumulator registers a thread;
- float32: the same CUDA-core kernel, whose float32 arithmetic the float32
  bound of 1e-4 needs.

A ``meta`` tensor gets empty gradients and a tally of the kernel's work
(``kernels.meta``). A launch that fails raises; nothing falls back to
another kernel or to the plain version. ``flash_attention``'s autograd
function calls :func:`flash_attention_bwd`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.flash_attention import (DTYPES, check_inputs,
                                                 flash_attention_ref, scale_of)

# Kernel launches in this process (plain-version calls are not counted), and
# those of them that went to the tensor-core kernel.
LAUNCHES = 0
TC_LAUNCHES = 0

# Largest head dim of the tensor-core route.
TC_MAX_HEAD_DIM = 128


def uses_tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    """Whether a CUDA input of ``dtype`` and head dim ``hd`` goes to the
    tensor-core kernel."""
    return dtype == torch.bfloat16 and hd <= TC_MAX_HEAD_DIM


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
    if not (_build.on_meta("flash_attention_bwd", q, dims=(3,))
            or _build.on_card("flash_attention_bwd", q, dims=(3,))):
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
    if dev.type == "meta":
        meta.tally("flash_attention_bwd", *meta.flash_bwd_work(
            BH, S, T, hd, q.element_size(), bool(causal), max(int(window), 0)))
        return dq, dk, dv
    D = torch.empty((BH, S), dtype=torch.float32, device=dev)
    mask = (int(bool(causal)), max(int(window), 0), float(softcap))
    global LAUNCHES, TC_LAUNCHES
    if uses_tensor_cores(q.dtype, hd):
        _build.launch("flash_attention_bwd_tc", dev, q, k, v, out, dout, lse, D, dq, dk, dv,
                      BH, S, T, hd, scale_of(hd), *mask)
        TC_LAUNCHES += 1
    else:
        _build.launch("flash_attention_bwd", dev, q, k, v, out, dout, lse, D, dq, dk, dv,
                      BH, S, T, hd, DTYPES[q.dtype], scale_of(hd), *mask)
    LAUNCHES += 1
    return dq, dk, dv
