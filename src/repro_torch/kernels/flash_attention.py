"""Streaming-softmax attention: the ``flash_attention`` CUDA kernel and its
plain version.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas kernel) and of
``repro.kernels.ref.flash_attention_ref``: causal, sliding-window and
softcapped attention of q ``(BH, S, hd)`` over k, v ``(BH, T, hd)`` with the
KV heads already expanded, computed in float32 and returned in q's type.
A CPU tensor goes to :func:`flash_attention_ref`. A CUDA tensor goes to a
kernel chosen by its type: bfloat16 to the tensor-core kernel in
``csrc/flash_attention_tc.cu`` (wgmma; P enters P V as bfloat16), float32
to the CUDA-core kernel in ``csrc/flash_attention.cu``, whose float32
arithmetic the float32 bound of 2e-6 needs. A ``meta`` tensor takes the
card's route, autograd included, up to the launch, which it replaces by a
tally of the kernel's work (``kernels.meta``).

On the card the wrapper takes part in autograd: when grad is enabled and
an input requires it, the forward kernel also writes each row's float32
log-sum-exp, and the backward is the ``flash_attention_bwd`` kernel
(``kernels/flash_attention_bwd.py``). Without grad nothing is saved. On
the CPU the plain version is differentiated by autograd.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, meta

# Kernel launches in this process (plain-version calls are not counted), and
# those of them that went to the tensor-core (bfloat16) kernel.
LAUNCHES = 0
TC_LAUNCHES = 0

# Element types the kernel takes, by the code its C entry expects.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
NEG_INF = -1e30


def scale_of(hd: int) -> float:
    """``1 / sqrt(hd)`` as the float32 the reference multiplies by."""
    return float(np.float32(1.0 / (hd ** 0.5)))


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Plain PyTorch version: one float32 softmax over all T keys."""
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bsh,bth->bst", q.float(), k.float()) * scale_of(q.shape[-1])
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,bth->bsh", p, v.float()).to(q.dtype)


def check_inputs(q, k, v) -> None:
    """Raise ValueError unless the kernels take q, k, v on the card."""
    BH, S, hd = q.shape
    T = k.shape[1] if k.dim() == 3 else -1
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {list(DTYPES)}, got {q.dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM or T < 1:
        raise ValueError(f"flash_attention: head dim {hd} (at most "
                         f"{MAX_HEAD_DIM}) and key length {T} (at least 1)")
    _build.check_inputs(q.device, ("q", q, (BH, S, hd)), ("k", k, (BH, T, hd)),
                        ("v", v, (BH, T, hd)), dtype=q.dtype)


def _launch(q, k, v, causal, window, softcap, lse):
    """The forward kernel on checked inputs; each row's log-sum-exp into
    ``lse`` ``(BH, S)`` float32 when it is given."""
    BH, S, hd = q.shape
    T = k.shape[1]
    dev = q.device
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if dev.type == "meta":
        meta.tally("flash_attention", *meta.flash_work(
            BH, S, T, hd, q.element_size(), bool(causal), max(int(window), 0), lse is not None))
        return out
    mask = (int(bool(causal)), max(int(window), 0), float(softcap))
    global LAUNCHES, TC_LAUNCHES
    if q.dtype == torch.bfloat16:
        _build.launch("flash_attention_tc", dev, q, k, v, out, lse, BH, S, T, hd,
                      scale_of(hd), *mask)
        TC_LAUNCHES += 1
    else:
        _build.launch("flash_attention", dev, q, k, v, out, lse, BH, S, T, hd,
                      DTYPES[q.dtype], scale_of(hd), *mask)
    LAUNCHES += 1
    return out


def forward_with_lse(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The forward kernel on CUDA (or meta) tensors: (out, each row's float32
    log-sum-exp ``(BH, S)``), the backward kernel's inputs."""
    check_inputs(q, k, v)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, softcap, lse), lse


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, keeping q, k, v, the output and its row
    log-sum-exp; the backward kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = forward_with_lse(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        # Imported here: the backward module imports this one.
        from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q ``(BH, S, hd)``; k, v ``(BH, T, hd)``, float32 or bfloat16.
    Returns ``(BH, S, hd)`` in q's type, differentiable on every device."""
    if not (_build.on_meta("flash_attention", q, dims=(3,))
            or _build.on_card("flash_attention", q, dims=(3,))):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    check_inputs(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _launch(q, k, v, causal, window, softcap, None)
