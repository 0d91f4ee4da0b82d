"""Parallel gradient approximation — popt4jlib's ``analysis`` package
(counterpart of ``repro.optim.numgrad``).

The paper: "Methods requiring derivative information use Richardson's 4th
order extrapolation, and every function evaluation needed for the estimation
of the derivative counts towards the limit on function evaluations."

Richardson 4th-order central difference:
    f'(x) ~ [8 (f(x+h) - f(x-h)) - (f(x+2h) - f(x-2h))] / (12 h)
i.e. 4 evaluations per dimension, all 4*D probe points in one batched call
of the objective. The division is a product with ``1/(12h)`` rounded to
float32, as XLA divides by a constant (``repro_torch.f32``).

``mode="autodiff"`` is the beyond-paper option, charged as 2
evaluation-equivalents (the reverse-mode cost model); it differentiates the
objective's plain PyTorch definition with ``torch.func.grad``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import f32

Tensor = torch.Tensor


def richardson(fp: Tensor, fm: Tensor, fp2: Tensor, fm2: Tensor, h: float) -> Tensor:
    """The Richardson combination of the four probe values, as XLA rounds
    it: ``(8 (fp - fm) - (fp2 - fm2)) * (1 / (12 h))``."""
    return (8.0 * (fp - fm) - (fp2 - fm2)) * f32.const(1.0 / f32.const(12.0 * h))


def richardson_grad(f: Callable[[Tensor], Tensor], x: Tensor, h: float = 1e-4):
    """Return (grad, n_evals) at ``x`` ``(D,)``: 4*D evaluations in one
    batched call of ``f`` (which maps ``(N, D)`` to ``(N,)``)."""
    d = x.shape[-1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    probes = torch.cat([x + f32.const(h) * eye, x - f32.const(h) * eye,
                        x + f32.const(2 * h) * eye, x - f32.const(2 * h) * eye])
    fp, fm, fp2, fm2 = torch.chunk(f(probes), 4)
    return richardson(fp, fm, fp2, fm2, h), 4 * d


def make_grad(f: Callable[[Tensor], Tensor], mode: str = "richardson", h: float = 1e-4):
    """Return ``grad_fn(x) -> (g, n_evals)`` under the chosen cost model."""
    if mode == "richardson":
        return lambda x: richardson_grad(f, x, h)
    if mode == "autodiff":
        gf = torch.func.grad(f)
        return lambda x: (gf(x), 2)
    raise ValueError(f"unknown grad mode {mode!r}")
