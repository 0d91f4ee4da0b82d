"""float32 arithmetic rounded as the reference computes it.

XLA on the CPU contracts a multiply feeding an add into one fused
multiply-add, folds constant factors together, and divides by a constant
through its reciprocal. Where the port must give the reference's bits, it
computes such a step with one rounding: the product of two float32 values is
exact in float64, so ``a * b + c`` in float64, rounded once to float32, is
the fused result (the kernels use ``__fmaf_rn``).

Transcendentals (``log``, ``log1p``, ``exp``, ``pow``) and ``sqrt`` are
taken in float64 and rounded once. That gives the same bits on the CPU and
on the card, whose float32 libraries differ in the last place; for the
transcendentals it is within an ulp or two of XLA's own float32
approximations, not equal to them.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def const(v: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak-typed constant."""
    return float(np.float32(v))


def _f64(v: Tensor | float) -> Tensor | float:
    return v.double() if isinstance(v, Tensor) else const(v)


def fma(a: Tensor | float, b: Tensor | float, c: Tensor | float) -> Tensor:
    """``a * b + c`` with one rounding to float32 (at least one operand must
    be a tensor; float operands are rounded to float32 first)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def log(x: Tensor) -> Tensor:
    """float32 natural logarithm, rounded once from float64."""
    return torch.log(x.double()).float()


def exp(x: Tensor) -> Tensor:
    """float32 exponential, rounded once from float64."""
    return torch.exp(x.double()).float()


def sqrt(x: Tensor) -> Tensor:
    """float32 square root, correctly rounded on every device (torch's
    vectorised float32 sqrt on some CPUs is not): the float64 root of a
    float32 value rounds to the correctly rounded float32 root."""
    return torch.sqrt(x.double()).float()


def log1p(x: Tensor) -> Tensor:
    """float32 ``log(1 + x)``, rounded once from float64."""
    return torch.log1p(x.double()).float()


def pow(base: float, x: Tensor) -> Tensor:
    """float32 ``base ** x`` for a constant base, rounded once from float64."""
    return torch.pow(const(base), x.double()).float()
