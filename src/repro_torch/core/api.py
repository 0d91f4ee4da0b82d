"""popt4jlib top-level API in PyTorch (counterpart of ``repro.core.api``).

  OptimizerIntf.minimize(f)  -> Optimizer.minimize(f, key) -> OptimizeResult
  PairObjDouble              -> OptimizeResult(arg, value, ...)

The service types (``OptRequest``/``OptResponse``) and ``ObserverHub`` come
with the service layer in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import torch

from repro_torch.functions.benchmarks import Function


@dataclasses.dataclass
class OptimizeResult:
    """popt4jlib ``PairObjDouble``: best argument + value, plus run accounting.
    ``arg`` and ``history`` are host (numpy) arrays."""

    arg: Any                   # best argument found, shape (dim,)
    value: float               # f(arg)
    n_evals: int = 0           # function evaluations consumed (Fig. 4 budget unit)
    n_gens: int = 0
    history: Any = None        # per-sync-round incumbent trace


class Optimizer(Protocol):
    """popt4jlib ``OptimizerIntf``."""

    def minimize(self, f: Function, key: torch.Tensor) -> OptimizeResult:
        """Minimize objective ``f`` from PRNG ``key``; reproducible."""
        ...


def lexi_min(val_a: torch.Tensor, arg_a: torch.Tensor, val_b: torch.Tensor,
             arg_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(value, arg) pairwise min by value — the incumbent-merge primitive.
    Ties go to ``a``."""
    take_a = val_a <= val_b
    return (torch.where(take_a, val_a, val_b),
            torch.where(take_a[..., None], arg_a, arg_b))
