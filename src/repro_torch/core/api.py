"""popt4jlib top-level API in PyTorch (counterpart of ``repro.core.api``).

  OptimizerIntf.minimize(f)  -> Optimizer.minimize(f, key) -> OptimizeResult
  PairObjDouble              -> OptimizeResult(arg, value, ...)

  SubjectIntf/ObserverIntf    -> ObserverHub

The service types (``OptRequest``/``OptResponse``) come with the service
layer in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol

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


class ObserverHub:
    """Observer design pattern (popt4jlib SubjectIntf/ObserverIntf).

    Incumbent sharing between islands happens inside the engine; *this*
    class is the host-side coupling between different optimizers (e.g. a
    DGA subject notifying an FCG local-search observer whenever a new
    incumbent appears — the paper's §IV.B coupling).
    """

    def __init__(self) -> None:
        self._observers: list[Callable[[Any, float], tuple[Any, float] | None]] = []
        self.best_arg: Any = None
        self.best_val: float = float("inf")

    def register(self, fn: Callable[[Any, float], tuple[Any, float] | None]) -> None:
        """Attach an observer; it may return a refined (arg, value) or None."""
        self._observers.append(fn)

    def notify(self, arg: Any, value: float) -> tuple[Any, float]:
        """Called by a subject when it finds a new incumbent. Observers may
        refine it (local search) and return an improved (arg, value)."""
        if value < self.best_val:
            self.best_arg, self.best_val = arg, float(value)
            for obs in self._observers:
                out = obs(arg, value)
                if out is not None and float(out[1]) < self.best_val:
                    self.best_arg, self.best_val = out[0], float(out[1])
        return self.best_arg, self.best_val


def lexi_min(val_a: torch.Tensor, arg_a: torch.Tensor, val_b: torch.Tensor,
             arg_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(value, arg) pairwise min by value — the incumbent-merge primitive.
    Ties go to ``a``."""
    take_a = val_a <= val_b
    return (torch.where(take_a, val_a, val_b),
            torch.where(take_a[..., None], arg_a, arg_b))
