"""popt4jlib top-level API in PyTorch (counterpart of ``repro.core.api``).

  OptimizerIntf.minimize(f)  -> Optimizer.minimize(f, key) -> OptimizeResult
  PairObjDouble              -> OptimizeResult(arg, value, ...)

  SubjectIntf/ObserverIntf    -> ObserverHub
  PDBTExecSingleCltWrkInitSrv -> OptRequest / OptResponse (the service's
                                 client protocol as data, see
                                 core.scheduler and launch.opt_serve)

The service types keep the reference's fields, defaults and key order, so
that a client cannot tell the two servers apart on the wire; request
backends keep the reference's names (``xla``, ``pallas``), which
``core.scheduler`` maps to the port's executor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol

import numpy as np
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


# ---------------------------------------------------------------------------
# Multi-job service types — the popt4jlib ``PDBTExecSingleCltWrkInitSrv``
# client protocol as data. A client submits OptRequests; the scheduler
# buckets them by shape-class and runs each bucket as one jobs-axis run.
# ---------------------------------------------------------------------------

SHAPE_CLASS_FIELDS = (
    "fn", "algo", "dim", "pop", "n_islands", "sync_every", "migration",
    "n_migrants", "share_incumbent", "max_evals", "backend", "devices",
    "params", "polish", "polish_every", "polish_topk", "polish_steps",
    "portfolio", "sync_policy", "max_staleness", "warm",
)


def _freeze(v: Any) -> Any:
    """Recursively freeze JSON values into hashable form: dicts become sorted
    pair-tuples, lists become tuples — so nested per-policy portfolio params
    survive ``shape_class()``'s use as a dict key."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class OptRequest:
    """One optimization job (a Java ``TaskObject`` batch submitted to
    ``PDBatchTaskExecutorSrv``). Every field except ``seed`` is part of the
    shape-class (:meth:`shape_class`): two requests that differ only by
    seed run as jobs of one bucket."""

    fn: str                         # objective name in functions.FUNCTIONS
    algo: str = "de"                # key into core.ALGORITHMS
    dim: int = 10
    max_evals: int = 10_000         # Fig. 4 budget unit
    seed: int = 0
    pop: int = 64
    n_islands: int = 1
    sync_every: int = 10
    migration: str = "ring"
    n_migrants: int = 2
    share_incumbent: bool = False
    backend: str = "xla"            # xla | pallas (the port also takes torch | cuda)
    devices: int = 1                # ranks the islands shard over (core/mesh.py)
    params: tuple[tuple[str, Any], ...] = ()  # extra algo kwargs, hashable
    polish: str = "none"            # none | asd | fcg | avd | bfgs
    polish_every: int = 1           # sync rounds between polish events
    polish_topk: int = 4            # per-island candidates polished per event
    polish_steps: int = 3           # descent iterations per polish event
    portfolio: tuple[str, ...] = ()  # per-island policies
    sync_policy: str = "barrier"    # barrier | async
    max_staleness: int = 0
    # Warm-start immigrants, the federation hop (launch/federate.py): adopted
    # into island 0's worst slots before round 0. Value-keyed into the
    # shape-class, so every job of a bucket shares one warm batch.
    warm: tuple[tuple[float, ...], ...] = ()

    def shape_class(self) -> tuple:
        """Bucket key: everything but the seed. In portfolio mode ``algo``
        is unused, so it is normalized out of the key."""
        return tuple(
            "" if n == "algo" and self.portfolio else getattr(self, n)
            for n in SHAPE_CLASS_FIELDS)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "OptRequest":
        d = dict(d)
        # JSON delivers dicts/lists; freeze both recursively so the request
        # stays hashable (shape_class is a dict key in the scheduler).
        params = _freeze(d.pop("params", ()))
        if "portfolio" in d:
            d["portfolio"] = tuple(d["portfolio"])
        if "warm" in d:
            d["warm"] = tuple(
                tuple(float(x) for x in row) for row in d["warm"])
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown OptRequest fields: {sorted(unknown)}")
        return cls(params=params, **d)


@dataclasses.dataclass
class OptResponse:
    """Job envelope the service hands back on poll/result: lifecycle status,
    streamed per-round progress while the job's bucket runs, and the
    ``OptimizeResult`` once it finishes. A ``cancelled`` job carries a
    *partial* result — the incumbent at the round boundary where the
    cancellation took effect."""

    job_id: str
    status: str = "queued"          # queued | running | done | error | cancelled
    result: OptimizeResult | None = None
    error: str | None = None
    # Streaming progress (host-stepped bucket runs update these every sync
    # round; pollers read them lock-free — each field is one GIL-atomic write)
    round: int | None = None        # sync rounds completed so far
    n_rounds: int | None = None     # total rounds this run will execute
    best_val: float | None = None   # current global incumbent value
    evals_done: int | None = None   # evaluations consumed so far

    def progress_dict(self) -> dict[str, Any]:
        """The streamed-progress fields that are set, as a JSON-able dict."""
        out: dict[str, Any] = {}
        for k in ("round", "n_rounds", "best_val", "evals_done"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    def to_dict(self) -> dict[str, Any]:
        """JSONL-serializable reply for the service's result/poll ops."""
        out: dict[str, Any] = {"id": self.job_id, "status": self.status}
        if self.error is not None:
            out["error"] = self.error
        out.update(self.progress_dict())
        if self.result is not None:
            out.update(
                value=self.result.value,
                n_evals=self.result.n_evals,
                n_gens=self.result.n_gens,
                arg=[float(v) for v in np.asarray(self.result.arg).ravel()],
            )
        return out


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
