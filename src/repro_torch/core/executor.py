"""Batch function evaluation — popt4jlib ``parallel.distributed`` in PyTorch.

Counterpart of ``repro.core.executor``. The Java library re-submits a failed
batch once and drops what fails twice; here:

  * retry-once-then-evict -> non-finite results are re-evaluated once on a
                             slightly perturbed argument; still-bad results
                             become +inf (evicted from selection).

The *evaluation backend* — how a batch of candidates becomes fitness — is
pluggable:

  * ``torch``  the objective's batched PyTorch definition; works for every
               function (the counterpart of the JAX package's ``xla``).
  * ``cuda``   the hand-written ``bench_eval`` kernel, for functions with an
               entry in ``kernels.registry`` (the counterpart of ``pallas``).
               On a CPU tensor the kernel wrapper runs its plain version.

The population axis is not sharded in this slice (no mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.functions.benchmarks import Function
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.bench_eval import bench_eval as _bench_eval

Tensor = torch.Tensor

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """How candidate batches are evaluated: backend choice and retry policy."""

    backend: str = "torch"        # evaluation backend: "torch" | "cuda"
    retry_bad: bool = True        # paper: resubmit a failed batch once
    retry_eps: float = 1e-6       # perturbation used for the retry evaluation


def _make_eval_once(f: Function, cfg: ExecutorConfig) -> Callable[[Tensor], Tensor]:
    """Resolve the evaluation backend for ``f``."""
    if cfg.backend == "torch":
        return f.fn
    if cfg.backend == "cuda":
        spec = kreg.get_spec(f.name)   # KeyError for unregistered functions

        def eval_cuda(pop: Tensor) -> Tensor:
            return _bench_eval(pop, spec.eval_tag, shift=f.shift_on(pop.device),
                               bias=f.bias)

        return eval_cuda
    raise ValueError(f"unknown backend {cfg.backend!r}; expected one of {BACKENDS}")


# Evaluator cache keyed by Function.cache_token() (a GC-stable identity token
# plus the shift content) and the config, so repeated builds for one
# objective return the same callable. FIFO-capped: keys can come from
# requests, so a hostile mix must rebuild rather than grow memory.
_EVALUATOR_CACHE: dict[tuple, tuple] = {}
_EVALUATOR_CACHE_MAX = 256


def make_batch_evaluator(
    f: Function, cfg: ExecutorConfig = ExecutorConfig(),
) -> Callable[[Tensor], Tensor]:
    """Return ``evaluate(pop: (N, D)) -> (N,)`` with the executor semantics
    above, memoized on ``(objective identity, cfg)``.

    With ``retry_bad`` every call evaluates twice — the batch and the whole
    batch perturbed by ``retry_eps`` — and keeps the retry only on rows that
    were non-finite, exactly as the JAX executor does; deciding on the host
    which rows to retry would cost a device synchronisation per call.
    """
    ck = (*f.cache_token(), cfg)
    hit = _EVALUATOR_CACHE.get(ck)
    if hit is not None and hit[0] is f.fn:
        return hit[1]

    _eval_once = _make_eval_once(f, cfg)

    def evaluate(pop: Tensor) -> Tensor:
        fit = _eval_once(pop)
        if cfg.retry_bad:
            bad = ~torch.isfinite(fit)
            # Retry the failed "batch" once on a perturbed argument (the
            # analogue of handing the task to another worker).
            retried = _eval_once(pop + cfg.retry_eps)
            fit = torch.where(bad, retried, fit)
            # Second failure -> evict from the candidate pool.
            fit = torch.where(torch.isfinite(fit), fit, torch.inf)
        return fit

    _cache_put(ck, (f.fn, evaluate))
    return evaluate


def _cache_put(key: tuple, val: tuple) -> None:
    _EVALUATOR_CACHE[key] = val
    while len(_EVALUATOR_CACHE) > _EVALUATOR_CACHE_MAX:
        _EVALUATOR_CACHE.pop(next(iter(_EVALUATOR_CACHE)))
