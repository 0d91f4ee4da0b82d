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
               ``ExecutorConfig.kernel`` (a ``kernels.autotune.KernelConfig``:
               the storage type and geometry) reaches it, and, through the
               engine, every fused generation kernel.

Over a mesh (``core.mesh``: one process per rank) the population can be
split as the Java library splits a batch into equal chunks, one per worker:
``make_batch_evaluator(f, cfg, group)`` pads the rows to a multiple of the
ranks, evaluates this rank's block and all-gathers the fitness, so every
rank holds the whole ``(P,)`` result. :func:`distributed_map_reduce` is the
library's map/reduce operator over ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import mesh
from repro_torch.functions.benchmarks import Function
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.bench_eval import bench_eval as _bench_eval

Tensor = torch.Tensor

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """How candidate batches are evaluated: backend choice and retry policy,
    and the kernel configuration."""

    backend: str = "torch"        # evaluation backend: "torch" | "cuda"
    retry_bad: bool = True        # paper: resubmit a failed batch once
    retry_eps: float = 1e-6       # perturbation used for the retry evaluation
    # One KernelConfig threaded to every kernel this config touches: the
    # cuda evaluation backend here and the fused generation kernels the
    # engine builds (islands and portfolios inject it into the makers).
    # Unset geometry fields are tuned per shape class by kernels.autotune.
    kernel: KernelConfig = KernelConfig()


def _make_eval_once(f: Function, cfg: ExecutorConfig) -> Callable[[Tensor], Tensor]:
    """Resolve the evaluation backend for ``f``."""
    if cfg.backend == "torch":
        return f.fn
    if cfg.backend == "cuda":
        spec = kreg.get_spec(f.name)   # KeyError for unregistered functions

        def eval_cuda(pop: Tensor) -> Tensor:
            return _bench_eval(pop, spec.eval_tag, shift=f.shift_on(pop.device),
                               bias=f.bias, kernel_cfg=cfg.kernel)

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
    group: mesh.Group | None = None,
) -> Callable[[Tensor], Tensor]:
    """Return ``evaluate(pop: (N, D)) -> (N,)`` with the executor semantics
    above, memoized on ``(objective identity, cfg, group)``. With a
    ``group`` of more than one rank, every rank calls it on the same rows
    and evaluates only its block of them.

    With ``retry_bad`` every call evaluates twice — the batch and the whole
    batch perturbed by ``retry_eps`` — and keeps the retry only on rows that
    were non-finite, exactly as the JAX executor does; deciding on the host
    which rows to retry would cost a device synchronisation per call.
    """
    ck = (*f.cache_token(), cfg, group)
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

    if group is not None and group.size > 1:
        evaluate = _sharded_rows(evaluate, group)
    _cache_put(ck, (f.fn, evaluate))
    return evaluate


def _sharded_rows(evaluate: Callable[[Tensor], Tensor],
                  group: mesh.Group) -> Callable[[Tensor], Tensor]:
    """``evaluate`` with the rows split over ``group``: zero rows pad ``N``
    to a multiple of the ranks, each rank evaluates its block (copied into
    its own allocation, so the kernel sees the alignment an unsplit batch
    has) and the fitness is all-gathered in rank order."""
    def sharded(pop: Tensor) -> Tensor:
        n = pop.shape[0]
        pad = (-n) % group.size
        if pad:
            pop = torch.cat([pop, pop.new_zeros((pad, *pop.shape[1:]))])
        block = mesh.local_rows(pop, group.rank, pop.shape[0] // group.size).clone()
        return mesh.all_gather_rows(evaluate(block), group)[:n]

    return sharded


def _cache_put(key: tuple, val: tuple) -> None:
    _EVALUATOR_CACHE[key] = val
    while len(_EVALUATOR_CACHE) > _EVALUATOR_CACHE_MAX:
        _EVALUATOR_CACHE.pop(next(iter(_EVALUATOR_CACHE)))


def distributed_map_reduce(m: mesh.Mesh, axis: str, map_fn: Callable[[Tensor], Tensor],
                           reduce_op: str, xs: Tensor) -> Tensor:
    """popt4jlib's distributed map/reduce operator over mesh ``m`` (from
    ``MeshConfig.build``): each rank maps ``map_fn`` (over one row, batched
    with ``torch.vmap``) over its block of the leading axis of ``xs``, which
    must split evenly over the ranks, reduces its block with ``reduce_op``
    (``sum`` | ``min`` | ``max``), and the blocks are reduced across ranks
    (the accumulator server). Inside a group of ``m.devices`` ranks every
    rank returns the value; a single process spawns the ranks (``map_fn``
    must then be importable). ``min`` and ``max`` are exact; ``sum`` adds
    in another order than one unsplit sum, which float32 rounding can tell
    apart."""
    if axis != m.axis:
        raise ValueError(f"mesh axis is {m.axis!r}, not {axis!r}")
    if reduce_op not in ("sum", "min", "max"):
        raise ValueError(f"unknown reduce op {reduce_op!r}; expected sum, min or max")
    if xs.shape[0] % m.devices:
        raise ValueError(f"{xs.shape[0]} rows do not split evenly over {m.devices} ranks")
    group = m.local_group()
    if group is not None:
        return _map_reduce(group, map_fn, reduce_op, xs)
    out = mesh.spawn(m.devices, _map_reduce_rank, m, map_fn, reduce_op,
                     xs.cpu(), xs.device, backend=m.backend)
    return out.to(xs.device)


def _map_reduce(group: mesh.Group, map_fn: Callable[[Tensor], Tensor],
                reduce_op: str, xs: Tensor) -> Tensor:
    local = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}[reduce_op]
    chunk = mesh.local_rows(xs, group.rank, xs.shape[0] // group.size)
    return mesh.all_reduce(local(torch.vmap(map_fn)(chunk), dim=0), reduce_op, group)


def _map_reduce_rank(m: mesh.Mesh, map_fn, reduce_op: str, xs: Tensor, device) -> Tensor:
    """A spawned rank of :func:`distributed_map_reduce`: ``xs`` on this
    rank's device, the result on the CPU."""
    group = m.local_group()
    return _map_reduce(group, map_fn, reduce_op, xs.to(mesh.rank_device(device, group))).cpu()
