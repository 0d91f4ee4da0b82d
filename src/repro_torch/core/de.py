"""DDE — island-model Differential Evolution (counterpart of ``repro.core.de``).

DE/rand/1/bin and DE/best/1/bin, with the paper's "non-determinism-ok" flag:

  barrier_mode="sync"     every trial vector of a generation reads the same
                          snapshot of the population.
  barrier_mode="chunked"  the population is updated in ``n_chunks`` blocks and
                          later blocks read earlier blocks' fresh writes — the
                          reproducible analogue of the Java threads racing on
                          the shared solution array.

``fused=True`` runs the whole generation — mutation, crossover, evaluation,
selection — in the ``de_step`` CUDA kernel (one launch for all islands) via
the engine's ``step_override`` hook. It needs DE/rand/1/bin and an objective
in ``kernels.registry``; on CPU tensors the kernel wrapper runs its plain
version. The fused path evaluates outside the executor, so it does no
retry or eviction — as in the JAX package.

Every draw follows the JAX module key for key, with islands as the leading
dimension of the key batch.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import prng
from repro_torch.core.islands import (MetaHeuristic, State, clip_box,
                                      evaluate_rows, init_state, track_best,
                                      uniform_init)
from repro_torch.functions.benchmarks import Function
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.de_step import gather_rows, mutate
from repro_torch.kernels.de_step import de_step as _de_step_kernel

Tensor = torch.Tensor


def _distinct3(keys: Tensor, P: int) -> Tensor:
    """``(3, I, P)`` donor indices per row, each != the row index (the
    mod-shift trick); one batched randint for the three draws."""
    i = torch.arange(P, device=keys.device)
    r = prng.randint(prng.split(keys, 3), (P,), 0, P - 1)       # (I, 3, P)
    return ((i + 1 + r) % P).transpose(0, 1)


def _trials(pop: Tensor, best: Tensor, keys: Tensor, w: float, px: float,
            strategy: str) -> Tensor:
    """Trial vectors ``(I, P, D)``; ``best`` is ``(I, D)``."""
    _, P, D = pop.shape
    sub = prng.split(keys, 3)                                    # (I, 3, 2)
    idx = _distinct3(sub[:, 0], P)
    base = (gather_rows(pop, idx[0]) if strategy == "rand1bin"
            else best[:, None, :].expand(pop.shape))
    mutant = mutate(base, gather_rows(pop, idx[1]), gather_rows(pop, idx[2]), w)
    # binomial crossover with a guaranteed dimension
    cross = prng.uniform(sub[:, 1], (P, D)) < px
    jrand = prng.randint(sub[:, 2], (P,), 0, D)
    cross = cross | (torch.arange(D, device=pop.device) == jrand[..., None])
    return torch.where(cross, mutant, pop)


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    w: float = 0.5,
    px: float = 0.2,
    strategy: str = "rand1bin",        # rand1bin | best1bin
    barrier_mode: str = "sync",        # sync | chunked ("non-determinism-ok")
    n_chunks: int = 8,
    fused: bool = False,               # whole generation in one kernel launch
    kernel_cfg: KernelConfig | None = None,   # the fused kernel's storage and geometry
) -> MetaHeuristic:
    """Differential Evolution per-island policy (DE/rand/1/bin, DE/best/1/bin)."""
    if strategy not in ("rand1bin", "best1bin"):
        raise ValueError(f"unknown DE strategy {strategy!r}")
    if barrier_mode not in ("sync", "chunked"):
        raise ValueError(f"unknown barrier_mode {barrier_mode!r}")
    lo, hi = f.lo, f.hi

    def evaluate(x: Tensor) -> Tensor:
        return evaluate_rows(evaluator, x)

    def init(keys: Tensor) -> State:
        p = uniform_init(keys, pop, dim, lo, hi)
        return init_state(p, evaluate(p))

    def gen_sync(state: State, keys: Tensor) -> State:
        p, fit = state["pop"], state["fit"]
        trial = clip_box(_trials(p, state["best_arg"], keys, w, px, strategy),
                         lo, hi)
        tfit = evaluate(trial)
        better = tfit <= fit
        p = torch.where(better[..., None], trial, p)
        fit = torch.where(better, tfit, fit)
        return track_best(state, p, fit)

    csz = max(1, pop // n_chunks) if barrier_mode == "chunked" else pop
    n_eff_chunks = (pop + csz - 1) // csz

    def gen_chunked(state: State, keys: Tensor) -> State:
        # Later chunks read earlier chunks' already-updated vectors.
        p, fit = state["pop"].clone(), state["fit"].clone()
        isl = torch.arange(p.shape[0], device=p.device)
        for c in range(n_eff_chunks):
            ck = prng.fold_in(keys, c)
            best = p[isl, torch.argmin(fit, dim=-1)]
            trial_all = clip_box(_trials(p, best, ck, w, px, strategy), lo, hi)
            # lax.dynamic_slice clamps the start, so when csz does not
            # divide pop the last chunk overlaps the one before it.
            start = min(c * csz, pop - csz)
            rows = slice(start, start + csz)
            trial = trial_all[:, rows]
            tfit = evaluate(trial)
            better = tfit <= fit[:, rows]
            p[:, rows] = torch.where(better[..., None], trial, p[:, rows])
            fit[:, rows] = torch.where(better, tfit, fit[:, rows])
        return track_best(state, p, fit)

    step_override = None
    if fused:
        if strategy != "rand1bin":
            raise ValueError("fused DE implements DE/rand/1/bin only")
        spec = kreg.get_spec(f.name)   # KeyError if no kernel for this objective
        if not spec.fused_de:
            raise ValueError(f"{f.name} is not usable in the fused DE kernel")

        def gen_fused(state: State, keys: Tensor) -> State:
            # Same key discipline as gen_sync/_trials, so the fused and
            # unfused paths draw identical donors and crossover masks.
            sub = prng.split(keys, 3)
            idx = _distinct3(sub[:, 0], pop)
            u = prng.uniform(sub[:, 1], (pop, dim))
            jrand = prng.randint(sub[:, 2], (pop,), 0, dim)
            p = state["pop"]
            new_pop, new_fit = _de_step_kernel(
                p, state["fit"], idx, u, jrand, fn=spec.eval_tag,
                shift=f.shift_on(p.device), bias=f.bias,
                w=w, px=px, lo=lo, hi=hi, kernel_cfg=kernel_cfg)
            return track_best(state, new_pop, new_fit)

        step_override = gen_fused

    gen = gen_sync if barrier_mode == "sync" else gen_chunked
    # Chunked mode evaluates n_eff_chunks blocks of csz rows; overlapping
    # clamped chunks are charged as the evaluator runs them.
    evals = csz * n_eff_chunks if barrier_mode == "chunked" else pop
    return MetaHeuristic("de", init, gen, evals_per_gen=evals, init_evals=pop,
                         step_override=step_override)
