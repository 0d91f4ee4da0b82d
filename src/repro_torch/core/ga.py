"""DGA — island-model Genetic Algorithm (counterpart of ``repro.core.ga``).

Elitist roulette-wheel selection on the generation's fitness, 1-point
crossover, per-allele Gaussian mutation, and the paper's aging mechanism:
each individual draws a Gaussian age limit at birth and dies past it (the
island's best never ages out), so island populations vary over time and
starvation migration (``IslandConfig(migration="starvation")``) refills the
weakest island. Populations are fixed-capacity arrays with an ``alive``
mask; a dead slot carries +inf fitness and is never selected.

``fused=True`` runs the offspring wave — crossover, mutation, evaluation,
slot placement — in the ``ga_step`` CUDA kernel (one launch for all
islands) via the engine's ``step_override`` hook; aging, roulette sampling
and the worst-slot sort stay in torch. On CPU tensors the kernel wrapper
runs its plain version.

Every draw follows the JAX module key for key, with islands as the leading
dimension of the key batch.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import f32, prng
from repro_torch.core.islands import (MetaHeuristic, State, clip_box,
                                      evaluate_rows, incumbent, init_state,
                                      uniform_init)
from repro_torch.functions.benchmarks import Function
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.de_step import gather_rows
from repro_torch.kernels.ga_step import crossover
from repro_torch.kernels.ga_step import ga_step as _ga_step_kernel

Tensor = torch.Tensor


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    pc: float = 0.7,            # 1-pt crossover probability (Fig.4 setup)
    pm: float = 0.1,            # per-allele mutation probability (Fig.4 setup)
    mut_scale: float = 0.1,     # Gaussian mutation sigma, fraction of box width
    n_offspring: int | None = None,
    age_mean: float = 1e9,      # aging disabled by default (Fig.4 single-island runs)
    age_sd: float = 0.0,
    fused: bool = False,        # offspring wave in one kernel launch
    kernel_cfg: KernelConfig | None = None,   # the fused kernel's storage and geometry
) -> MetaHeuristic:
    """Genetic Algorithm per-island policy (1-pt crossover, Gaussian mutation,
    optional aging — the paper's DGA island member)."""
    lo, hi = f.lo, f.hi
    n_off = n_offspring if n_offspring is not None else max(1, pop // 4)
    sigma_m = mut_scale * (hi - lo)

    def draw_limits(keys: Tensor, n: int) -> Tensor:
        """Gaussian age limits ``age_mean + age_sd * N(0, 1)``, ``(I, n)``."""
        return prng.normal(keys, (n,), age_sd, age_mean)

    def init(keys: Tensor) -> State:
        ks = prng.split(keys)
        p = uniform_init(ks[:, 0], pop, dim, lo, hi)
        state = init_state(p, evaluate_rows(evaluator, p))
        n_isl = p.shape[0]
        return {**state,
                "age": torch.zeros(n_isl, pop, device=p.device),
                "age_limit": draw_limits(ks[:, 1], pop),
                "alive": torch.ones(n_isl, pop, dtype=torch.bool, device=p.device)}

    def select(state: State, keys: Tensor):
        """Aging, then roulette-wheel parents and the worst slots: the
        phases both paths share. Returns the aged state's pieces, the
        parents, the keys of the remaining draws and the slot indices."""
        p, fit = state["pop"], state["fit"]
        age, alive = state["age"] + 1.0, state["alive"]
        ks = prng.split(keys, 6)
        # Aging: individuals past their limit die; the island's best never does.
        elite = torch.argmin(torch.where(alive, fit, torch.inf), dim=-1)
        slots = torch.arange(pop, device=p.device)
        died = alive & (age > state["age_limit"]) & (slots != elite[:, None])
        alive = alive & ~died
        fit = torch.where(alive, fit, torch.inf)
        # Roulette wheel among the living, weighted by distance from the
        # worst finite fitness (minimisation).
        finite = torch.where(torch.isfinite(fit), fit, -torch.inf)
        worst = torch.amax(finite, dim=-1, keepdim=True)
        wgt = torch.where(alive, torch.clamp(worst - fit, min=0.0) + 1e-9, 0.0)
        parents = prng.categorical(ks[:, 0], f32.log(wgt + 1e-30), (2, n_off))
        p1, p2 = gather_rows(p, parents[:, 0]), gather_rows(p, parents[:, 1])
        cut = prng.randint(ks[:, 1], (n_off,), 1, dim)
        co = prng.uniform(ks[:, 2], (n_off,))
        # Offspring land in the worst n_off slots, dead ones (+inf) first;
        # argsort is stable, so among ties the highest index comes first.
        order = torch.argsort(fit, dim=-1, stable=True).flip(-1)[:, :n_off]
        return fit, age, alive, p1, p2, cut, co, ks, order

    def place(state: State, keys: Tensor, fit, age, alive, order, nslot,
              nslot_f, take) -> State:
        """Scatter the wave's slot rows back; placed children are newborn,
        alive, with a fresh age limit."""
        wrows = order.unsqueeze(-1).expand(*order.shape, dim)
        p = state["pop"].scatter(1, wrows, nslot)
        fit = fit.scatter(1, order, nslot_f)
        age = age.scatter(1, order, torch.where(take, 0.0, age.gather(1, order)))
        limit = state["age_limit"]
        limit = limit.scatter(1, order, torch.where(
            take, draw_limits(keys, n_off), limit.gather(1, order)))
        alive = alive.scatter(1, order, alive.gather(1, order) | take)
        return {**state, "pop": p, "fit": fit, "age": age, "age_limit": limit,
                "alive": alive, **incumbent(state, p, fit)}

    def gen(state: State, keys: Tensor) -> State:
        fit, age, alive, p1, p2, cut, co, ks, order = select(state, keys)
        child = crossover(p1, p2, cut, co, pc)
        mmask = prng.uniform(ks[:, 3], (n_off, dim)) < pm
        # child + sigma_m * normal where mutated: XLA folds sigma_m into the
        # normal's sqrt(2) factor and, across the select, rounds twice.
        child = child + torch.where(mmask, prng.normal(ks[:, 4], (n_off, dim),
                                                       sigma_m), 0.0)
        child = clip_box(child, lo, hi)
        cfit = evaluate_rows(evaluator, child)
        slot_f = fit.gather(1, order)
        take = cfit < slot_f
        slot = gather_rows(state["pop"], order)
        return place(state, ks[:, 5], fit, age, alive, order,
                     torch.where(take[..., None], child, slot),
                     torch.where(take, cfit, slot_f), take)

    step_override = None
    if fused:
        spec = kreg.get_spec(f.name)   # KeyError if no kernel for this objective
        if not spec.fused_de:
            raise ValueError(f"{f.name} is not usable in the fused kernels")

        def gen_fused(state: State, keys: Tensor) -> State:
            # Same pre-kernel phases and key discipline as gen.
            fit, age, alive, p1, p2, cut, co, ks, order = select(state, keys)
            um = prng.uniform(ks[:, 3], (n_off, dim))
            nz = prng.normal(ks[:, 4], (n_off, dim))
            nslot, nslot_f, take = _ga_step_kernel(
                p1, p2, gather_rows(state["pop"], order), fit.gather(1, order),
                cut, co, um, nz, fn=spec.eval_tag,
                shift=f.shift_on(p1.device), bias=f.bias, pc=pc, pm=pm,
                sigma_m=sigma_m, lo=lo, hi=hi, kernel_cfg=kernel_cfg)
            return place(state, ks[:, 5], fit, age, alive, order, nslot,
                         nslot_f, take)

        step_override = gen_fused

    return MetaHeuristic("ga", init, gen, evals_per_gen=n_off, init_evals=pop,
                         step_override=step_override)
