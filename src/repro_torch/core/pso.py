"""DPSO — island-model Particle Swarm Optimization (counterpart of
``repro.core.pso``).

Velocity/position update with inertia ``w`` and cognitive/social factors
``fp``/``fg`` (Fig. 4 setup: w=0.6, fp=fg=1). The island's gbest is the
global-within-island best; islands exchange particles over the engine's
ring, and an adopted particle restarts at rest with its arrival as personal
best (``core.portfolio.adopt_native``).

``fused=True`` runs the whole generation — velocity and position update,
evaluation, personal-best selection — in the ``pso_step`` CUDA kernel (one
launch for all islands) via the engine's ``step_override`` hook. Both paths
draw only uniforms, with the JAX module's key discipline, so their
trajectories follow the JAX engine's draw for draw. On CPU tensors the
kernel wrapper runs its plain version.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import prng
from repro_torch.core.islands import (MetaHeuristic, State, clip_box,
                                      evaluate_rows, incumbent, init_state,
                                      uniform_init)
from repro_torch.functions.benchmarks import Function
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.pso_step import pso_step as _pso_step_kernel
from repro_torch.kernels.pso_step import velocity

Tensor = torch.Tensor


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    w: float = 0.6,
    fp: float = 1.0,
    fg: float = 1.0,
    vmax_frac: float = 0.2,
    fused: bool = False,               # whole generation in one kernel launch
) -> MetaHeuristic:
    """Particle Swarm per-island policy (inertia w, cognitive fp, social fg)."""
    lo, hi = f.lo, f.hi
    vmax = vmax_frac * (hi - lo)

    def init(keys: Tensor) -> State:
        ks = prng.split(keys)
        x = uniform_init(ks[:, 0], pop, dim, lo, hi)
        v = vmax * (prng.uniform(ks[:, 1], (pop, dim)) - 0.5)
        state = init_state(x, evaluate_rows(evaluator, x))
        return {**state, "vel": v, "pbest": x.clone(),
                "pbest_f": state["fit"].clone()}

    def draws(keys: Tensor) -> tuple[Tensor, Tensor]:
        ks = prng.split(keys)
        return (prng.uniform(ks[:, 0], (pop, dim)),
                prng.uniform(ks[:, 1], (pop, dim)))

    def finish(state: State, x, v, fit, pbest, pbest_f) -> State:
        return {**state, "pop": x, "fit": fit, "vel": v, "pbest": pbest,
                "pbest_f": pbest_f, **incumbent(state, pbest, pbest_f)}

    def gen(state: State, keys: Tensor) -> State:
        r1, r2 = draws(keys)
        x = state["pop"]
        v = velocity(x, state["vel"], state["pbest"], r1, r2,
                     state["best_arg"], w, fp, fg, vmax)
        x = clip_box(x + v, lo, hi)
        fit = evaluate_rows(evaluator, x)
        imp = fit < state["pbest_f"]
        return finish(state, x, v, fit,
                      torch.where(imp[..., None], x, state["pbest"]),
                      torch.where(imp, fit, state["pbest_f"]))

    step_override = None
    if fused:
        spec = kreg.get_spec(f.name)   # KeyError if no kernel for this objective
        if not spec.fused_de:
            raise ValueError(f"{f.name} is not usable in the fused kernels")

        def gen_fused(state: State, keys: Tensor) -> State:
            # Same key discipline as gen: identical r1/r2 on a fixed seed.
            r1, r2 = draws(keys)
            x = state["pop"]
            out = _pso_step_kernel(
                x, state["vel"], state["pbest"], state["pbest_f"], r1, r2,
                state["best_arg"], fn=spec.eval_tag, shift=f.shift_on(x.device),
                bias=f.bias, w=w, fp=fp, fg=fg, vmax=vmax, lo=lo, hi=hi)
            return finish(state, *out)

        step_override = gen_fused

    return MetaHeuristic("pso", init, gen, evals_per_gen=pop, init_evals=pop,
                         step_override=step_override)
