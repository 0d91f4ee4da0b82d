"""DSA — multi-start Simulated Annealing (counterpart of ``repro.core.sa``).

The chains are the rows of each island's ``(P, D)`` population. All four
cooling schedules of popt4jlib's SAScheduleIntf are provided: linear,
exponential, Boltzmann, Cauchy; each island keeps its own step counter
``t`` ``(I,)``.

``fused=True`` runs the evaluate-and-accept tail in the ``eval_select`` CUDA
kernel (one launch for all islands) via the engine's ``step_override`` hook:
the Metropolis rule ``u < exp(-dF/T)`` becomes the per-row threshold test
``dF < -T*ln(u)``. The two forms are equal in exact arithmetic, not in
float32, and each port path follows its own JAX path. On CPU tensors the
kernel wrapper runs its plain version.

Every draw follows the JAX module key for key, with islands as the leading
dimension of the key batch.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch import f32, prng
from repro_torch.core.islands import (MetaHeuristic, State, clip_box,
                                      evaluate_rows, init_state, track_best,
                                      uniform_init)
from repro_torch.functions.benchmarks import Function
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.eval_select import eval_select as _eval_select_kernel

Tensor = torch.Tensor


def _over(T0: float, x: Tensor) -> Tensor:
    """``T0 / x`` correctly rounded (a scalar over a tensor in torch is
    a reciprocal times the scalar, one rounding more)."""
    return torch.full_like(x, T0) / x


# Temperature at step t; the arithmetic is XLA's (division by the constant n
# as a product with its reciprocal, contracted into the subtraction).
SCHEDULES: dict[str, Callable[[Tensor, float, float], Tensor]] = {
    "linear": lambda t, T0, n: T0 * torch.clamp(
        f32.fma(-t, f32.const(1.0 / f32.const(n)), 1.0), min=0.0),
    "exponential": lambda t, T0, n: T0 * f32.pow(0.99, t),
    "boltzmann": lambda t, T0, n: _over(T0, f32.log(t + math.e)),
    "cauchy": lambda t, T0, n: _over(T0, 1.0 + t),
}


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    schedule: str = "linear",
    T0: float = 1000.0,
    n_gens_hint: int = 10_000,   # horizon for the linear schedule
    step_frac: float = 0.1,      # proposal sigma as a fraction of the box width
    fused: bool = False,         # evaluate+accept in one kernel launch
) -> MetaHeuristic:
    """Simulated Annealing per-island policy (population of parallel chains)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown SA schedule {schedule!r}; expected one of "
                         f"{sorted(SCHEDULES)}")
    lo, hi = f.lo, f.hi
    sched = SCHEDULES[schedule]
    sigma = step_frac * (hi - lo)

    def init(keys: Tensor) -> State:
        x = uniform_init(keys, pop, dim, lo, hi)
        state = init_state(x, evaluate_rows(evaluator, x))
        return {**state, "t": torch.zeros(x.shape[0], device=x.device)}

    def propose(state: State, keys: Tensor):
        """(proposals, acceptance uniforms, clamped temperature) — the draws
        and schedule both paths share."""
        x, t = state["pop"], state["t"]
        ks = prng.split(keys)
        T = sched(t, T0, float(n_gens_hint))
        # x + sigma * normal, with XLA's folded constant and fused add.
        y = clip_box(prng.normal(ks[:, 0], x.shape[1:], sigma, x), lo, hi)
        u = prng.uniform(ks[:, 1], state["fit"].shape[1:])
        return y, u, torch.clamp(T, min=1e-12)[:, None]

    def finish(state: State, x: Tensor, fx: Tensor) -> State:
        return {**track_best(state, x, fx), "t": state["t"] + 1.0}

    def gen(state: State, keys: Tensor) -> State:
        x, fx = state["pop"], state["fit"]
        y, u, Tm = propose(state, keys)
        fy = evaluate_rows(evaluator, y)
        dF = fy - fx
        accept = (dF <= 0) | (u < f32.exp(-dF / Tm))
        return finish(state, torch.where(accept[..., None], y, x),
                      torch.where(accept, fy, fx))

    step_override = None
    if fused:
        spec = kreg.get_spec(f.name)   # KeyError if no kernel for this objective
        if not spec.fused_de:
            raise ValueError(f"{f.name} is not usable in the fused kernels")

        def gen_fused(state: State, keys: Tensor) -> State:
            y, u, Tm = propose(state, keys)
            # Metropolis as a threshold: u < exp(-dF/T)  <=>  dF < -T*ln(u)
            thresh = -Tm * f32.log(u)
            x, fx, _ = _eval_select_kernel(
                state["pop"], state["fit"], y, thresh, fn=spec.eval_tag,
                shift=f.shift_on(y.device), bias=f.bias)
            return finish(state, x, fx)

        step_override = gen_fused

    return MetaHeuristic("sa", init, gen, evals_per_gen=pop, init_evals=pop,
                         step_override=step_override)
