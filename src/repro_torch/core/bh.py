"""DGABH — island-model Generalized Adaptive Basin Hopping (counterpart of
``repro.core.bh``, popt4jlib.BH after [2]).

Each walker: a Gaussian kick, a short stochastic local search (``n_ls``
shrinking-step (1+1) probes, one evaluator call each), then a Metropolis
accept of the new basin against the walker's old one. Islands exchange
walkers through the engine's starvation/ring policies exactly like DGA.

The probe step ``step0 * ls_shrink ** c`` is a float32 power of the probe
counter, as the reference computes it inside ``fori_loop``; the probe key
is ``fold_in(key, c)``. Every draw follows the JAX module key for key, with
islands as the leading dimension of the key batch.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import f32, prng
from repro_torch.core.islands import (MetaHeuristic, State, clip_box,
                                      evaluate_rows, init_state, track_best,
                                      uniform_init)
from repro_torch.functions.benchmarks import Function

Tensor = torch.Tensor


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    n_ls: int = 5,              # local-search probes per hop
    perturb_frac: float = 0.25, # basin-hop kick size
    ls_frac: float = 0.05,      # local-search initial step
    ls_shrink: float = 0.6,
    T: float = 1.0,             # Metropolis temperature between basins
) -> MetaHeuristic:
    """Basin-Hopping per-island policy (kick + local probe + Metropolis)."""
    lo, hi = f.lo, f.hi
    kick = perturb_frac * (hi - lo)
    step0 = f32.const(ls_frac * (hi - lo))
    # step0 * ls_shrink ** c, a float32 power, for each probe c.
    steps = [float(step0 * f32.pow(ls_shrink, torch.tensor(float(c))))
             for c in range(n_ls)]
    inv_T = float(np.float32(1.0) / np.float32(T))   # XLA: -dF / T == -dF * (1/T)

    def evaluate(x: Tensor) -> Tensor:
        return evaluate_rows(evaluator, x)

    def init(keys: Tensor) -> State:
        x = uniform_init(keys, pop, dim, lo, hi)
        return init_state(x, evaluate(x))

    def local_search(y: Tensor, fy: Tensor, keys: Tensor):
        for c, step in enumerate(steps):
            # y + step * normal with a traced step: one fused multiply-add.
            y2 = clip_box(f32.fma(step, prng.normal(prng.fold_in(keys, c), y.shape[1:]), y),
                          lo, hi)
            fy2 = evaluate(y2)
            imp = fy2 < fy
            y, fy = torch.where(imp[..., None], y2, y), torch.where(imp, fy2, fy)
        return y, fy

    def gen(state: State, keys: Tensor) -> State:
        x, fx = state["pop"], state["fit"]
        ks = prng.split(keys, 3)
        y = clip_box(prng.normal(ks[:, 0], x.shape[1:], kick, x), lo, hi)
        y, fy = local_search(y, evaluate(y), ks[:, 1])
        dF = fy - fx
        u = prng.uniform(ks[:, 2], fx.shape[1:])
        accept = (dF <= 0) | (u < f32.exp(-dF * inv_T))
        return track_best(state, torch.where(accept[..., None], y, x),
                          torch.where(accept, fy, fx))

    return MetaHeuristic("bh", init, gen,
                         evals_per_gen=pop * (1 + n_ls), init_evals=pop)
