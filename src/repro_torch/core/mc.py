"""MCS — parallel pure Monte-Carlo random search (counterpart of
``repro.core.mc``).

The paper's benchmark baseline: each generation draws a fresh population
uniformly from the box and keeps the best. Its draws are uniforms only,
which the port gives bit for bit, so its trajectory equals the JAX
package's up to the objective's float32 rounding.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.islands import (MetaHeuristic, State, evaluate_rows,
                                      init_state, track_best, uniform_init)
from repro_torch.functions.benchmarks import Function

Tensor = torch.Tensor


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
) -> MetaHeuristic:
    """Pure Monte-Carlo sampling policy — the paper's MCS baseline."""
    lo, hi = f.lo, f.hi

    def init(keys: Tensor) -> State:
        x = uniform_init(keys, pop, dim, lo, hi)
        return init_state(x, evaluate_rows(evaluator, x))

    def gen(state: State, keys: Tensor) -> State:
        x = uniform_init(keys, pop, dim, lo, hi)
        return track_best(state, x, evaluate_rows(evaluator, x))

    return MetaHeuristic("mc", init, gen, evals_per_gen=pop, init_evals=pop)
