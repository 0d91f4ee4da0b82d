"""DFA — island-model Firefly Algorithm (counterpart of ``repro.core.fa``,
popt4jlib.PS.FA after Yang [7]).

Fig.4 setup: beta=1, delta=0.97 (randomness decay), gamma=200,
L=1/sqrt(gamma). Every firefly moves toward each brighter one with
attraction beta*exp(-gamma r^2) plus a decaying random walk; O(P^2 D) per
generation.

Eval accounting: the pairwise attraction reads only the cached fitness of
the previous generation, so a generation consumes exactly ``pop``
evaluations (one evaluator call on the moved swarm) at any population size.

The reference materialises the pairwise differences ``(P, P, D)`` at once:
2.56 GB of float32 per island at pop 800 and dim 1000. Here each island's
movers are taken in chunks of rows so that a chunk's differences stay under
``CHUNK_ELEMS`` elements; within a chunk the reference's order is kept
(``r2`` summed over the lanes, then ``einsum("ij,ijd->id")``).
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

# Elements of one chunk of pairwise differences (256 MiB of float32).
CHUNK_ELEMS = 1 << 26


def attraction(x: Tensor, fit: Tensor, beta0: float, gamma: float) -> Tensor:
    """Each firefly's pull toward the brighter ones, ``(I, P, D)``:
    ``sum_j beta0 * exp(-gamma |x_j - x_i|^2) * [fit_j < fit_i] * (x_j - x_i)``."""
    _, P, D = x.shape
    rows = max(1, CHUNK_ELEMS // max(P * D, 1))
    out = []
    for s in range(0, P, rows):
        xi, fi = x[:, s:s + rows], fit[:, s:s + rows]
        diff = x[:, None, :, :] - xi[:, :, None, :]           # (I, c, P, D): x_j - x_i
        r2 = torch.sum(diff * diff, dim=-1)                  # (I, c, P)
        brighter = (fit[:, None, :] < fi[:, :, None]).to(x.dtype)
        attract = beta0 * f32.exp(-gamma * r2) * brighter
        out.append(torch.einsum("icj,icjd->icd", attract, diff))
    return torch.cat(out, dim=1)


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    beta0: float = 1.0,
    gamma: float = 200.0,
    delta: float = 0.97,
    alpha0: float = 1.0,
) -> MetaHeuristic:
    """Firefly Algorithm per-island policy (attraction beta0, absorption gamma)."""
    lo, hi = f.lo, f.hi
    # 1 / jnp.sqrt(gamma): a float32 root, then a float32 division.
    L = float(np.float32(1.0) / np.sqrt(np.float32(gamma)))
    beta0, gamma, delta = f32.const(beta0), f32.const(gamma), f32.const(delta)

    def init(keys: Tensor) -> State:
        x = uniform_init(keys, pop, dim, lo, hi)
        state = init_state(x, evaluate_rows(evaluator, x))
        return {**state, "alpha": torch.full((x.shape[0],), f32.const(alpha0),
                                             device=x.device)}

    def gen(state: State, keys: Tensor) -> State:
        x, fit, alpha = state["pop"], state["fit"], state["alpha"]
        move = attraction(x, fit, beta0, gamma)
        # alpha * L * (u - 0.5) added to x + move: XLA contracts the last
        # product into the sum.
        u = prng.uniform(keys, tuple(x.shape[1:]))
        x = clip_box(f32.fma((alpha * L)[:, None, None], u - 0.5, x + move), lo, hi)
        fit = evaluate_rows(evaluator, x)   # the generation's only objective call
        return {**track_best(state, x, fit), "alpha": alpha * delta}

    return MetaHeuristic("fa", init, gen, evals_per_gen=pop, init_evals=pop)
