"""DEA — multi-threaded Evolutionary Algorithm (counterpart of
``repro.core.ea``, popt4jlib.EA after Michalewicz [4]).

A (mu + lambda) evolution strategy with Gaussian mutation and a
multiplicative 1/5th-success-rule step size ``sigma``, one float32 value per
island. The reference's arithmetic is kept where it decides the trajectory:

  * the child is ``x + sigma * normal`` with ``sigma`` a traced value, which
    XLA contracts into one fused multiply-add over the drawn normal;
  * (mu + lambda) selection is a stable ascending sort with +inf and NaN
    last, as ``jnp.argsort`` sorts;
  * the median is ``jnp.median``'s: the two middle values of the sorted
    fitness added and halved (one value twice for an odd ``pop``), and NaN
    if any value is NaN;
  * the success rate is a count times ``1/lam`` (XLA's division by a
    constant), and the bounds of ``sigma`` are rounded to float32 as JAX
    rounds weak-typed constants.

Every draw follows the JAX module key for key, with islands as the leading
dimension of the key batch.
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
from repro_torch.kernels.de_step import gather_rows

Tensor = torch.Tensor


def median(fit: Tensor) -> Tensor:
    """``jnp.median`` over the last axis: ``(s[lo] + s[hi]) * 0.5`` of the
    sorted values at the middle indices, NaN where any value is NaN."""
    n = fit.shape[-1]
    s = torch.sort(fit, dim=-1).values
    med = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    return torch.where(torch.isnan(fit).any(dim=-1), torch.nan, med)


def make(
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    lam: int | None = None,
    sigma0_frac: float = 0.3,
) -> MetaHeuristic:
    """(mu+lambda) Evolutionary Algorithm per-island policy."""
    lo, hi = f.lo, f.hi
    lam = lam if lam is not None else pop
    sigma0 = f32.const(sigma0_frac * (hi - lo))
    s_lo, s_hi = f32.const(1e-8 * (hi - lo)), f32.const(hi - lo)
    inv_lam = float(np.float32(1.0) / np.float32(lam))

    def init(keys: Tensor) -> State:
        x = uniform_init(keys, pop, dim, lo, hi)
        state = init_state(x, evaluate_rows(evaluator, x))
        return {**state, "sigma": torch.full((x.shape[0],), sigma0, device=x.device)}

    def gen(state: State, keys: Tensor) -> State:
        x, fit, sigma = state["pop"], state["fit"], state["sigma"]
        ks = prng.split(keys)
        parents = prng.randint(ks[:, 0], (lam,), 0, pop)
        noise = prng.normal(ks[:, 1], (lam, dim))
        child = clip_box(f32.fma(sigma[:, None, None], noise,
                                 gather_rows(x, parents)), lo, hi)
        cfit = evaluate_rows(evaluator, child)

        # (mu + lambda) selection
        allx = torch.cat([x, child], dim=1)
        allf = torch.cat([fit, cfit], dim=1)
        keep = torch.argsort(allf, dim=-1, stable=True)[:, :pop]
        x, fit = gather_rows(allx, keep), torch.gather(allf, -1, keep)

        # 1/5th success rule on the offspring
        wins = (cfit < median(fit)[:, None]).sum(dim=-1).float()
        succ = wins * inv_lam
        factor = torch.where(succ > f32.const(0.2), f32.const(1.05), f32.const(0.95))
        sigma = torch.clamp(sigma * factor, s_lo, s_hi)
        return {**track_best(state, x, fit), "sigma": sigma}

    return MetaHeuristic("ea", init, gen, evals_per_gen=lam, init_evals=pop)
