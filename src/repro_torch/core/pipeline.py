"""Two-stage explore→polish pipeline (counterpart of ``repro.core.pipeline``).

The in-scan hybrid (``IslandConfig.polish``) interleaves local descent with
the global search. This module is the *staged* alternative the paper's
DGA+ASD experiments report: run the meta-heuristic to completion first,
then polish the final incumbent with a batched local descent
(``optim.descent.make_polish``) through the same evaluator as the engine.

Budget accounting matches the engine's rule: stage-2 evaluations
(``polish_evals_per_point`` per incumbent) are added to the reported
``n_evals``, so pipelined results stay comparable with plain and in-scan
hybrid runs at equal budgets.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import OptimizeResult
from repro_torch.core.islands import IslandOptimizer
from repro_torch.functions.benchmarks import Function
from repro_torch.optim import descent

Tensor = torch.Tensor


def _stage2_fn(opt: IslandOptimizer, f: Function, pcfg: descent.PolishConfig):
    """``(xs (J, dim), fs (J,)) -> (xs', fs')`` incumbent polisher on the
    engine's own (memoized) evaluator. Nothing is compiled, so unlike the
    reference's jitted stage 2 there is nothing to cache."""
    return descent.make_polish(f, opt._evaluator(f), opt.cfg.dim, pcfg)


def _merge(res: OptimizeResult, arg, val: float,
           extra_evals: int) -> OptimizeResult:
    """Stage-2 outcome folded into the stage-1 result envelope."""
    if val < res.value:
        return OptimizeResult(arg=arg, value=val,
                              n_evals=res.n_evals + extra_evals,
                              n_gens=res.n_gens, history=res.history)
    return OptimizeResult(arg=res.arg, value=res.value,
                          n_evals=res.n_evals + extra_evals,
                          n_gens=res.n_gens, history=res.history)


def explore_then_polish(
    opt: IslandOptimizer,
    f: Function,
    key: Tensor,
    pcfg: descent.PolishConfig = descent.PolishConfig(steps=12),
) -> OptimizeResult:
    """Global explore, then polish the final incumbent.

    Stage 1 is ``opt.minimize``; stage 2 is one polish of the returned
    incumbent on ``opt``'s device. The polish evals are charged to
    ``n_evals``."""
    res = opt.minimize(f, key)
    polish = _stage2_fn(opt, f, pcfg)
    xs, fs = polish(torch.as_tensor(res.arg, dtype=torch.float32, device=opt.device)[None],
                    torch.tensor([res.value], dtype=torch.float32, device=opt.device))
    per_point = descent.polish_evals_per_point(opt.cfg.dim, pcfg)
    return _merge(res, xs[0].cpu().numpy(), float(fs[0]), per_point)


def explore_then_polish_many(opt: IslandOptimizer, f: Function, keys: Tensor,
                             pcfg: descent.PolishConfig = descent.PolishConfig(steps=12)
                             ) -> list[OptimizeResult]:
    """Jobs-axis pipeline: one ``minimize_many`` for the global stage, then
    one batched polish of every job's incumbent ``(J, dim)`` on ``opt``'s
    device. Each job is charged its stage-2 evaluations."""
    results = opt.minimize_many(f, keys)
    polish = _stage2_fn(opt, f, pcfg)
    xs = torch.as_tensor(np.stack([r.arg for r in results])).to(opt.device)
    fs = torch.tensor([r.value for r in results], dtype=torch.float32,
                      device=opt.device)
    xs2, fs2 = polish(xs, fs)
    host = torch.cat([xs2, fs2[:, None]], 1).cpu().numpy()
    per_point = descent.polish_evals_per_point(opt.cfg.dim, pcfg)
    return [_merge(r, row[:-1], float(row[-1]), per_point)
            for r, row in zip(results, host)]
