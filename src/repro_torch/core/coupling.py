"""Optimizer coupling — the paper's Observer pattern and the Fig.4 X/FCG
combos (counterpart of ``repro.core.coupling``).

popt4jlib couples a meta-heuristic (SubjectIntf) with a local-search
optimizer (ObserverIntf): each new incumbent triggers a descent to the
nearest saddle point. Fig.4's "GA/FCG (50-50 function evaluations)" splits
the budget equally between the global phase and the FCG refinement phase,
and the refinement starts from the global phase's incumbent.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng, resolve_device
from repro_torch.core.api import ObserverHub, OptimizeResult
from repro_torch.core.islands import IslandOptimizer
from repro_torch.functions.benchmarks import Function
from repro_torch.optim import descent

Tensor = torch.Tensor


def with_fcg_postprocessing(
    meta: IslandOptimizer,
    f: Function,
    key: Tensor,
    dim: int,
    total_evals: int,
    split: float = 0.5,
    dcfg: descent.DescentConfig | None = None,
) -> OptimizeResult:
    """Fig.4 combo: meta-heuristic for ``split`` of the budget, FCG the
    rest. Both phases run on ``meta``'s device and evaluation backend."""
    ks = prng.split(key.to(meta.device))
    meta_cfg = dataclasses.replace(meta.cfg, max_evals=int(total_evals * split))
    global_phase = IslandOptimizer(meta.algo_maker, meta_cfg, meta.params,
                                   exec_cfg=meta.exec_cfg, device=meta.device)
    res = global_phase.minimize(f, ks[0])

    budget_left = total_evals - res.n_evals
    dcfg = dataclasses.replace(dcfg or descent.DescentConfig(), max_evals=budget_left)
    # FCG refinement seeded at the meta-heuristic's incumbent (Observer hand-off).
    x0 = torch.as_tensor(res.arg, dtype=torch.float32, device=meta.device)
    refined = _fcg_from(f, x0, ks[1], dim, dcfg)
    best = refined if refined.value < res.value else res
    return OptimizeResult(arg=best.arg, value=best.value,
                          n_evals=res.n_evals + refined.n_evals)


def _fcg_from(f: Function, x0: Tensor, key: Tensor, dim: int,
              cfg: descent.DescentConfig) -> OptimizeResult:
    """Fletcher-Reeves FCG from a fixed starting point (restarts remain
    random)."""
    if cfg.max_evals <= 0:
        return OptimizeResult(arg=x0.cpu().numpy(), value=float(f.fn(x0)), n_evals=1)
    return descent._descend(f, x0, key, cfg, "fcg", "fr")


def observed_local_search(f: Function, dim: int, hub: ObserverHub,
                          budget_per_refine: int = 2000,
                          device: str | torch.device | None = None) -> None:
    """Register an FCG observer on the hub: every incumbent notification is
    refined to the nearest saddle point (the paper's AVD/FCG ObserverIntf).
    The refinement runs on ``device`` (``None``: the GPU)."""
    device = resolve_device(device)

    def refine(arg, value: float):
        cfg = descent.DescentConfig(max_evals=budget_per_refine)
        x0 = torch.as_tensor(arg, dtype=torch.float32, device=device)
        res = _fcg_from(f, x0, prng.PRNGKey(0, device), dim, cfg)
        return (res.arg, res.value) if res.value < value else None

    hub.register(refine)
