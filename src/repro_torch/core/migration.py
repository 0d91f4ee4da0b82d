"""Island migration policies (counterpart of ``repro.core.migration``).

Operates on island-stacked tensors ``pop: (I, P, D)``, ``fit: (I, P)``.

  ring   counter-clock-wise unidirectional ring (the DPSO/DDE default):
         island i sends its best ``k`` individuals to island i+1 (mod I),
         which adopts any migrant better than its current worst.
  none   isolated islands.

Starvation migration and the async mailbox come in a later slice. Sorts are
stable, as ``jnp.argsort`` is, so ties pick the same slots in both packages.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _replace_worst(pop: Tensor, fit: Tensor, mig: Tensor, migf: Tensor):
    """Per island: replace the worst-k individuals with migrants where the
    migrant is better. pop (I, P, D), fit (I, P), mig (I, k, D), migf (I, k)."""
    k = mig.shape[-2]
    worst = torch.argsort(fit, dim=-1, stable=True)[..., fit.shape[-1] - k:]
    cur = torch.gather(fit, -1, worst)
    take = migf < cur
    newf = torch.where(take, migf, cur)
    wrows = worst.unsqueeze(-1).expand(*worst.shape, pop.shape[-1])
    newp = torch.where(take[..., None], mig, torch.gather(pop, -2, wrows))
    return (pop.scatter(-2, wrows, newp), fit.scatter(-1, worst, newf))


def ring(pop: Tensor, fit: Tensor, k: int = 2):
    """Counter-clock-wise ring migration of the best-k per island."""
    if pop.shape[0] <= 1:
        return pop, fit
    best = torch.argsort(fit, dim=1, stable=True)[:, :k]            # (I,k)
    mig = torch.gather(pop, 1, best.unsqueeze(-1).expand(*best.shape, pop.shape[-1]))
    migf = torch.gather(fit, 1, best)                               # (I,k)
    # i -> i+1: destination i receives from i-1
    mig = torch.roll(mig, 1, dims=0)
    migf = torch.roll(migf, 1, dims=0)
    return _replace_worst(pop, fit, mig, migf)


def migrate(policy: str, pop: Tensor, fit: Tensor, k: int = 2):
    """Dispatch to a migration policy by name: ring | none."""
    if policy == "ring":
        return ring(pop, fit, k)
    if policy == "none":
        return pop, fit
    if policy == "starvation":
        raise NotImplementedError(
            "starvation migration comes with a later slice of the port")
    raise ValueError(f"unknown migration policy {policy!r}")
