"""Island migration policies (counterpart of ``repro.core.migration``).

Operates on island-stacked tensors ``pop: (..., I, P, D)``, ``fit: (...,
I, P)``; leading dimensions (the jobs of a bucket) are independent runs, and
nothing moves between them.

  ring        counter-clock-wise unidirectional ring (the DPSO/DDE default):
              island i sends its best ``k`` individuals to island i+1 (mod I),
              which adopts any migrant better than its current worst.
  starvation  the DGA/DGABH model: an island whose live population is 0, or
              less than (max island population / 2.5), becomes the
              immigration host; every other island sends its best there. At
              most ``k`` <= 2 migrants leave an island per sync round.
  none        isolated islands.

The async mailbox comes in a later slice. Sorts are stable, as
``jnp.argsort`` is, so ties pick the same slots in both packages. Neither
policy reads a value back to the host: the host island is chosen on the
device.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

POLICIES = ("ring", "starvation", "none")
STARVATION_RATIO = 2.5  # the paper's "population of another island divided by 2.5"


def _replace_worst(pop: Tensor, fit: Tensor, mig: Tensor, migf: Tensor):
    """Per island: replace the worst-k individuals with migrants where the
    migrant is better. pop (..., P, D), fit (..., P), mig (..., k, D), migf
    (..., k)."""
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
    if pop.shape[-3] <= 1:
        return pop, fit
    best = torch.argsort(fit, dim=-1, stable=True)[..., :k]          # (..., I, k)
    mig = torch.gather(pop, -2, best.unsqueeze(-1).expand(*best.shape, pop.shape[-1]))
    migf = torch.gather(fit, -1, best)
    # i -> i+1: destination i receives from i-1
    mig = torch.roll(mig, 1, dims=-3)
    migf = torch.roll(migf, 1, dims=-2)
    return _replace_worst(pop, fit, mig, migf)


def starvation(pop: Tensor, fit: Tensor, k: int = 2,
               alive: Tensor | None = None):
    """DGA starvation-based immigration: the weakest island hosts everyone's
    best. ``alive`` ``(..., I, P)`` marks live individuals (aging model;
    dead slots carry +inf fitness), ``isfinite(fit)`` when not given.
    Migrants land in the host's worst (dead first) slots."""
    n_isl, P, D = pop.shape[-3:]
    if n_isl <= 1:
        return pop, fit
    lead = pop.shape[:-3]
    if alive is None:
        alive = torch.isfinite(fit)
    counts = alive.sum(dim=-1)                                      # (..., I)
    host = torch.argmin(counts, dim=-1, keepdim=True)               # first on ties
    host_n = torch.gather(counts, -1, host)                         # (..., 1)
    starving = (host_n == 0) | (
        host_n.float() < counts.amax(dim=-1, keepdim=True).float() / STARVATION_RATIO)

    k = min(k, 2)  # paper: at most 2 migrants leave an island per round
    best = torch.argsort(fit, dim=-1, stable=True)[..., :k]          # (..., I, k)
    mig = torch.gather(pop, -2, best.unsqueeze(-1).expand(*best.shape, D))
    migf = torch.gather(fit, -1, best)
    # Donors: every island except the host.
    donor = torch.arange(n_isl, device=pop.device) != host          # (..., I)
    flat_f = torch.where(donor[..., None], migf, torch.inf).reshape(*lead, n_isl * k)
    order = torch.argsort(flat_f, dim=-1, stable=True)[..., :min(n_isl * k, P)]
    arrivals = torch.gather(mig.reshape(*lead, n_isl * k, D), -2,
                            order.unsqueeze(-1).expand(*order.shape, D))
    rows = host[..., None, None].expand(*lead, 1, P, D)
    slots = host[..., None].expand(*lead, 1, P)
    hpop, hfit = torch.gather(pop, -3, rows), torch.gather(fit, -2, slots)
    hpop2, hfit2 = _replace_worst(hpop, hfit, arrivals.unsqueeze(-3),
                                  torch.gather(flat_f, -1, order).unsqueeze(-2))
    hpop2 = torch.where(starving[..., None, None], hpop2, hpop)
    hfit2 = torch.where(starving[..., None], hfit2, hfit)
    return pop.scatter(-3, rows, hpop2), fit.scatter(-2, slots, hfit2)


def migrate(policy: str, pop: Tensor, fit: Tensor, k: int = 2,
            alive: Tensor | None = None):
    """Dispatch to a migration policy by name: ring | starvation | none.
    ``alive`` is read by starvation only."""
    if policy == "ring":
        return ring(pop, fit, k)
    if policy == "starvation":
        return starvation(pop, fit, k, alive)
    if policy == "none":
        return pop, fit
    raise ValueError(f"unknown migration policy {policy!r}")
