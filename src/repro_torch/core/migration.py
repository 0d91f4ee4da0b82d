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

Async mailbox: the staleness-bounded alternative to the lockstep
exchange. Each island owns a fixed-shape ring buffer of migrant batches
(``mailbox_init``); on the ticks it completes a round it posts its best-k to
its ring successor's buffer tagged with its own round counter
(``mailbox_post`` — a full ring overwrites the oldest entry), and adopts the
newest entry whose staleness (receiver round minus sender tag) is at most
``max_staleness`` through the same ``_replace_worst`` rule the barrier ring
uses (``mailbox_adopt``). With every island on the barrier cadence and
``max_staleness=0`` the adopted batch each tick is exactly the rolled
migrant tensor ``ring`` computes. The mailbox functions take the same
leading job dimensions, so the ring rolls within a job.

Sharded form (``group``, a ``core.mesh.Group``; ``None`` is the unsharded
engine): each rank holds its block of ``I_local = I / ranks`` islands. The
ring becomes a local roll plus one hop of the boundary island's migrants to
the next rank (``mesh.ring_shift``, the reference's ``ppermute``; with jobs
folded in, one hop carries every job's ``(k, D)`` batch and their fitness);
starvation gathers the island-stacked arrays (``mesh.all_gather_rows``),
runs the policy unchanged on the copy and keeps the rank's block; the
mailbox post hops like the ring. Both forms compute identical values.

Sorts are stable, as ``jnp.argsort`` is, so ties pick the same slots in both
packages. Nothing here reads a value back to the host: the host island and
the adopted slot are chosen on the device.
"""
from __future__ import annotations

import torch

from repro_torch.core import mesh

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


def _sharded(group: mesh.Group | None) -> bool:
    return group is not None and group.size > 1


def _from_prev(x: Tensor, prev: Tensor, dim: int) -> Tensor:
    """``x`` shifted by one along island dimension ``dim``, ``prev`` (the
    island before this block's first) in front: the block of the global
    roll by one."""
    return torch.cat([prev.unsqueeze(dim), x.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _roll_in(mig: Tensor, migf: Tensor,
             group: mesh.Group | None) -> tuple[Tensor, Tensor]:
    """The batches ``mig (..., I, k, D)``, ``migf (..., I, k)`` rolled by one
    island, i -> i+1. The first island's batch is the previous rank's last
    (one ``mesh.ring_shift`` hop, packed as ``(..., k, D + 1)``); unsharded
    or on one rank the hop is the identity, so it is this block's own last."""
    last = mesh.ring_shift(torch.cat([mig[..., -1, :, :], migf[..., -1, :, None]], -1), group)
    return _from_prev(mig, last[..., :-1], -3), _from_prev(migf, last[..., -1], -2)


def ring(pop: Tensor, fit: Tensor, k: int = 2, group: mesh.Group | None = None):
    """Counter-clock-wise ring migration of the best-k per island. Sharded,
    the roll by one crosses to the next rank with the last local island's
    migrants and their fitness."""
    if pop.shape[-3] <= 1 and not _sharded(group):
        return pop, fit
    best = torch.argsort(fit, dim=-1, stable=True)[..., :k]          # (..., I, k)
    mig = torch.gather(pop, -2, best.unsqueeze(-1).expand(*best.shape, pop.shape[-1]))
    migf = torch.gather(fit, -1, best)
    # i -> i+1: destination i receives from i-1
    mig, migf = _roll_in(mig, migf, group)
    return _replace_worst(pop, fit, mig, migf)


def starvation(pop: Tensor, fit: Tensor, k: int = 2,
               alive: Tensor | None = None, group: mesh.Group | None = None):
    """DGA starvation-based immigration: the weakest island hosts everyone's
    best. ``alive`` ``(..., I, P)`` marks live individuals (aging model;
    dead slots carry +inf fitness), ``isfinite(fit)`` when not given.
    Migrants land in the host's worst (dead first) slots.

    The host is an argmin over every island, so the sharded form gathers
    ``pop``, ``fit`` and ``alive`` from every rank, runs the policy on the
    gathered copy and keeps this rank's block (its own allocation)."""
    if _sharded(group):
        gpop = mesh.all_gather_rows(pop, group, dim=-3)
        gfit = mesh.all_gather_rows(fit, group, dim=-2)
        galive = None if alive is None else mesh.all_gather_rows(alive, group, dim=-2)
        npop, nfit = starvation(gpop, gfit, k, galive)
        n = pop.shape[-3]
        return (mesh.local_rows(npop, group.rank, n, -3).clone(),
                mesh.local_rows(nfit, group.rank, n, -2).clone())
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


# -- async staleness-bounded mailbox -------------------------------------------

MAILBOX_KEYS = ("mbox_pop", "mbox_fit", "mbox_tag", "mbox_head",
                "round_ctr", "stale_seen")


def mailbox_init(n_islands: int, slots: int, k: int, dim: int,
                 device: str | torch.device = "cpu") -> dict[str, Tensor]:
    """Fresh per-island mailbox state (keys in :data:`MAILBOX_KEYS`), one
    row per island (the engine passes its ``J·I`` rows):

    * ``mbox_pop (I, S, k, D)`` / ``mbox_fit (I, S, k)`` — ``S`` ring slots
      of k-migrant batches per island (empty slots carry +inf fitness);
    * ``mbox_tag (I, S)`` int32 — the sender's round counter per slot, -1 =
      empty;
    * ``mbox_head (I,)`` int32 — each ring's write cursor (wraps = overwrite
      oldest);
    * ``round_ctr (I,)`` int32 — per-island completed-round counters, the
      clocks staleness is measured against;
    * ``stale_seen (I,)`` int32 — high-water mark of adopted-migrant
      staleness (-1 until an adoption happens).
    """
    i, s = n_islands, slots
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "mbox_pop": torch.zeros((i, s, k, dim), device=device),
        "mbox_fit": torch.full((i, s, k), torch.inf, device=device),
        "mbox_tag": torch.full((i, s), -1, **i32),
        "mbox_head": torch.zeros((i,), **i32),
        "round_ctr": torch.zeros((i,), **i32),
        "stale_seen": torch.full((i,), -1, **i32),
    }


def mailbox_post(mbox: dict[str, Tensor], pop: Tensor, fit: Tensor, k: int,
                 post: Tensor, group: mesh.Group | None = None) -> dict[str, Tensor]:
    """Each island posts its best-k batch to its ring successor's mailbox.

    ``pop (..., I, P, D)``, ``fit (..., I, P)`` and the mailbox leaves with
    the same leading dimensions. ``post (..., I)`` gates per *sender*: an
    island posts only on ticks it completed a round and the delivery
    schedule fired (False models a dropped message; the batch is lost). The
    batch lands at the receiver's write head tagged with the sender's
    ``round_ctr``; a full ring overwrites the oldest entry. Sharded, the
    boundary island's batch crosses to the next rank as the ring's does:
    one hop of migrants and fitness, one of tag and post flag."""
    best = torch.argsort(fit, dim=-1, stable=True)[..., :k]          # (..., I, k)
    mig = torch.gather(pop, -2, best.unsqueeze(-1).expand(*best.shape, pop.shape[-1]))
    migf = torch.gather(fit, -1, best)
    post = post.to(torch.int32).expand(mbox["round_ctr"].shape)
    tag = mbox["round_ctr"]
    # i -> i+1: destination i receives from i-1
    in_m, in_f = _roll_in(mig, migf, group)
    tp = mesh.ring_shift(torch.stack([tag[..., -1], post[..., -1]], -1), group)
    in_t = _from_prev(tag, tp[..., 0], -1)
    keep = _from_prev(post, tp[..., 1], -1) > 0                     # (..., I)
    head = mbox["mbox_head"]
    slots = mbox["mbox_tag"].shape[-1]
    hit = keep[..., None] & (torch.arange(slots, device=head.device) == head[..., None])
    return {**mbox,
            "mbox_pop": torch.where(hit[..., None, None], in_m[..., None, :, :],
                                    mbox["mbox_pop"]),
            "mbox_fit": torch.where(hit[..., None], in_f[..., None, :], mbox["mbox_fit"]),
            "mbox_tag": torch.where(hit, in_t[..., None], mbox["mbox_tag"]),
            "mbox_head": torch.where(keep, (head + 1) % slots, head)}


def mailbox_adopt(mbox: dict[str, Tensor], pop: Tensor, fit: Tensor,
                  max_staleness: int, gate: Tensor
                  ) -> tuple[Tensor, Tensor, dict[str, Tensor]]:
    """Each island adopts the newest mailbox batch whose staleness — its own
    ``round_ctr`` minus the sender's tag — is at most ``max_staleness``,
    through the worst-k replacement rule the barrier ring uses.

    Entries staler than the bound are never adopted (they age in the ring
    until overwritten); an adopted slot is consumed (tag reset to -1) so a
    batch is adopted at most once. ``gate (..., I)`` restricts adoption to
    islands that completed a round this tick. The newest valid slot is the
    first maximal tag, ``jnp.argmax``'s tie rule. ``stale_seen`` keeps the
    high-water mark of adopted staleness. Returns ``(pop, fit, mbox)``."""
    tags = mbox["mbox_tag"]                                        # (..., I, S)
    stale = mbox["round_ctr"][..., None] - tags
    keyed = torch.where((tags >= 0) & (stale <= max_staleness), tags, -1)
    slots = torch.arange(tags.shape[-1], device=tags.device)
    first_max = keyed == keyed.amax(dim=-1, keepdim=True)
    slot = torch.where(first_max, slots, tags.shape[-1]).amin(dim=-1, keepdim=True)
    take = (torch.gather(keyed, -1, slot)[..., 0] >= 0) & gate      # (..., I)
    k, dim = mbox["mbox_pop"].shape[-2:]
    m = torch.gather(mbox["mbox_pop"], -3,
                     slot[..., None, None].expand(*slot.shape, k, dim))[..., 0, :, :]
    f = torch.gather(mbox["mbox_fit"], -2, slot[..., None].expand(*slot.shape, k))[..., 0, :]
    npop, nfit = _replace_worst(pop, fit, m, f)
    pop = torch.where(take[..., None, None], npop, pop)
    fit = torch.where(take[..., None], nfit, fit)
    consumed = tags.scatter(-1, slot, -1)
    st = torch.gather(stale, -1, slot)[..., 0]
    seen = mbox["stale_seen"]
    return pop, fit, {**mbox,
                      "mbox_tag": torch.where(take[..., None], consumed, tags),
                      "stale_seen": torch.where(take, torch.maximum(seen, st), seen)}


def migrate(policy: str, pop: Tensor, fit: Tensor, k: int = 2,
            alive: Tensor | None = None, group: mesh.Group | None = None):
    """Dispatch to a migration policy by name: ring | starvation | none.
    ``alive`` is read by starvation only; ``group`` selects the sharded
    form."""
    if policy == "ring":
        return ring(pop, fit, k, group)
    if policy == "starvation":
        return starvation(pop, fit, k, alive, group)
    if policy == "none":
        return pop, fit
    raise ValueError(f"unknown migration policy {policy!r}")
