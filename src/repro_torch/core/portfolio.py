"""Migrant adoption per policy (the adoption part of ``repro.core.portfolio``).

Migration moves positions and fitness only. A slot whose contents changed
holds an adopted migrant, and the destination policy re-initialises its own
per-individual state there: ga revives the slot and makes the migrant
newborn, pso starts the particle at rest with its arrival as personal best.
The slot table below is the reference's, for all eight policies; the
``Portfolio`` class and its unified state come with a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor
State = dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class AuxSlot:
    """One piece of a policy's state beyond pop/fit/best.

    ``kind``: ``vec`` is per-individual ``(I, P, D)``, ``ind`` per-individual
    ``(I, P)``, ``scl`` one value per island. ``adopt`` is the rule for an
    adopted row: ``zero`` | ``pos`` (the migrant's position) | ``fit`` (its
    fitness) | ``keep``; scalars are never re-initialised."""

    name: str
    kind: str          # "vec" | "ind" | "scl"
    adopt: str = "keep"


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """A policy's stable wire identity (``algo_id``), its aux slots, and
    whether its state owns the ``alive`` mask (GA aging)."""

    name: str
    algo_id: int
    slots: tuple[AuxSlot, ...] = ()
    needs_alive: bool = False


REGISTRY: dict[str, PolicySpec] = {s.name: s for s in (
    PolicySpec("de", 0),
    PolicySpec("ga", 1, slots=(
        AuxSlot("age", "ind", adopt="zero"),        # migrants arrive newborn
        AuxSlot("age_limit", "ind", adopt="keep"),  # slot keeps its drawn limit
    ), needs_alive=True),
    PolicySpec("pso", 2, slots=(
        AuxSlot("vel", "vec", adopt="zero"),        # adopted particle starts at rest
        AuxSlot("pbest", "vec", adopt="pos"),       # personal best restarts at the
        AuxSlot("pbest_f", "ind", adopt="fit"),     # migrant's position/fitness
    )),
    PolicySpec("sa", 3, slots=(AuxSlot("t", "scl"),)),
    PolicySpec("ea", 4, slots=(AuxSlot("sigma", "scl"),)),
    PolicySpec("fa", 5, slots=(AuxSlot("alpha", "scl"),)),
    PolicySpec("bh", 6),
    PolicySpec("mc", 7),
)}


def adopt_native(name: str, state: State, mask: Tensor) -> State:
    """Apply policy ``name``'s adopt rules to its island-stacked state where
    ``mask`` ``(I, P)`` marks adopted rows: revive ``alive`` if the state
    has it, then re-initialise each aux slot by its rule. An unregistered
    policy gets the revive alone."""
    out = dict(state)
    if "alive" in out:
        out["alive"] = out["alive"] | mask
    spec = REGISTRY.get(name)
    if spec is None:
        return out
    for s in spec.slots:
        if s.name not in out or s.kind == "scl" or s.adopt == "keep":
            continue
        m = mask[..., None] if s.kind == "vec" else mask
        new = {"zero": 0.0, "pos": out["pop"], "fit": out["fit"]}[s.adopt]
        out[s.name] = torch.where(m, new, out[s.name])
    return out


def has_adopt_state(name: str) -> bool:
    """Whether a policy carries per-individual state that migration adoption
    must touch — decides if the engine computes the adopted mask."""
    spec = REGISTRY.get(name)
    return spec is not None and (
        spec.needs_alive or any(s.kind in ("vec", "ind") for s in spec.slots))
