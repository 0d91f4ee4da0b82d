"""Fused DE generation: the ``de_step`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.de_step`` (the Pallas kernel) and of
``repro.kernels.ref.de_step_ref``: DE/rand/1/bin mutation from caller-drawn
donor indices, binomial crossover with the guaranteed ``jrand`` lane, box
clipping, evaluation and greedy selection on ``tfit <= fit``, in one pass.

Shapes keep the JAX signature — pop ``(P, D)``, idx_abc ``(3, P)`` — and
also take a leading island axis — pop ``(I, P, D)``, idx_abc ``(3, I, P)``
with indices local to each island — so one launch covers every island.
A CPU tensor goes to :func:`de_step_ref`; a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch import f32
from repro_torch.kernels import _build
from repro_torch.kernels.bench_eval import bench_eval_ref, check_tag, geometry_for

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def mutate(base: torch.Tensor, pb: torch.Tensor, pc: torch.Tensor,
           w: float) -> torch.Tensor:
    """``base + w * (pb - pc)`` with one rounding, as XLA's fused
    multiply-add computes it (and as the kernel's ``__fmaf_rn`` does)."""
    return f32.fma(w, pb - pc, base)


def gather_rows(pop: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pop[idx]`` per island: pop ``(..., P, D)``, idx ``(..., N)`` ->
    ``(..., N, D)``."""
    return torch.gather(pop, -2, idx.unsqueeze(-1).expand(*idx.shape, pop.shape[-1]))


def trial_ref(pop, idx_abc, u, jrand, w=0.5, px=0.2, lo=-100.0, hi=100.0):
    """The trial vectors of one generation: clipped DE/rand/1 mutants where
    ``(u < px) | (lane == jrand)``, the parent elsewhere."""
    idx = idx_abc.long()
    pa, pb, pc = (gather_rows(pop, idx[j]) for j in range(3))
    mutant = torch.clamp(mutate(pa, pb, pc, w), lo, hi)
    lane = torch.arange(pop.shape[-1], device=pop.device)
    cross = (u < px) | (lane == jrand.long()[..., None])
    return torch.where(cross, mutant, pop)


def de_step_ref(pop, fit, idx_abc, u, jrand, fn="sphere", shift=None,
                bias=0.0, w=0.5, px=0.2, lo=-100.0, hi=100.0):
    """Plain PyTorch version; returns ``(new_pop, new_fit)``."""
    trial = trial_ref(pop, idx_abc, u, jrand, w, px, lo, hi)
    tfit = bench_eval_ref(trial, fn, shift, bias)
    better = tfit <= fit
    return (torch.where(better[..., None], trial, pop),
            torch.where(better, tfit, fit))


def de_step(pop, fit, idx_abc, u, jrand, fn="sphere", shift=None, bias=0.0,
            w=0.5, px=0.2, lo=-100.0, hi=100.0):
    """One fused DE/rand/1/bin generation; returns ``(new_pop, new_fit)``.

    pop ``([I,] P, D)`` float32; fit ``([I,] P)``; idx_abc ``(3, [I,] P)``
    integer donor rows; u ``([I,] P, D)`` uniforms; jrand ``([I,] P)``."""
    tag = check_tag(fn)
    if not _build.on_card("de_step", pop):
        return de_step_ref(pop, fit, idx_abc, u, jrand, fn, shift, bias,
                           w, px, lo, hi)
    lead, (P, D) = tuple(pop.shape[:-1]), pop.shape[-2:]
    dev = pop.device
    _build.check_inputs(dev, ("pop", pop, pop.shape), ("u", u, pop.shape),
                        ("fit", fit, lead), ("shift", shift, (D,)))
    idx = _build.index_input("idx_abc", idx_abc, (3, *lead), dev)
    jr = _build.index_input("jrand", jrand, lead, dev)
    R = fit.numel()
    if R == 0:
        return pop.clone(), fit.clone()
    npop = torch.empty_like(pop)
    nfit = torch.empty_like(fit)
    g = geometry_for(R, D, pop, u, shift, npop)
    _build.launch("de_step", dev, pop, fit, idx, u, jr, shift, npop, nfit, R,
                  P, D, tag, bias, w, px, lo, hi, int(g.vec), g.warps_per_row,
                  g.rows_per_block, g.slots_per_thread, int(g.staged))
    global LAUNCHES
    LAUNCHES += 1
    return npop, nfit
