"""Fused GA offspring wave: the ``ga_step`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.ga_step`` (the Pallas kernel) and of
``repro.kernels.ref.ga_step_ref``: 1-point crossover of caller-gathered
parents, Gaussian mutation, box clipping, evaluation, and placement into the
competing slot on strict ``cfit < slot_f``, in one pass. Aging, roulette
sampling and the worst-slot sort stay with the caller.

Rows are independent (the parents are gathered by the caller), so the
offspring of every island — ``(I, N, D)`` — go through one launch as well
as the JAX signature's ``(N, D)``. The kernel (``csrc/ga_step.cu``, on
``csrc/eval_row.cuh``) takes its geometry from
:func:`~repro_torch.kernels.bench_eval.launch_geometry`.
A CPU tensor goes to :func:`ga_step_ref`; a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bench_eval import bench_eval_ref, check_tag, geometry_for

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def crossover(p1, p2, cut, co, pc=0.7):
    """1-point crossover: where ``co < pc``, lanes below ``cut`` come from
    p1 and the rest from p2; elsewhere the child is p1. p1, p2
    ``(..., N, D)``; cut, co ``(..., N)``."""
    do_co = (co < pc)[..., None]
    mask = torch.arange(p1.shape[-1], device=p1.device) < cut[..., None]
    return torch.where(do_co & mask | ~do_co, p1, p2)


def ga_step_ref(p1, p2, slot_pop, slot_f, cut, co, um, noise, fn="sphere",
                shift=None, bias=0.0, pc=0.7, pm=0.1, sigma_m=1.0,
                lo=-100.0, hi=100.0):
    """Plain PyTorch version; returns ``(new_slot, new_slot_f, take)``."""
    child = crossover(p1, p2, cut, co, pc)
    child = child + torch.where(um < pm, sigma_m * noise, 0.0)
    child = torch.clamp(child, lo, hi)
    cfit = bench_eval_ref(child, fn, shift, bias)
    take = cfit < slot_f
    return (torch.where(take[..., None], child, slot_pop),
            torch.where(take, cfit, slot_f), take)


def ga_step(p1, p2, slot_pop, slot_f, cut, co, um, noise, fn="sphere",
            shift=None, bias=0.0, pc=0.7, pm=0.1, sigma_m=1.0, lo=-100.0,
            hi=100.0):
    """One fused GA offspring wave; returns ``(new_slot, new_slot_f, take)``.

    p1, p2, slot_pop, um, noise ``([I,] N, D)`` float32; slot_f, co
    ``([I,] N)`` float32; cut ``([I,] N)`` integer crossover points."""
    tag = check_tag(fn)
    if not _build.on_card("ga_step", p1):
        return ga_step_ref(p1, p2, slot_pop, slot_f, cut, co, um, noise, fn,
                           shift, bias, pc, pm, sigma_m, lo, hi)
    lead, D = tuple(p1.shape[:-1]), p1.shape[-1]
    dev = p1.device
    _build.check_inputs(dev, *((n, t, p1.shape) for n, t in (
        ("p1", p1), ("p2", p2), ("slot_pop", slot_pop), ("um", um),
        ("noise", noise))), ("slot_f", slot_f, lead), ("co", co, lead),
        ("shift", shift, (D,)))
    ct = _build.index_input("cut", cut, lead, dev)
    N = slot_f.numel()
    if N == 0:
        return (slot_pop.clone(), slot_f.clone(),
                torch.zeros_like(slot_f, dtype=torch.bool))
    nslot = torch.empty_like(slot_pop)
    nslot_f = torch.empty_like(slot_f)
    take = torch.empty_like(slot_f, dtype=torch.bool)
    g = geometry_for(N, D, p1, p2, slot_pop, um, noise, shift, nslot)
    _build.launch("ga_step", dev, p1, p2, slot_pop, slot_f, ct, co, um, noise,
                  shift, nslot, nslot_f, take, N, D, tag, bias, pc, pm, sigma_m,
                  lo, hi, int(g.vec), g.warps_per_row, g.rows_per_block,
                  g.slots_per_thread, int(g.staged))
    global LAUNCHES
    LAUNCHES += 1
    return nslot, nslot_f, take
