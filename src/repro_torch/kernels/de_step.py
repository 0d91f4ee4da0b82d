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

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bench_eval import check_cuda, bench_eval_ref, check_tag

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def mutate(base: torch.Tensor, pb: torch.Tensor, pc: torch.Tensor,
           w: float) -> torch.Tensor:
    """``base + w * (pb - pc)`` with one rounding, as XLA's fused
    multiply-add computes it (and as the kernel's ``__fmaf_rn`` does): the
    float32 product is exact in float64."""
    w32 = torch.tensor(w, dtype=torch.float32).double()
    return ((pb - pc).double() * w32 + base.double()).float()


def gather_rows(pop: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pop[idx]`` per island: pop ``(..., P, D)``, idx ``(..., P)``."""
    return torch.gather(pop, -2, idx.unsqueeze(-1).expand(pop.shape))


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
    if pop.device.type == "cpu":
        return de_step_ref(pop, fit, idx_abc, u, jrand, fn, shift, bias,
                           w, px, lo, hi)
    if pop.device.type != "cuda":
        raise ValueError(f"de_step runs on cpu or cuda, not {pop.device}")
    if pop.dim() not in (2, 3):
        raise ValueError(f"pop must be (P, D) or (I, P, D), got {tuple(pop.shape)}")
    lead = tuple(pop.shape[:-1])            # ([I,] P)
    P, D = pop.shape[-2], pop.shape[-1]
    dev = pop.device
    check_cuda("pop", pop, pop.shape, dev)
    check_cuda("u", u, pop.shape, dev)
    check_cuda("fit", fit, lead, dev)
    if shift is not None:
        check_cuda("shift", shift, (D,), dev)
    idx = idx_abc.to(torch.int64).contiguous()
    jr = jrand.to(torch.int64).contiguous()
    if idx.device != dev or tuple(idx.shape) != (3, *lead):
        raise ValueError(f"idx_abc must be (3, {lead}) on {dev}")
    if jr.device != dev or tuple(jr.shape) != lead:
        raise ValueError(f"jrand must be {lead} on {dev}")
    R = pop.numel() // D if D else 0
    if R == 0:
        return pop.clone(), fit.clone()
    npop = torch.empty_like(pop)
    nfit = torch.empty_like(fit)
    lib = _build.library("de_step")
    stream = torch.cuda.current_stream(dev).cuda_stream
    f = ctypes.c_float
    err = lib.de_step_launch(
        pop.data_ptr(), fit.data_ptr(), idx.data_ptr(), u.data_ptr(),
        jr.data_ptr(), None if shift is None else shift.data_ptr(),
        npop.data_ptr(), nfit.data_ptr(), R, P, D, tag, f(bias), f(w),
        f(px), f(lo), f(hi), stream)
    _build.check(err, "de_step")
    global LAUNCHES
    LAUNCHES += 1
    return npop, nfit
