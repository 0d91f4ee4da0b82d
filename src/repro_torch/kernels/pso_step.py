"""Fused PSO generation: the ``pso_step`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.pso_step`` (the Pallas kernel) and of
``repro.kernels.ref.pso_step_ref``: velocity update (inertia ``w``,
cognitive ``fp``, social ``fg``) clamped to ``±vmax``, position clipped to
the box, evaluation, and the personal-best update on strict ``<``, in one
pass. The island's gbest argmin stays with the caller.

Shapes keep the JAX signature — x ``(P, D)``, gbest ``(D,)`` — and also take
a leading island axis — x ``(I, P, D)``, gbest ``(I, D)`` — in one launch.
A CPU tensor goes to :func:`pso_step_ref`; a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch import f32
from repro_torch.kernels import _build
from repro_torch.kernels.bench_eval import bench_eval_ref, check_tag

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def velocity(x, v, pbest, r1, r2, gbest, w=0.6, fp=1.0, fg=1.0,
             vmax=float("inf")):
    """``clip(w*v + fp*r1*(pbest - x) + fg*r2*(gbest - x), -vmax, vmax)``
    rounded as XLA contracts it: ``fma(fg*r2, gbest - x, fma(w, v,
    (fp*r1)*(pbest - x)))``. gbest is ``(..., D)``, one row per island."""
    cog = (fp * r1) * (pbest - x)
    nv = f32.fma(fg * r2, gbest.unsqueeze(-2) - x, f32.fma(w, v, cog))
    return torch.clamp(nv, -vmax, vmax)


def pso_step_ref(x, v, pbest, pbest_f, r1, r2, gbest, fn="sphere", shift=None,
                 bias=0.0, w=0.6, fp=1.0, fg=1.0, vmax=float("inf"),
                 lo=-100.0, hi=100.0):
    """Plain PyTorch version; returns ``(x, v, fit, pbest, pbest_f)``."""
    nv = velocity(x, v, pbest, r1, r2, gbest, w, fp, fg, vmax)
    nx = torch.clamp(x + nv, lo, hi)
    fit = bench_eval_ref(nx, fn, shift, bias)
    imp = fit < pbest_f
    return (nx, nv, fit, torch.where(imp[..., None], nx, pbest),
            torch.where(imp, fit, pbest_f))


def pso_step(x, v, pbest, pbest_f, r1, r2, gbest, fn="sphere", shift=None,
             bias=0.0, w=0.6, fp=1.0, fg=1.0, vmax=float("inf"), lo=-100.0,
             hi=100.0):
    """One fused PSO generation; returns ``(x, v, fit, pbest, pbest_f)``.

    x, v, pbest, r1, r2 ``([I,] P, D)`` float32; pbest_f ``([I,] P)``;
    gbest ``([I,] D)``, the island's incumbent position."""
    tag = check_tag(fn)
    if not _build.on_card("pso_step", x):
        return pso_step_ref(x, v, pbest, pbest_f, r1, r2, gbest, fn, shift,
                            bias, w, fp, fg, vmax, lo, hi)
    lead, (P, D) = tuple(x.shape[:-1]), x.shape[-2:]
    dev = x.device
    _build.check_inputs(dev, *((n, t, x.shape) for n, t in (
        ("x", x), ("v", v), ("pbest", pbest), ("r1", r1), ("r2", r2))),
        ("pbest_f", pbest_f, lead), ("gbest", gbest, (*lead[:-1], D)),
        ("shift", shift, (D,)))
    R = pbest_f.numel()
    if R == 0:
        return (x.clone(), v.clone(), pbest_f.clone(), pbest.clone(),
                pbest_f.clone())
    nx, nv, npb = (torch.empty_like(x) for _ in range(3))
    nf, npbf = torch.empty_like(pbest_f), torch.empty_like(pbest_f)
    _build.launch("pso_step", dev, x, v, pbest, pbest_f, r1, r2, gbest, shift,
                  nx, nv, nf, npb, npbf, R, P, D, tag, bias, w, fp, fg, vmax,
                  lo, hi)
    global LAUNCHES
    LAUNCHES += 1
    return nx, nv, nf, npb, npbf
