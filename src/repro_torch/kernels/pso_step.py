"""Fused PSO generation: the ``pso_step`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.pso_step`` (the Pallas kernel) and of
``repro.kernels.ref.pso_step_ref``: velocity update (inertia ``w``,
cognitive ``fp``, social ``fg``) clamped to ``±vmax``, position clipped to
the box, evaluation, and the personal-best update on strict ``<``, in one
pass. The island's gbest argmin stays with the caller.

Shapes keep the JAX signature — x ``(P, D)``, gbest ``(D,)`` — and also take
a leading island axis — x ``(I, P, D)``, gbest ``(I, D)`` — in one launch.
A CPU tensor goes to :func:`pso_step_ref`; a CUDA tensor to the kernel
(``csrc/pso_step.cu``, or ``csrc/pso_step_bf16.cu`` for bfloat16 storage),
one block a row of ``kernel_cfg.threads`` threads (tuned by
``kernels.autotune`` when unset).
"""
from __future__ import annotations

import torch

from repro_torch import f32
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.bench_eval import (bench_eval_ref, cast, check_tag, row_types, storage,
                                            storage_dtype, stored)

# Kernel launches in this process (plain-version calls are not counted),
# and those of them on the bfloat16 storage route.
LAUNCHES = 0
BF16_LAUNCHES = 0
# Threads a block may have (csrc/eval_tile.cuh's kThreads).
MAX_THREADS = 256


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
                 lo=-100.0, hi=100.0, dtype="float32"):
    """Plain PyTorch version; returns ``(x, v, fit, pbest, pbest_f)``.

    ``dtype``: the storage type. x, v, pbest, r1, r2, gbest and the shift
    are rounded through it and the three ``(P, D)`` outputs stored in it;
    the fitness is the unrounded position's, as the reference evaluates
    it."""
    x, v, pbest, r1, r2, gbest = (storage(t, dtype) for t in (x, v, pbest, r1, r2, gbest))
    nv = velocity(x, v, pbest, r1, r2, gbest, w, fp, fg, vmax)
    nx = torch.clamp(x + nv, lo, hi)
    fit = bench_eval_ref(nx, fn, storage(shift, dtype), bias)
    imp = fit < pbest_f
    return (storage(nx, dtype), storage(nv, dtype), fit,
            storage(torch.where(imp[..., None], nx, pbest), dtype),
            torch.where(imp, fit, pbest_f))


def pso_step(x, v, pbest, pbest_f, r1, r2, gbest, fn="sphere", shift=None,
             bias=0.0, w=0.6, fp=1.0, fg=1.0, vmax=float("inf"), lo=-100.0,
             hi=100.0, *, kernel_cfg: KernelConfig | None = None):
    """One fused PSO generation; returns ``(x, v, fit, pbest, pbest_f)``.

    x, v, pbest, r1, r2 ``([I,] P, D)`` float32; pbest_f ``([I,] P)``;
    gbest ``([I,] D)``, the island's incumbent position. ``kernel_cfg``:
    the storage type (the ``(P, D)`` operands may come in it; the outputs
    then keep it) and the threads per block (tuned when unset)."""
    tag = check_tag(fn)
    dtype = storage_dtype(kernel_cfg)
    if not _build.on_card("pso_step", x):
        return pso_step_ref(x, v, pbest, pbest_f, r1, r2, gbest, fn, shift,
                            bias, w, fp, fg, vmax, lo, hi, dtype)
    lead, (P, D) = tuple(x.shape[:-1]), x.shape[-2:]
    dev = x.device
    _build.check_inputs(dev, *((n, t, x.shape) for n, t in (
        ("x", x), ("v", v), ("pbest", pbest), ("r1", r1), ("r2", r2))),
        ("gbest", gbest, (*lead[:-1], D)), ("shift", shift, (D,)), dtype=row_types(dtype))
    _build.check_inputs(dev, ("pbest_f", pbest_f, lead))
    R = pbest_f.numel()
    if R == 0:
        return (x.clone(), v.clone(), pbest_f.clone(), pbest.clone(),
                pbest_f.clone())
    out_dtype = x.dtype
    x, v, pbest, r1, r2, gbest, shift = (stored(t, dtype)
                                         for t in (x, v, pbest, r1, r2, gbest, shift))
    nx, nv, npb = (torch.empty_like(x) for _ in range(3))
    nf, npbf = torch.empty_like(pbest_f), torch.empty_like(pbest_f)
    cfg = autotune.resolve(kernel_cfg, "pso_step", R, D, fn, device=dev)
    _build.launch(autotune.library("pso_step", dtype), dev, x, v, pbest, pbest_f, r1, r2,
                  gbest, shift, nx, nv, nf, npb, npbf, R, P, D, tag, bias, w, fp, fg,
                  vmax, lo, hi, cfg.threads)
    global LAUNCHES, BF16_LAUNCHES
    LAUNCHES += 1
    BF16_LAUNCHES += dtype == "bfloat16"
    return (cast(nx, out_dtype), cast(nv, out_dtype), nf, cast(npb, out_dtype), npbf)
