"""Fused evaluate-and-accept: the ``eval_select`` CUDA kernel and its plain
version.

Counterpart of ``repro.kernels.eval_select`` (the Pallas kernel) and of
``repro.kernels.ref.eval_select_ref``: evaluate candidate rows and accept
each on ``(dF <= 0) | (dF < thresh)``, with ``dF = f(trial) - fit``. A
threshold of 0 (or ``None``) is greedy selection; ``-T * ln(u)`` is SA's
Metropolis rule. Shapes keep the JAX signature — ``(P, D)`` — and also take
a leading island axis, ``(I, P, D)``, in one launch. The kernel
(``csrc/eval_select.cu``, on ``csrc/eval_row.cuh``; ``csrc/eval_select_bf16.cu``
for bfloat16 storage) takes its geometry from ``kernels.autotune``.
A CPU tensor goes to :func:`eval_select_ref`; a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.bench_eval import (bench_eval_ref, cast, check_tag, storage,
                                            row_types, storage_dtype, stored, tuned_geometry)

# Kernel launches in this process (plain-version calls are not counted),
# and those of them on the bfloat16 storage route.
LAUNCHES = 0
BF16_LAUNCHES = 0


def eval_select_ref(pop, fit, trial, thresh=None, fn="sphere", shift=None,
                    bias=0.0, dtype="float32"):
    """Plain PyTorch version; returns ``(new_pop, new_fit, accepted)``.

    ``dtype``: the storage type. pop, trial and the shift are rounded
    through it; fit and thresh stay float32."""
    out_dtype = pop.dtype
    pop, trial = storage(pop, dtype), storage(trial, dtype)
    tfit = bench_eval_ref(trial, fn, storage(shift, dtype), bias)
    dF = tfit - fit
    acc = dF <= 0.0
    if thresh is not None:
        acc = acc | (dF < thresh)
    return (torch.where(acc[..., None], trial, pop).to(out_dtype),
            torch.where(acc, tfit, fit), acc)


def eval_select(pop, fit, trial, thresh=None, fn="sphere", shift=None,
                bias=0.0, *, kernel_cfg: KernelConfig | None = None):
    """Evaluate ``trial`` and accept rows against ``(pop, fit)``.

    pop, trial ``([I,] P, D)`` float32; fit, thresh ``([I,] P)``. Returns
    ``(new_pop, new_fit, accepted)``. ``kernel_cfg``: the storage type (the
    ``(P, D)`` operands may come in it; the outputs then keep it) and the
    geometry (tuned when unset)."""
    tag = check_tag(fn)
    dtype = storage_dtype(kernel_cfg)
    if not _build.on_card("eval_select", pop):
        return eval_select_ref(pop, fit, trial, thresh, fn, shift, bias, dtype)
    lead, D = tuple(pop.shape[:-1]), pop.shape[-1]
    dev = pop.device
    _build.check_inputs(dev, ("pop", pop, pop.shape), ("trial", trial, pop.shape),
                        ("shift", shift, (D,)), dtype=row_types(dtype))
    _build.check_inputs(dev, ("fit", fit, lead), ("thresh", thresh, lead))
    R = fit.numel()
    if R == 0:
        return pop.clone(), fit.clone(), torch.zeros_like(fit, dtype=torch.bool)
    out_dtype = pop.dtype
    pop, trial, shift = stored(pop, dtype), stored(trial, dtype), stored(shift, dtype)
    npop = torch.empty_like(pop)
    nfit = torch.empty_like(fit)
    acc = torch.empty_like(fit, dtype=torch.bool)
    g = tuned_geometry("eval_select", kernel_cfg, R, D, fn, pop, trial, shift, npop)
    _build.launch(autotune.library("eval_select", dtype), dev, pop, fit, trial, thresh,
                  shift, npop, nfit, acc, R, D, tag, bias, int(g.vec), g.warps_per_row,
                  g.rows_per_block, g.slots_per_thread, int(g.staged))
    global LAUNCHES, BF16_LAUNCHES
    LAUNCHES += 1
    BF16_LAUNCHES += dtype == "bfloat16"
    return cast(npop, out_dtype), nfit, acc
