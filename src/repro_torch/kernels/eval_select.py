"""Fused evaluate-and-accept: the ``eval_select`` CUDA kernel and its plain
version.

Counterpart of ``repro.kernels.eval_select`` (the Pallas kernel) and of
``repro.kernels.ref.eval_select_ref``: evaluate candidate rows and accept
each on ``(dF <= 0) | (dF < thresh)``, with ``dF = f(trial) - fit``. A
threshold of 0 (or ``None``) is greedy selection; ``-T * ln(u)`` is SA's
Metropolis rule. Shapes keep the JAX signature — ``(P, D)`` — and also take
a leading island axis, ``(I, P, D)``, in one launch. The kernel
(``csrc/eval_select.cu``, on ``csrc/eval_row.cuh``) takes its geometry from
:func:`~repro_torch.kernels.bench_eval.launch_geometry`.
A CPU tensor goes to :func:`eval_select_ref`; a CUDA tensor to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bench_eval import bench_eval_ref, check_tag, geometry_for

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def eval_select_ref(pop, fit, trial, thresh=None, fn="sphere", shift=None,
                    bias=0.0):
    """Plain PyTorch version; returns ``(new_pop, new_fit, accepted)``."""
    tfit = bench_eval_ref(trial, fn, shift, bias)
    dF = tfit - fit
    acc = dF <= 0.0
    if thresh is not None:
        acc = acc | (dF < thresh)
    return (torch.where(acc[..., None], trial, pop),
            torch.where(acc, tfit, fit), acc)


def eval_select(pop, fit, trial, thresh=None, fn="sphere", shift=None,
                bias=0.0):
    """Evaluate ``trial`` and accept rows against ``(pop, fit)``.

    pop, trial ``([I,] P, D)`` float32; fit, thresh ``([I,] P)``. Returns
    ``(new_pop, new_fit, accepted)``."""
    tag = check_tag(fn)
    if not _build.on_card("eval_select", pop):
        return eval_select_ref(pop, fit, trial, thresh, fn, shift, bias)
    lead, D = tuple(pop.shape[:-1]), pop.shape[-1]
    dev = pop.device
    _build.check_inputs(dev, ("pop", pop, pop.shape), ("trial", trial, pop.shape),
                        ("fit", fit, lead), ("thresh", thresh, lead),
                        ("shift", shift, (D,)))
    R = fit.numel()
    if R == 0:
        return pop.clone(), fit.clone(), torch.zeros_like(fit, dtype=torch.bool)
    npop = torch.empty_like(pop)
    nfit = torch.empty_like(fit)
    acc = torch.empty_like(fit, dtype=torch.bool)
    g = geometry_for(R, D, pop, trial, shift, npop)
    _build.launch("eval_select", dev, pop, fit, trial, thresh, shift, npop,
                  nfit, acc, R, D, tag, bias, int(g.vec), g.warps_per_row,
                  g.rows_per_block, g.slots_per_thread, int(g.staged))
    global LAUNCHES
    LAUNCHES += 1
    return npop, nfit, acc
