"""Population evaluation: the ``bench_eval`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.bench_eval`` (the Pallas kernel) and of
``repro.kernels.ref.bench_eval_ref``. :func:`bench_eval` dispatches on the
tensor's device: a CPU tensor goes to :func:`bench_eval_ref`; a CUDA tensor
goes to the kernel in ``csrc/bench_eval.cu``, which is built at first use —
there is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.functions import benchmarks as bm
from repro_torch.kernels import _build

# Objective bodies the kernel implements, in the order of ``popt::Tag`` in
# ``csrc/eval_tile.cuh``. ``kernels.registry`` maps function names to these.
EVAL_TAGS = (
    "sphere", "rastrigin", "rosenbrock", "ackley", "shifted_rosenbrock",
    "griewank", "schwefel", "levy", "dropwave", "michalewicz",
)

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def check_tag(fn: str) -> int:
    """Index of eval tag ``fn``; ValueError for a tag with no kernel body."""
    if fn not in EVAL_TAGS:
        raise ValueError(
            f"no kernel body for eval tag {fn!r}; implemented: {EVAL_TAGS} "
            f"(kernels.registry maps function names to these tags)")
    return EVAL_TAGS.index(fn)


def bench_eval_ref(pop: torch.Tensor, fn: str, shift: torch.Tensor | None = None,
                   bias: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: ``f(pop - shift) + bias`` over the last axis."""
    x = pop.float()
    if shift is not None:
        x = x - shift
    if fn == "shifted_rosenbrock":
        return bm.rosenbrock(x + 1.0) + bias
    return getattr(bm, fn)(x) + bias


def bench_eval(pop: torch.Tensor, fn: str, shift: torch.Tensor | None = None,
               bias: float = 0.0) -> torch.Tensor:
    """pop ``(P, D)`` float32 -> fitness ``(P,)``. ``shift``: ``(D,)``."""
    tag = check_tag(fn)
    if not _build.on_card("bench_eval", pop, dims=(2,)):
        return bench_eval_ref(pop, fn, shift, bias)
    P, D = pop.shape
    dev = pop.device
    _build.check_inputs(dev, ("pop", pop, (P, D)), ("shift", shift, (D,)))
    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    _build.launch("bench_eval", dev, pop, shift, out, P, D, tag, bias)
    global LAUNCHES
    LAUNCHES += 1
    return out
