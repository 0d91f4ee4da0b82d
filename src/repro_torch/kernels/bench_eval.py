"""Population evaluation: the ``bench_eval`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.bench_eval`` (the Pallas kernel) and of
``repro.kernels.ref.bench_eval_ref``. :func:`bench_eval` dispatches on the
tensor's device: a CPU tensor goes to :func:`bench_eval_ref`; a CUDA tensor
goes to the kernel in ``csrc/bench_eval.cu``, which is built at first use —
there is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

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


def check_cuda(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bench_eval(pop: torch.Tensor, fn: str, shift: torch.Tensor | None = None,
               bias: float = 0.0) -> torch.Tensor:
    """pop ``(P, D)`` float32 -> fitness ``(P,)``. ``shift``: ``(D,)``."""
    tag = check_tag(fn)
    if pop.device.type == "cpu":
        return bench_eval_ref(pop, fn, shift, bias)
    if pop.device.type != "cuda":
        raise ValueError(f"bench_eval runs on cpu or cuda, not {pop.device}")
    if pop.dim() != 2:
        raise ValueError(f"pop must be (P, D), got {tuple(pop.shape)}")
    P, D = pop.shape
    check_cuda("pop", pop, (P, D), pop.device)
    if shift is not None:
        check_cuda("shift", shift, (D,), pop.device)
    out = torch.empty(P, dtype=torch.float32, device=pop.device)
    if P == 0:
        return out
    lib = _build.library("bench_eval")
    stream = torch.cuda.current_stream(pop.device).cuda_stream
    err = lib.bench_eval_launch(
        pop.data_ptr(), None if shift is None else shift.data_ptr(),
        out.data_ptr(), P, D, tag, ctypes.c_float(bias), stream)
    _build.check(err, "bench_eval")
    global LAUNCHES
    LAUNCHES += 1
    return out
