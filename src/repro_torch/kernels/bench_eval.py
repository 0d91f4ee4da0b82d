"""Population evaluation: the ``bench_eval`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.bench_eval`` (the Pallas kernel) and of
``repro.kernels.ref.bench_eval_ref``. :func:`bench_eval` dispatches on the
tensor's device: a CPU tensor goes to :func:`bench_eval_ref`; a CUDA tensor
goes to the kernel in ``csrc/bench_eval.cu``, which is built at first use —
there is no fallback from the card to the plain version.

:func:`launch_geometry` picks how the kernels on ``csrc/eval_row.cuh``
(``bench_eval.cu``, ``de_step.cu``, ``ga_step.cu``, ``eval_select.cu``) lay a
population over the card: warps per row, rows per block, register slots per
thread, and 16-byte or scalar loads.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.functions import benchmarks as bm
from repro_torch.kernels import _build

# Objective bodies the kernel implements, in the order of ``popt::Tag`` in
# ``csrc/eval_tile.cuh`` (which ``csrc/eval_row.cuh`` includes).
# ``kernels.registry`` maps function names to these.
EVAL_TAGS = (
    "sphere", "rastrigin", "rosenbrock", "ackley", "shifted_rosenbrock",
    "griewank", "schwefel", "levy", "dropwave", "michalewicz",
)

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0

# eval_row.cuh's limits: warps per block (rows per block x warps per row)
# and register slots a thread holds per batch.
MAX_BLOCK_WARPS = 8
MAX_SLOTS = 4
# The geometry's targets: slots a thread holds (rows take warps until it
# holds no more), and warps a block holds (rows share a block up to it).
TARGET_SLOTS = 2
TARGET_BLOCK_WARPS = 4
# Shared memory a block may use on Hopper (bytes) and what eval_row.cuh's
# reduction declares, statically: four floats and a flag per warp.
SMEM_LIMIT = 232448
SMEM_BYTES = MAX_BLOCK_WARPS * (4 * 4 + 1)


class Geometry(NamedTuple):
    """A launch of a kernel on ``eval_row.cuh``.

    ``vec``: 4-lane slots read as 16-byte loads (else one lane a slot);
    ``warps_per_row`` warps share a row, ``rows_per_block`` rows share a
    block; each thread holds ``slots_per_thread`` slots per batch;
    ``staged``: the whole row fits one batch (the one-pass kernels of
    de_step, ga_step and eval_select);
    ``iters``: slot iterations a warp makes over its part of a row."""

    vec: bool
    warps_per_row: int
    rows_per_block: int
    slots_per_thread: int
    staged: bool
    iters: int
    blocks: int
    threads: int
    smem_bytes: int


def slots_per_thread(iters: int) -> int:
    """The register slots (2 or 4; the staged kernels are built for these)
    that hold ``iters`` iterations, or 4 for a row walked in batches."""
    return 2 if iters <= 2 else MAX_SLOTS


def launch_geometry(P: int, D: int, ptr_alignment: int, n_sms: int) -> Geometry:
    """The geometry for ``P`` rows of ``D`` lanes whose pointers are all
    aligned to ``ptr_alignment`` bytes, on a card of ``n_sms`` SMs.

    16-byte slots where the pointers allow it and ``D % 4 == 0``. A row
    takes the fewest warps (a power of two up to 8) whose threads hold it
    in ``TARGET_SLOTS`` slots each; a thread then holds 2 slots, or 4 where
    its part needs more, and a row that needs more than
    ``MAX_SLOTS`` is not staged: eight warps walk it in batches. Rows share
    a block up to ``TARGET_BLOCK_WARPS`` warps, fewer while that would
    leave SMs without a block. (At D = 1000 this is 4 warps a row, 2 slots
    a thread and one row a block: on the H100, in the sweeps of
    ``tools/eval_row_timings.py``, the fastest geometry for bench_eval and
    de_step at 800 rows, de_step at 8 x 800 rows, ga_step at 8 x 200 rows
    and eval_select at 800 rows, and within 4% of the fastest, 8 warps a
    row, at bench_eval's 100-row chunk and ga_step's 200 and 8 x 1 rows.)"""
    vec = ptr_alignment % 16 == 0 and D % 4 == 0
    slots = D // 4 if vec else D
    W = 1
    while W < MAX_BLOCK_WARPS and 32 * W * TARGET_SLOTS < slots:
        W *= 2
    iters = max(1, -(-slots // (32 * W)))
    staged = iters <= MAX_SLOTS
    K = slots_per_thread(iters)
    R = max(1, TARGET_BLOCK_WARPS // W)
    while R > 1 and -(-P // R) < n_sms:
        R //= 2
    blocks = -(-P // R)
    return Geometry(vec, W, R, K, staged, iters, blocks, 32 * W * R, SMEM_BYTES)


def pointer_alignment(*tensors: torch.Tensor | None) -> int:
    """The largest power of two, up to 16, dividing every tensor's data
    address (``None`` is skipped)."""
    align = 16
    for t in tensors:
        if t is not None:
            addr = t.data_ptr()
            while addr % align:
                align //= 2
    return align


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def geometry_for(P: int, D: int, *tensors: torch.Tensor | None) -> Geometry:
    """:func:`launch_geometry` for CUDA tensors ``tensors`` (the first sets
    the device)."""
    return launch_geometry(P, D, pointer_alignment(*tensors), sm_count(tensors[0].device))


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
    g = geometry_for(P, D, pop, shift)
    _build.launch("bench_eval", dev, pop, shift, out, P, D, tag, bias, int(g.vec),
                  g.warps_per_row, g.rows_per_block)
    global LAUNCHES
    LAUNCHES += 1
    return out
