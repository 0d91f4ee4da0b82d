"""Population evaluation: the ``bench_eval`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.bench_eval`` (the Pallas kernel) and of
``repro.kernels.ref.bench_eval_ref``. :func:`bench_eval` dispatches on the
tensor's device: a CPU tensor goes to :func:`bench_eval_ref`; a CUDA tensor
goes to the kernel in ``csrc/bench_eval.cu`` (``csrc/bench_eval_bf16.cu``
with ``KernelConfig(dtype="bfloat16")``), which is built at first use —
there is no fallback from the card to the plain version.

:func:`geometry` is how the kernels on ``csrc/eval_row.cuh``
(``bench_eval.cu``, ``de_step.cu``, ``ga_step.cu``, ``eval_select.cu``) lay a
population over the card: warps per row, rows per block, register slots per
thread, and 4-lane or scalar loads. ``kernels.autotune`` chooses among
the rows a block holds for each shape class, at the warps a row that
:func:`row_warps` gives for ``D`` (they fix the order of a row's sum);
:func:`launch_geometry` is the fixed heuristic that chose before it, kept
as one candidate and a point of comparison.

Storage: ``kernel_cfg.dtype`` is the type the kernel reads and writes the
``(P, D)`` rows and the shift in. At "bfloat16" the wrapper casts them
(:func:`stored`), the kernel widens each lane to float32, and the plain
version rounds the same operands (:func:`storage`), as the reference
casts them before its Pallas call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.functions import benchmarks as bm
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.parallel import roofline

# Objective bodies the kernel implements, in the order of ``popt::Tag`` in
# ``csrc/eval_tile.cuh`` (which ``csrc/eval_row.cuh`` includes).
# ``kernels.registry`` maps function names to these.
EVAL_TAGS = (
    "sphere", "rastrigin", "rosenbrock", "ackley", "shifted_rosenbrock",
    "griewank", "schwefel", "levy", "dropwave", "michalewicz",
)

# Kernel launches in this process (plain-version calls are not counted),
# and those of them on the bfloat16 storage route.
LAUNCHES = 0
BF16_LAUNCHES = 0

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

    ``vec``: 4-lane slots read as one vector load, 16 bytes of float32 or 8
    of bfloat16 (else one lane a slot);
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


def geometry(P: int, D: int, vec: bool, warps_per_row: int, rows_per_block: int) -> Geometry:
    """The launch of ``P`` rows of ``D`` lanes with 4-lane slots (``vec``) or
    scalar ones, ``warps_per_row`` warps a row and ``rows_per_block`` rows a
    block: the slots a thread holds (2, or 4 where its part needs more) and
    whether the row fits one batch (``staged``) follow."""
    slots = D // 4 if vec else D
    W, R = warps_per_row, rows_per_block
    iters = max(1, -(-slots // (32 * W)))
    staged = iters <= MAX_SLOTS
    K = slots_per_thread(iters)
    return Geometry(vec, W, R, K, staged, iters, -(-P // R), 32 * W * R, SMEM_BYTES)


def row_warps(D: int, vec: bool) -> int:
    """The warps a row of ``D`` lanes takes: the fewest (a power of two up
    to ``MAX_BLOCK_WARPS``) whose threads hold it in ``TARGET_SLOTS`` slots
    each. They fix the order in which the row's lanes are summed, so they
    depend on ``D`` alone: a row's fitness has the same bits in a bucket of
    jobs, a rank's shard and a standalone run."""
    slots = D // 4 if vec else D
    W = 1
    while W < MAX_BLOCK_WARPS and 32 * W * TARGET_SLOTS < slots:
        W *= 2
    return W


def launch_geometry(P: int, D: int, ptr_alignment: int, n_sms: int,
                    itemsize: int = 4) -> Geometry:
    """The geometry for ``P`` rows of ``D`` lanes of ``itemsize`` bytes whose
    pointers are all aligned to ``ptr_alignment`` bytes, on a card of
    ``n_sms`` SMs.

    4-lane slots (16 bytes of float32, 8 of bfloat16) where the pointers
    allow it and ``D % 4 == 0``. A row
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
    vec = ptr_alignment % (4 * itemsize) == 0 and D % 4 == 0
    W = row_warps(D, vec)
    R = max(1, TARGET_BLOCK_WARPS // W)
    while R > 1 and -(-P // R) < n_sms:
        R //= 2
    return geometry(P, D, vec, W, R)


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


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA ``device``."""
    return roofline.card_of(device).sms


_DEFAULT_CFG = KernelConfig()


def tuned_geometry(kind: str, kernel_cfg: KernelConfig | None, P: int, D: int, tag: str,
                   *tensors: torch.Tensor | None) -> Geometry:
    """The geometry of a launch of ``kind`` on CUDA tensors ``tensors``
    (the first sets the device), stored as ``kernel_cfg.dtype``:
    ``kernel_cfg`` resolved by ``kernels.autotune`` (4-lane slots only
    where every pointer is aligned to them). The wrappers launch this
    geometry; pass them the pointers they launch on."""
    cfg = kernel_cfg if kernel_cfg is not None else _DEFAULT_CFG
    aligned = pointer_alignment(*tensors) % (4 * cfg.itemsize()) == 0
    c = autotune.resolve(cfg, kind, P, D, tag, device=tensors[0].device, aligned=aligned)
    return geometry(P, D, c.vec, c.warps_per_row, c.rows_per_block)


def storage_dtype(kernel_cfg: KernelConfig | None) -> str:
    """The storage type ``kernel_cfg`` asks for ("float32" if ``None``)."""
    return "float32" if kernel_cfg is None else kernel_cfg.dtype


def storage(t: torch.Tensor | None, dtype: str) -> torch.Tensor | None:
    """``t`` rounded through the storage type ``dtype`` (to nearest even,
    as XLA's convert and the kernels round) and widened back to float32:
    what the plain versions compute on. "float32" leaves ``t`` as it is."""
    if t is None or dtype == "float32":
        return t
    return t.to(torch.bfloat16).float()


def cast(t: torch.Tensor | None, want: torch.dtype) -> torch.Tensor | None:
    """``t`` as ``want``: ``t`` itself where it already is, with no call
    into torch (the wrappers' host time bounds the generations)."""
    return t if t is None or t.dtype == want else t.to(want)


def stored(t: torch.Tensor | None, dtype: str) -> torch.Tensor | None:
    """``t`` in the storage type ``dtype`` for a kernel (a cast only where
    it differs)."""
    return cast(t, autotune.STORAGE[dtype])


_ROW_TYPES = {d: tuple(dict.fromkeys((torch.float32, t))) for d, t in autotune.STORAGE.items()}


def row_types(dtype: str) -> tuple[torch.dtype, ...]:
    """The types a wrapper takes its ``(P, D)`` operands and broadcast rows
    in at storage ``dtype``: float32, or already the storage type (then
    nothing is cast, and the outputs come back in it)."""
    return _ROW_TYPES[dtype]


def check_tag(fn: str) -> int:
    """Index of eval tag ``fn``; ValueError for a tag with no kernel body."""
    if fn not in EVAL_TAGS:
        raise ValueError(
            f"no kernel body for eval tag {fn!r}; implemented: {EVAL_TAGS} "
            f"(kernels.registry maps function names to these tags)")
    return EVAL_TAGS.index(fn)


def bench_eval_ref(pop: torch.Tensor, fn: str, shift: torch.Tensor | None = None,
                   bias: float = 0.0, dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version: ``f(pop - shift) + bias`` over the last axis,
    with ``pop`` and ``shift`` rounded through the storage type ``dtype``."""
    x = storage(pop.float(), dtype)
    if shift is not None:
        x = x - storage(shift, dtype)
    if fn == "shifted_rosenbrock":
        return bm.rosenbrock(x + 1.0) + bias
    return getattr(bm, fn)(x) + bias


def bench_eval(pop: torch.Tensor, fn: str, shift: torch.Tensor | None = None,
               bias: float = 0.0, *, kernel_cfg: KernelConfig | None = None) -> torch.Tensor:
    """pop ``(P, D)`` float32 (or of the storage type) -> fitness ``(P,)``
    float32. ``shift``: ``(D,)``.

    ``kernel_cfg`` (threaded from ``ExecutorConfig.kernel``): the storage
    type and the geometry, whose unset fields ``kernels.autotune`` fills."""
    tag = check_tag(fn)
    dtype = storage_dtype(kernel_cfg)
    if not _build.on_card("bench_eval", pop, dims=(2,)):
        return bench_eval_ref(pop, fn, shift, bias, dtype)
    P, D = pop.shape
    dev = pop.device
    _build.check_inputs(dev, ("pop", pop, (P, D)), ("shift", shift, (D,)),
                        dtype=row_types(dtype))
    pop, shift = stored(pop, dtype), stored(shift, dtype)
    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    g = tuned_geometry("bench_eval", kernel_cfg, P, D, fn, pop, shift)
    _build.launch(autotune.library("bench_eval", dtype), dev, pop, shift, out, P, D, tag,
                  bias, int(g.vec), g.warps_per_row, g.rows_per_block)
    global LAUNCHES, BF16_LAUNCHES
    LAUNCHES += 1
    BF16_LAUNCHES += dtype == "bfloat16"
    return out

