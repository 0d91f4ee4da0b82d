"""A block's footprint on Hopper: the counterpart of ``pallas_tile_bytes``.

``repro.parallel.memmodel.pallas_tile_bytes`` sizes one Pallas grid step's
double-buffered VMEM working set, which must fit the TPU core's VMEM. On
the card a kernel has no such tile: a block of ``csrc/eval_row.cuh`` holds
its slots of a row in registers and declares a few bytes of static shared
memory for its reduction, and ``pso_step``'s block (``csrc/eval_tile.cuh``)
holds nothing but its reduction. A geometry is feasible when its block fits
the limits those kernels are built for: ``MAX_BLOCK_WARPS``, ``MAX_SLOTS``
and ``SMEM_LIMIT`` of ``kernels.bench_eval`` (``pso_step.MAX_THREADS`` for
``pso_step``).

Not ported yet: the analytic per-device HBM model of the model stack
(``analytic_memory``, ``sharded_bytes``), which serves the planning tools
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses

# Slot arrays (``Slot<V>[K]``) a thread of each eval_row.cuh kernel holds in
# registers in one batch: bench_eval the row and the shift; de_step the
# parent, u, the shift, the trial and three donors; ga_step the child, the
# shift, the old slot row, um and noise; eval_select the trial, the shift
# and the incumbent.
ROW_ARRAYS = {"bench_eval": 2, "de_step": 7, "ga_step": 5, "eval_select": 3}


@dataclasses.dataclass(frozen=True)
class Footprint:
    """One block of a kernel at a geometry: its warps, static shared memory,
    the register slots a thread holds (``slots``: slot arrays times slots
    per thread) and the float32 registers they take (``regs``: slots times
    lanes a slot). ``reason`` says which limit it breaks ("" if none)."""

    kind: str
    warps: int
    smem_bytes: int
    slots: int
    regs: int
    reason: str = ""

    @property
    def feasible(self) -> bool:
        return not self.reason


def _power_of_two(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def block_footprint(kind: str, *, vec: bool = True, warps_per_row: int = 1,
                    rows_per_block: int = 1, slots_per_thread: int | None = None,
                    threads: int | None = None) -> Footprint:
    """The footprint of one block of ``kind`` (a kind of
    ``kernels.autotune.KIND_PROFILES``).

    The four ``eval_row.cuh`` kernels take ``vec`` (4-lane slots),
    ``warps_per_row`` (a power of two), ``rows_per_block`` and
    ``slots_per_thread`` (2 or 4, 4 if ``None``; bench_eval always holds
    4); ``pso_step`` takes ``threads`` per block."""
    from repro_torch.kernels import bench_eval as _be   # late: the kernels import the tuner,
    from repro_torch.kernels import pso_step as _pso    # which imports this module
    if kind == "pso_step":
        t = _pso.MAX_THREADS if threads is None else threads
        smem = 4 * (2 * (_pso.MAX_THREADS // 32) + 1)   # red_a, red_b, result
        reason = ""
        if t < 32 or t % 32 or t > _pso.MAX_THREADS:
            reason = f"threads {t} is not a multiple of 32 in [32, {_pso.MAX_THREADS}]"
        return Footprint(kind, max(t // 32, 0), smem, 0, 0, reason)
    if kind not in ROW_ARRAYS:
        raise KeyError(f"no footprint for kernel kind {kind!r}")
    W, R = warps_per_row, rows_per_block
    K = _be.MAX_SLOTS if kind == "bench_eval" or slots_per_thread is None \
        else slots_per_thread
    slots = ROW_ARRAYS[kind] * K
    reason = ""
    if not _power_of_two(W) or R < 1 or W * R > _be.MAX_BLOCK_WARPS:
        reason = (f"{W} warps a row x {R} rows: a power of two times rows of "
                  f"at most {_be.MAX_BLOCK_WARPS} warps")
    elif K not in (2, _be.MAX_SLOTS):
        reason = f"{K} slots a thread: the kernels are built for 2 or {_be.MAX_SLOTS}"
    elif _be.SMEM_BYTES > _be.SMEM_LIMIT:
        reason = f"{_be.SMEM_BYTES} bytes of shared memory over {_be.SMEM_LIMIT}"
    return Footprint(kind, W * R, _be.SMEM_BYTES, slots, slots * (4 if vec else 1), reason)
