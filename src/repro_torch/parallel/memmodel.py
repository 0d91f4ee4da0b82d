"""The analytic per-device HBM model of each (arch x shape x mesh) cell,
and a block's footprint on Hopper (the counterpart of ``pallas_tile_bytes``).

Counterpart of ``repro.parallel.memmodel``. :func:`analytic_memory` gives,
term for term, the reference's first-principles expectation of a cell's
bytes a device, over the port's spec trees (``parallel.sharding``) and
``meta`` shape trees (``param_shapes``, ``configs.shapes``):

  train: master params (f32, storage-sharded) + Adam moments (2x) +
         grads (f32, storage-sharded) + bf16 compute copies (TP-sharded) +
         remat stash (ceil(L/G) x B_dev*S*D bf16) + per-group working set +
         chunked-CE logits + batch
  serve: bf16 params (TP-sharded) + caches (sharded per decode specs) +
         activation working set

The decode state's ``pos``, a host integer in the port, counts as the
reference's int32 scalar (4 bytes), so the ``caches`` term is the
reference's. The dry-run (``launch.dryrun``) reports it beside the traced
peak (``parallel.roofline.analyze``).

``repro.parallel.memmodel.pallas_tile_bytes`` sizes one Pallas grid step's
double-buffered VMEM working set, which must fit the TPU core's VMEM. On
the card a kernel has no such tile: a block of ``csrc/eval_row.cuh`` holds
its slots of a row in registers and declares a few bytes of static shared
memory for its reduction, and ``pso_step``'s block (``csrc/eval_tile.cuh``)
holds nothing but its reduction. A geometry is feasible when its block fits
the limits those kernels are built for: ``MAX_BLOCK_WARPS``, ``MAX_SLOTS``
and ``SMEM_LIMIT`` of ``kernels.bench_eval`` (``pso_step.MAX_THREADS`` for
``pso_step``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import tree_map

PyTree = Any

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


# ---------------------------------------------------------------------------
# the analytic HBM model of the model stack
# ---------------------------------------------------------------------------

def _axis_sizes(mesh_axes: tuple[str, ...]) -> dict[str, int]:
    return {"pod": 2, "data": 16, "model": 16} if "pod" in mesh_axes else \
        {"data": 16, "model": 16}


def _shard_fraction(spec, sizes: dict[str, int]) -> float:
    denom = 1
    for part in spec:
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            denom *= sizes.get(ax, 1)
    return 1.0 / denom


def _numel_itemsize(leaf) -> tuple[int, int]:
    """(elements, bytes an element) of a shape-tree leaf: a tensor, or a
    host integer standing for the reference's int32 scalar."""
    if isinstance(leaf, int):
        return 1, 4
    return math.prod(leaf.shape), leaf.dtype.itemsize


def sharded_bytes(shapes: PyTree, specs: PyTree, sizes: dict[str, int],
                  itemsize: int | None = None) -> float:
    total = 0.0

    def add(arr, spec) -> None:
        nonlocal total
        n, isz = _numel_itemsize(arr)
        isz = itemsize if itemsize is not None else isz
        total += n * isz * _shard_fraction(spec, sizes)

    tree_map(add, shapes, specs)
    return total


def analytic_memory(cfg: ModelConfig, kind: str, mesh_axes: tuple[str, ...],
                    B: int, S: int, params_shape: PyTree, p_specs: PyTree,
                    c_specs: PyTree | None, state_shape: PyTree = None,
                    state_specs: PyTree = None) -> dict[str, float]:
    sizes = _axis_sizes(mesh_axes)
    dax = sizes["data"] * sizes.get("pod", 1)
    b_dev = max(1, B // dax) if B % dax == 0 else B
    D = cfg.d_model
    G = cfg.remat_group if cfg.n_layers % cfg.remat_group == 0 else 1

    out: dict[str, float] = {}
    if kind == "train":
        master = sharded_bytes(params_shape, p_specs, sizes, itemsize=4)
        out["master_params"] = master
        out["adam_moments"] = 2 * master
        out["grads"] = master
        comp_specs = c_specs if c_specs is not None else p_specs
        out["bf16_compute_copies"] = sharded_bytes(params_shape, comp_specs,
                                                   sizes, itemsize=2)
        if cfg.block_pattern == "ssm+shared_attn":
            n_entries = cfg.n_layers // cfg.shared_attn_every + 1
        else:
            n_entries = math.ceil(cfg.n_layers / G)
        out["remat_stash"] = n_entries * b_dev * S * D * 2
        # transient working set during a group's backward recompute: the
        # scheduler frees layer intermediates as it goes — ~2 layers live
        # (4 full-width residual/cotangent streams + widest hidden each)
        ff_shard = max(cfg.d_ff, cfg.expert_ff, cfg.n_heads * cfg.hd) / sizes["model"]
        out["working_set"] = (min(G, 2) * b_dev * S * (4 * D + 2 * ff_shard) * 2)
        n_chunks = cfg.ce_chunks if S % max(cfg.ce_chunks, 1) == 0 else 1
        out["ce_logits"] = 2 * b_dev * (S // n_chunks) * (cfg.padded_vocab / sizes["model"]) * 4
        out["batch"] = 2 * b_dev * S * 4
    else:
        comp_specs = c_specs if c_specs is not None else p_specs
        out["bf16_params"] = sharded_bytes(params_shape, comp_specs, sizes,
                                           itemsize=2)
        if state_shape is not None:
            out["caches"] = sharded_bytes(state_shape, state_specs, sizes)
        width = 4 * D + 2 * max(cfg.d_ff, cfg.n_heads * cfg.hd) / sizes["model"]
        s_eff = S if kind == "prefill" else 1
        out["working_set"] = b_dev * s_eff * width * 2
        if kind == "prefill":
            out["attn_chunk"] = (b_dev * cfg.n_heads / sizes["model"]
                                 * S * cfg.attn_kv_block * 4)
        out["logits"] = b_dev * (cfg.padded_vocab / sizes["model"]) * 4
    out["total"] = sum(out.values())
    return out
