"""Kernel configuration for the card: ``KernelConfig`` and the geometry tuner.

Counterpart of ``repro.kernels.autotune``. One :class:`KernelConfig` is
threaded from ``ExecutorConfig.kernel`` through the engine (``IslandOptimizer``
and ``core.portfolio.build_portfolio`` inject it into every maker that
declares ``kernel_cfg``) into the five population kernels: ``bench_eval``,
``de_step``, ``pso_step``, ``ga_step`` and ``eval_select``. Each wrapper
resolves it with :func:`resolve`: fields left ``None`` are filled by a tuner
that scores every geometry a block admits
(``parallel.memmodel.block_footprint``) with a roofline of the card
(``parallel.roofline``), and keeps the winner per shape class, so a shape
class is tuned once per process and every later build is a cache hit.

Where the reference differs:

* **Geometry, not tiles.** The Pallas fields ``pop_block``, ``dim_pad`` and
  ``interpret`` mean nothing on the card. The four kernels on
  ``csrc/eval_row.cuh`` take ``vec`` (4-lane slots), ``warps_per_row`` and
  ``rows_per_block`` (the slots a thread holds, and whether the row is
  staged, follow: ``kernels.bench_eval.geometry``); ``pso_step`` takes
  ``threads`` per block.
* **The device, not ``interpret``, picks the route.** A CPU tensor goes to
  the wrapper's plain version and a CUDA tensor to the kernel, whatever the
  config says. On the CPU only ``dtype`` matters: the plain version rounds
  the operands the kernel stores in that type. The tuner needs a card: a
  CUDA device, or a :class:`~repro_torch.parallel.roofline.Card` given by
  hand (the tests score the H100 that way).
* **The score** (:func:`predict`) is the card's: bytes at the storage
  itemsize over HBM's rate, float32 operations over the CUDA cores' (the
  population kernels use no tensor core), blocks in waves over the SMs, and
  the launch floor, plus what orders the geometries: the dependent round
  trips to memory a row makes, the per-thread work after the data arrives,
  and the warps launched. ``KIND_PROFILES`` keeps the reference's operand
  counts.
* **The measured sweep** (``measure=True``) times the model's four best
  candidates on the card with CUDA events and raises where a candidate
  fails to build or launch (the reference skips it); on a CPU tensor, where
  there is nothing to time, it raises.

Cached configs are keyed by ``(kind, rows, D, tag, dtype, compute
capability, SM count, aligned, measure)``; ``aligned`` says whether the
pointers allow 4-lane slots, which decides the candidate set.

What the tuner does not choose: the fields that fix the order of a row's
sum (``ORDER_FIELDS``: 4-lane slots and warps a row; ``pso_step``'s
threads). A row's fitness must have the same bits in a bucket of jobs, a
rank's shard and a standalone run, whatever rows are launched beside it, so
these follow from ``D`` and the pointers alone (:func:`order_fields`), as
``launch_geometry`` took them; the model and the measured sweep choose the
rows a block holds, which leaves each row's sum as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.parallel import memmodel
from repro_torch.parallel import roofline as rl
from repro_torch.parallel.roofline import Card, Roofline

# Storage types a population may take on the card, by KernelConfig.dtype.
STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """How the population kernels lay out and store a launch: one config
    threaded from ``ExecutorConfig.kernel`` to every kernel it reaches.

    ``vec``, ``warps_per_row`` and ``rows_per_block`` are the geometry of
    the ``eval_row.cuh`` kernels, ``threads`` the block of ``pso_step``;
    ``None`` means the tuner fills it in for the shape class. ``dtype`` is
    the storage type of the ``(P, D)`` operands and outputs, and of the
    broadcast rows (shift, gbest): "float32" or "bfloat16". Every kernel
    computes in float32 and keeps fitness and per-row operands in float32;
    bfloat16 halves the bytes moved at a rounding of each stored element.
    """

    vec: bool | None = None
    warps_per_row: int | None = None
    rows_per_block: int | None = None
    threads: int | None = None
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in STORAGE:
            raise ValueError(f"storage dtype {self.dtype!r} has no kernel; "
                             f"expected one of {sorted(STORAGE)}")

    def itemsize(self) -> int:
        """Bytes per element of the storage type."""
        return STORAGE[self.dtype].itemsize


# -- per-kernel operand profiles ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class KindProfile:
    """Operand counts of one fused kernel, as the reference counts them.

    ``vec_in``/``vec_out`` count the ``(P, D)`` operands read and written
    (the reference's de_step reads its three donors as gathered tiles;
    the port gathers them inside the kernel, mostly from L2), ``row`` the
    ``(P,)`` per-row operands, ``bcast`` the ``(D,)`` broadcast rows (shift,
    gbest), and ``var_flops`` the non-evaluation arithmetic per element.
    """

    vec_in: int
    vec_out: int
    row: int = 2
    bcast: int = 1
    var_flops: int = 0


KIND_PROFILES: dict[str, KindProfile] = {
    "bench_eval": KindProfile(vec_in=1, vec_out=0, row=1, bcast=1),
    "de_step": KindProfile(vec_in=5, vec_out=1, row=4, bcast=1, var_flops=7),
    "pso_step": KindProfile(vec_in=5, vec_out=3, row=3, bcast=2, var_flops=11),
    "ga_step": KindProfile(vec_in=5, vec_out=1, row=5, bcast=1, var_flops=8),
    "eval_select": KindProfile(vec_in=2, vec_out=1, row=3, bcast=1,
                               var_flops=2),
}

# Rough per-element FLOP weights of the objective bodies (transcendental
# ops counted ~4 flops), as the reference weighs them.
EVAL_FLOPS: dict[str, int] = {
    "sphere": 2, "rastrigin": 12, "rosenbrock": 8, "shifted_rosenbrock": 9,
    "ackley": 14, "griewank": 16, "schwefel": 14, "levy": 22,
    "dropwave": 14, "michalewicz": 24,
}
_DEFAULT_EVAL_FLOPS = 12

# The geometry fields each kind takes, and those of them that fix the order
# in which a row's lanes are summed (order_fields: from D and the pointers).
GEOMETRY_FIELDS = {k: ("threads",) if k == "pso_step" else
                   ("vec", "warps_per_row", "rows_per_block") for k in KIND_PROFILES}
ORDER_FIELDS = {k: ("threads",) if k == "pso_step" else ("vec", "warps_per_row")
                for k in KIND_PROFILES}
# pso_step's block: the fewest threads of PSO_THREADS that walk a row in at
# most this many lanes a thread and pass (256 threads from D = 513 up).
PSO_LANES = 4

# -- the model's constants, for the H100 SXM at 700 W ---------------------------
# Fitted to tools/autotune_sweep.py's timings of every candidate of the five
# kernels at the row counts the main path launches them at (PERF.md). At
# D = 1000 the pick among the candidates that share the order fields is
# launch_geometry's for all four eval_row kernels at 1 to 8,000 rows.
ROUND_TRIP_S = 0.1e-6       # a wave's dependent round trip to memory
PSO_ROUND_S = 0.5e-6        # pso_step's: a lane's loads, then its arithmetic
WARP_COST_S = 10e-9         # launching and retiring one warp, per SM
CLOCK_HZ = 1.98e9           # the SMs' boost clock
CYCLES_PER_FLOP = 2         # a float32 operation, a lane
WRITE_CYCLES = 80           # a writing kernel's cycles a lane beyond its arithmetic
REG_BASE = 14               # registers a thread holds beside its slots
TWO_PASS_BYTES = 1.5        # a two-pass writer re-reads part of its row
MAX_WARPS_PER_SM = 64
MAX_BLOCKS_PER_SM = 32
REGISTERS_PER_SM = 65536
# Dependent round trips of one batch of a row: the row's loads; for de_step
# and ga_step then the donors or parents, once idx/u or the head arrive.
ROUNDS_PER_BATCH = {"bench_eval": 1, "de_step": 2, "ga_step": 2, "eval_select": 1}
# pso_step's block sizes: one block per row, a multiple of 32 threads.
PSO_THREADS = (32, 64, 128, 256)
# Candidates the measured sweep times, and its timing: a warm-up, then the
# best of REPS samples of SAMPLE_LAUNCHES back-to-back launches.
MEASURED_TOP = 4
REPS = 3
SAMPLE_LAUNCHES = 10
SPIN_CYCLES = 5_000_000     # about 2.5 ms of the card's clock ahead of a sample


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One scored candidate: its geometry, roofline terms and footprint, and
    the schedule the score adds on top (blocks, waves of blocks over the
    SMs, dependent round trips to memory a row makes, total time)."""

    config: KernelConfig
    roofline: Roofline
    footprint: memmodel.Footprint
    blocks: int
    waves: int
    rounds: int
    t_total: float

    @property
    def feasible(self) -> bool:
        return self.footprint.feasible


def _profile(kind: str) -> KindProfile:
    try:
        return KIND_PROFILES[kind]
    except KeyError:
        raise KeyError(f"unknown kernel kind {kind!r}; known: {sorted(KIND_PROFILES)}") from None


def _check_tag(tag: str) -> None:
    from repro_torch.kernels import bench_eval as be   # late: be imports this module
    be.check_tag(tag)


def predict(kind: str, P: int, D: int, geometry: KernelConfig, tag: str = "sphere", *,
            card: Card) -> Prediction:
    """The model's time for ``P`` rows of ``D`` lanes of ``kind`` at
    ``geometry`` (its geometry fields set; ``dtype`` the storage) on
    ``card``.

    ``t_total`` is the launch floor; plus the larger of the bytes (at the
    storage itemsize over 3.35 TB/s, half again for a writer that walks its
    row twice) and the float32 operations (over 67 TFLOP/s), over the share
    of SMs that hold a block; plus, for every wave of blocks the SMs hold at
    once (by warps, blocks and registers: ``REG_BASE`` and the block's slot
    registers a thread), the row's dependent round trips to memory
    (``pso_step``: one a lane and pass) and a thread's arithmetic on its
    lanes (``WRITE_CYCLES`` more a lane for the kernels that write rows);
    plus the warps launched, per SM."""
    from repro_torch.kernels import bench_eval as be
    prof = _profile(kind)
    isz = geometry.itemsize()
    eflops = EVAL_FLOPS.get(tag, _DEFAULT_EVAL_FLOPS) + prof.var_flops
    flops = float(P) * D * eflops
    hbm = float((prof.vec_in + prof.vec_out) * P * D * isz + prof.row * P * 4
                + prof.bcast * D * isz)
    if kind == "pso_step":
        T = geometry.threads
        fp = memmodel.block_footprint(kind, threads=T)
        blocks, warps_per_block = P, max(T // 32, 1)
        lanes = -(-D // T)                       # lanes a thread walks a pass
        rounds = 2 * lanes                       # two passes, a round trip a lane
        cycles = 2 * lanes * eflops * CYCLES_PER_FLOP
        two_pass, round_s = False, PSO_ROUND_S
    else:
        g = be.geometry(P, D, geometry.vec, geometry.warps_per_row, geometry.rows_per_block)
        fp = memmodel.block_footprint(kind, vec=g.vec, warps_per_row=g.warps_per_row,
                                      rows_per_block=g.rows_per_block,
                                      slots_per_thread=g.slots_per_thread)
        blocks, warps_per_block = g.blocks, g.warps_per_row * g.rows_per_block
        K = be.MAX_SLOTS if kind == "bench_eval" else g.slots_per_thread
        batches = -(-g.iters // K)
        two_pass = not g.staged and kind != "bench_eval"
        rounds = batches * ROUNDS_PER_BATCH[kind] + (batches if two_pass else 0)
        lane_cycles = eflops * CYCLES_PER_FLOP + (WRITE_CYCLES if kind != "bench_eval" else 0)
        cycles = g.iters * (4 if g.vec else 1) * lane_cycles
        round_s = ROUND_TRIP_S
    threads = 32 * max(warps_per_block, 1)
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM // max(warps_per_block, 1),
                        REGISTERS_PER_SM // (threads * (REG_BASE + fp.regs))))
    waves = max(1, -(-blocks // (card.sms * per_sm)))
    share = min(1.0, blocks / card.sms) if blocks else 1.0
    roof = rl.roofline(flops, hbm, fp.smem_bytes)
    t_mem = roof.t_memory * (TWO_PASS_BYTES if two_pass else 1.0)
    t = (rl.LAUNCH_FLOOR_S + max(roof.t_compute, t_mem) / share
         + waves * (rounds * round_s + cycles / CLOCK_HZ)
         + blocks * warps_per_block / card.sms * WARP_COST_S)
    return Prediction(config=geometry, roofline=roof, footprint=fp, blocks=blocks,
                      waves=waves, rounds=rounds, t_total=t)


def candidates(kind: str, P: int, D: int, *, aligned: bool = True,
               dtype: str = "float32") -> list[KernelConfig]:
    """The geometries the tuner scores for ``kind``: those whose block
    :func:`~repro_torch.parallel.memmodel.block_footprint` admits, with
    4-lane slots wherever ``D % 4 == 0`` and the pointers are ``aligned``
    to them (a vector load moves what four scalar ones do), scalar ones
    elsewhere. ``kernels.bench_eval.launch_geometry``'s pick is among them."""
    from repro_torch.kernels import bench_eval as be
    _profile(kind)
    if kind == "pso_step":
        return [KernelConfig(threads=t, dtype=dtype) for t in PSO_THREADS
                if memmodel.block_footprint(kind, threads=t).feasible]
    vec = aligned and D % 4 == 0
    out = []
    W = 1
    while W <= be.MAX_BLOCK_WARPS:
        R = 1
        while W * R <= be.MAX_BLOCK_WARPS:
            g = be.geometry(P, D, vec, W, R)
            fp = memmodel.block_footprint(kind, vec=vec, warps_per_row=W, rows_per_block=R,
                                          slots_per_thread=g.slots_per_thread)
            if fp.feasible:
                out.append(KernelConfig(vec=vec, warps_per_row=W, rows_per_block=R,
                                        dtype=dtype))
            R *= 2
        W *= 2
    return out


def _order(p: Prediction) -> tuple:
    """Rank by predicted time; on a tie the smaller block."""
    return (p.t_total, p.footprint.warps)


def ranked(kind: str, P: int, D: int, tag: str = "sphere", *, card: Card,
           aligned: bool = True, dtype: str = "float32") -> list[Prediction]:
    """Every candidate's prediction, best first."""
    return sorted((predict(kind, P, D, c, tag, card=card)
                   for c in candidates(kind, P, D, aligned=aligned, dtype=dtype)), key=_order)


# -- the per-shape-class config cache ----------------------------------------

_CACHE: dict[tuple, KernelConfig] = {}
_FN_CACHE: dict[tuple, KernelConfig] = {}
_RESOLVED: dict[tuple, KernelConfig] = {}
_STATS = {"hits": 0, "misses": 0, "measured": 0}


def cache_stats() -> dict[str, int]:
    """Tuner cache counters (hits, misses, measured sweeps)."""
    return dict(_STATS)


def clear_cache() -> None:
    """Drop every cached config and reset the counters."""
    _CACHE.clear()
    _FN_CACHE.clear()
    _RESOLVED.clear()
    for k in _STATS:
        _STATS[k] = 0


def _card(device, card: Card | None, measure: bool) -> Card:
    dev = None if device is None else torch.device(device)
    if measure and (dev is None or dev.type != "cuda"):
        raise ValueError("measure=True times the kernel on a CUDA device; "
                         f"there is nothing to time on {dev}")
    if card is not None:
        return card
    if dev is None or dev.type != "cuda":
        raise ValueError(f"the tuner chooses for a card: give a CUDA device or a Card, not {dev}")
    return rl.card_of(dev)


def choose(kind: str, P: int, D: int, tag: str = "sphere", *, dtype: str = "float32",
           device=None, card: Card | None = None, aligned: bool = True,
           measure: bool = False) -> KernelConfig:
    """The tuned :class:`KernelConfig` (geometry fields set) for one shape
    class of ``kind`` on ``device``'s card (or ``card``).

    Scores with :func:`predict` the candidates that share
    :func:`order_fields` (so only the rows a block holds are chosen); with
    ``measure``, times the model's four best of them on ``device``. The
    winner is cached per shape class, so later builds never re-score."""
    _profile(kind)
    _check_tag(tag)
    KernelConfig(dtype=dtype)            # checks the storage type
    c = _card(device, card, measure)
    key = (kind, P, D, tag, dtype, c.capability, c.sms, aligned, measure)
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        return hit
    _STATS["misses"] += 1
    order = order_fields(kind, D, aligned)
    preds = [p for p in ranked(kind, P, D, tag, card=c, aligned=aligned, dtype=dtype)
             if _fields(p.config, ORDER_FIELDS[kind]) == order]
    best = preds[0]
    if measure:
        best = measured_best(kind, P, D, tag, preds[:MEASURED_TOP], torch.device(device))[0]
        _STATS["measured"] += 1
    _CACHE[key] = best.config
    return best.config


def _fields(cfg: KernelConfig, names: tuple[str, ...]) -> tuple:
    return tuple(getattr(cfg, f) for f in names)


def order_fields(kind: str, D: int, aligned: bool = True) -> tuple:
    """The fields of ``kind``'s geometry that fix the order of a row's sum,
    as :data:`ORDER_FIELDS` names them, for rows of ``D`` lanes: 4-lane
    slots where ``D % 4 == 0`` and the pointers are ``aligned``, and
    ``kernels.bench_eval.row_warps``' warps a row; ``pso_step`` the fewest
    threads of :data:`PSO_THREADS` that walk the row in :data:`PSO_LANES`
    lanes each. They depend on ``D`` alone, never on the rows."""
    from repro_torch.kernels import bench_eval as be
    _profile(kind)
    if kind == "pso_step":
        return (next((t for t in PSO_THREADS if t * PSO_LANES >= D), PSO_THREADS[-1]),)
    vec = aligned and D % 4 == 0
    return (vec, be.row_warps(D, vec))


def choose_for(f, kind: str, P: int, D: int, *, dtype: str = "float32", device=None,
               card: Card | None = None, aligned: bool = True,
               measure: bool = False) -> KernelConfig:
    """:func:`choose` for objective ``f``, keyed by ``f.cache_token()`` (the
    identity every evaluator cache of the port keys on), so a recycled
    ``id()`` never serves a config tuned for another objective. KeyError
    for a function with no kernel."""
    from repro_torch.kernels import registry as kreg
    c = _card(device, card, measure)
    key = (kind, P, D, dtype, c.capability, c.sms, aligned, measure, *f.cache_token())
    hit = _FN_CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        return hit
    tag = kreg.get_spec(f.name).eval_tag
    cfg = choose(kind, P, D, tag, dtype=dtype, device=device, card=card, aligned=aligned,
                 measure=measure)
    _FN_CACHE[key] = cfg
    return cfg


def merge(cfg: KernelConfig | None, *, vec: bool | None = None,
          warps_per_row: int | None = None, rows_per_block: int | None = None,
          threads: int | None = None) -> KernelConfig:
    """Overlay explicit keywords onto a (possibly ``None``) threaded config:
    keywords win, then the config's fields; :func:`resolve` fills the rest."""
    base = cfg if cfg is not None else KernelConfig()
    over = {"vec": vec, "warps_per_row": warps_per_row, "rows_per_block": rows_per_block,
            "threads": threads}
    return dataclasses.replace(base, **{k: v for k, v in over.items() if v is not None})


def resolve(cfg: KernelConfig | None, kind: str, P: int, D: int, tag: str = "sphere", *,
            device=None, card: Card | None = None, aligned: bool = True,
            measure: bool = False) -> KernelConfig:
    """Fill a (possibly partial) config into a launchable one for ``kind``:
    its set geometry fields win, the ``None`` ones come from :func:`choose`.
    ValueError if the result does not fit a block (``block_footprint``) or
    asks for 4-lane slots the shape or the pointers do not allow.

    Every population kernel's wrapper resolves through here on the card, so
    a config threaded from ``ExecutorConfig.kernel`` reaches all five. A
    second call with the same arguments is a cache hit."""
    cfg = cfg if cfg is not None else KernelConfig()
    key = (cfg, kind, P, D, tag, device if card is None else card, aligned, measure)
    hit = _RESOLVED.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        return hit
    _profile(kind)
    fields = GEOMETRY_FIELDS[kind]
    set_ = {k: getattr(cfg, k) for k in fields if getattr(cfg, k) is not None}
    if len(set_) < len(fields):
        tuned = choose(kind, P, D, tag, dtype=cfg.dtype, device=device, card=card,
                       aligned=aligned, measure=measure)
        set_ = {k: set_.get(k, getattr(tuned, k)) for k in fields}
    out = KernelConfig(dtype=cfg.dtype, **set_)
    _check_fits(kind, D, out, aligned)
    _RESOLVED[key] = out
    return out


def _check_fits(kind: str, D: int, cfg: KernelConfig, aligned: bool) -> None:
    from repro_torch.kernels import bench_eval as be
    if kind == "pso_step":
        fp = memmodel.block_footprint(kind, threads=cfg.threads)
    else:
        if cfg.vec and (D % 4 or not aligned):
            raise ValueError(f"{kind}: 4-lane slots need D % 4 == 0 and pointers aligned "
                             f"to 4 elements (D = {D}, aligned = {aligned})")
        g = be.geometry(1, D, cfg.vec, cfg.warps_per_row, cfg.rows_per_block)
        fp = memmodel.block_footprint(kind, vec=cfg.vec, warps_per_row=cfg.warps_per_row,
                                      rows_per_block=cfg.rows_per_block,
                                      slots_per_thread=g.slots_per_thread)
    if not fp.feasible:
        raise ValueError(f"{kind}: {cfg} does not fit a block: {fp.reason}")


def library(kind: str, dtype: str) -> str:
    """The kernel library of ``kind`` for storage ``dtype``
    (``kernels/_build.SIGNATURES``): ``<kind>.cu`` or ``<kind>_bf16.cu``."""
    return kind if dtype == "float32" else f"{kind}_bf16"


# -- the measured sweep -------------------------------------------------------

def measured_best(kind: str, P: int, D: int, tag: str, preds: list[Prediction],
                  device: torch.device) -> tuple[Prediction, dict[KernelConfig, float]]:
    """The fastest of ``preds`` by CUDA-event timings of the real kernel on
    ``device`` (a warm-up, then the best of :data:`REPS` samples), and each
    candidate's seconds per launch. A candidate that fails to build or
    launch raises."""
    run = _runner(kind, P, D, tag, preds[0].config.dtype, device)
    times = {p.config: time_launch(lambda c=p.config: run(c), device) for p in preds}
    best = min(preds, key=lambda p: (times[p.config], _order(p)))
    return best, times


def time_launch(fn: Callable[[], None], device: torch.device) -> float:
    """Device seconds per call of ``fn`` on ``device``: one warm-up call,
    then the best of :data:`REPS` samples of :data:`SAMPLE_LAUNCHES` calls
    timed by CUDA events. A spin kernel holds the card while the host
    enqueues each sample, so the events time the kernels and not the host's
    launch rate (a wrapper call costs the host tens of microseconds)."""
    fn()
    stream = torch.cuda.current_stream(device)
    best = float("inf")
    for _ in range(REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.device(device):
            torch.cuda._sleep(SPIN_CYCLES)
        start.record(stream)
        for _ in range(SAMPLE_LAUNCHES):
            fn()
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / SAMPLE_LAUNCHES)
    return best


def _runner(kind: str, P: int, D: int, tag: str, dtype: str,
            device: torch.device) -> Callable[[KernelConfig], None]:
    """A closure launching one ``kind`` kernel on synthetic rows at a given
    geometry, through its wrapper."""
    from repro_torch.kernels import bench_eval as be   # late: the wrappers import this module
    from repro_torch.kernels import de_step as de
    from repro_torch.kernels import eval_select as es
    from repro_torch.kernels import ga_step as ga
    from repro_torch.kernels import pso_step as ps

    gen = torch.Generator(device=device).manual_seed(0)
    # The (P, D) operands already in the storage type: no cast is timed.
    pop = (torch.rand(P, D, generator=gen, device=device) * 2.0 - 1.0).to(STORAGE[dtype])
    fit = torch.ones(P, device=device)
    zeros = torch.zeros_like(pop)
    at = lambda geo: dataclasses.replace(geo, dtype=dtype)   # noqa: E731
    if kind == "bench_eval":
        return lambda geo: be.bench_eval(pop, tag, kernel_cfg=at(geo))
    u = torch.rand(P, D, generator=gen, device=device).to(STORAGE[dtype])
    if kind == "eval_select":
        # A trial of other rows, against a fitness of 1 that it rarely beats.
        return lambda geo: es.eval_select(pop, fit, u, fn=tag, kernel_cfg=at(geo))
    if kind == "de_step":
        i = torch.arange(P, device=device)
        idx = torch.stack([(i + 1) % P, (i + 2) % P, (i + 3) % P])
        jr = torch.zeros(P, dtype=torch.int64, device=device)
        return lambda geo: de.de_step(pop, fit, idx, u, jr, fn=tag, kernel_cfg=at(geo))
    if kind == "pso_step":
        return lambda geo: ps.pso_step(pop, zeros, pop, fit, zeros, zeros, pop[0], fn=tag,
                                       kernel_cfg=at(geo))
    cut = torch.ones(P, dtype=torch.int64, device=device)
    co = torch.zeros(P, device=device)
    return lambda geo: ga.ga_step(pop, pop, pop, fit, cut, co, zeros, zeros, fn=tag,
                                  kernel_cfg=at(geo))
