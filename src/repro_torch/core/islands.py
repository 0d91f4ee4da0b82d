"""Island-model engine (counterpart of ``repro.core.islands``).

Islands are an explicit leading dimension of every state tensor: ``pop``
``(I, P, D)``, ``fit`` ``(I, P)``, ``best_arg`` ``(I, D)``, ``best_val``
``(I,)``, also when ``I == 1``. A policy's ``init`` and ``gen`` take a batch
of ``I`` keys and step every island at once, which is what ``vmap`` does in
the JAX engine. One *sync round* = ``sync_every`` generations + migration +
incumbent merge.

Jobs fold into the same dimension: a bucket of ``J`` jobs holds ``(J·I, P,
D)`` (job-major), so one ``init`` and one ``gen`` call step every island of
every job — one ``de_step``, ``pso_step`` or ``bench_eval`` launch per
bucket. Migration, incumbent sharing, selection and history act within a
job, on ``(J, I, ...)`` views. The round function always takes a batch of
job keys; ``minimize`` is the one-job case of it.

Three drivers, with the same trajectory for a fixed key:

  * device-resident (default): state and the per-round incumbent history
    stay on the device; nothing is read back until the run ends, and then
    the result crosses to the host in one transfer.
  * host-stepped (``round_callback``): after each round the incumbent is
    read on the host and handed to the callback (checkpointing, coupling).
  * jobs axis: ``minimize_many(f, keys (J, 2))`` runs J jobs of one
    configuration as one bucket, each bit-identical to a standalone
    ``minimize`` with its key; :class:`BucketStepper` is the same program
    advanced a round at a time by the service, one ``(J,)`` read per round.

The key discipline is the JAX engine's, draw for draw, so a seed gives the
same trajectory in both packages up to float32 rounding of the fitness.
Migration is ring, starvation or none, with the adoption of migrants into
policies with per-individual state (``core.portfolio.adopt_native``: ga
revives and zeroes the age, pso restarts velocity and personal best).
``minimize(warm=)`` adopts externally routed candidates (federation
migrants) into island 0's worst slots by the same rule before round 0.

``IslandConfig.portfolio`` makes the engine *heterogeneous*: each island
carries its own policy from ``core.portfolio``'s unified-state registry, and
each generation steps every policy's islands as one group (one fused kernel
launch per group), composing with migration (destination-policy slots
re-initialise on adoption), incumbent sharing and the polish cadence. A
homogeneous portfolio calls its policy directly and is bit-identical to the
plain ``algo_maker`` engine.

``sync_policy="async"`` drops the round barrier: islands advance on their
own cadence (an :class:`AsyncSchedule`) and exchange migrants through a
fixed-shape mailbox ring (``core.migration.mailbox_*``) whose leaves join
the state. Every island computes its ``sync_every`` generations every tick
from the global key table, and the schedule's step mask selects, once
after the generations, which islands keep them. Under the default all-ones
schedule with ``max_staleness=0`` the async engine is bit-identical to the
barrier engine.

``IslandConfig.polish`` turns any meta-heuristic into a *memetic hybrid*:
every ``polish_every`` rounds, each island's ``polish_topk`` best candidates
pass through a batched fixed-shape local descent
(``optim.descent.make_polish`` — the paper's ``LocalOptimizerIntf``), with
polish evaluations charged to ``max_evals``. Every island's candidates are
polished in one batch through the engine's own evaluator, so on the card
each probe batch is one ``bench_eval`` launch pair. The pass draws nothing,
so it leaves the key chain as it was.

A :class:`~repro_torch.core.mesh.MeshConfig` (``mesh_cfg``) makes the
engine *distributed*: SPMD over ``torch.distributed``, one process (rank) per
shard. Each rank runs this same engine on its own block of ``n_islands /
devices`` islands (``(J·I_l, ...)`` rows with jobs folded in: island block
``r`` of every job). Every rank derives the global key tables and schedule
masks and takes its rows (``mesh.local_rows``), so each island draws what
it draws unsharded; the ring migration and the async mailbox hop one
boundary batch to the next rank, starvation and incumbent sharing
all-gather, the history point is a minimum over ranks and the result an
all-gather of the islands' incumbents with the first-minimum rule. A fixed
seed gives the same result, bit for bit, at every rank count. Called from
one process the engine spawns its ranks (``mesh.spawn``) and returns rank
0's result; called inside a group of ``devices`` ranks (``torchrun``) it
runs in place. ``mesh`` (a built :class:`~repro_torch.core.mesh.Mesh`) with
``cfg.pop_axes`` and one island splits each evaluation's rows over the
ranks instead, and ``minimize_many`` over a ``mesh`` splits the jobs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import migration as mig
from repro_torch.core.api import OptimizeResult
from repro_torch.core.executor import ExecutorConfig, make_batch_evaluator
from repro_torch.functions.benchmarks import Function

Tensor = torch.Tensor
State = dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    """Engine topology + budget. Same fields as the JAX engine's config."""

    n_islands: int = 1
    pop: int = 64                 # per-island population capacity
    dim: int = 10
    sync_every: int = 10          # generations between migration/incumbent rounds
    migration: str = "ring"       # ring | starvation | none
    n_migrants: int = 2           # paper: at most 2 leave an island per round
    share_incumbent: bool = False # broadcast the global best at each round
    max_evals: int = 100_000      # Fig.4 budget unit: function evaluations
    island_axes: tuple[str, ...] = ("data",)  # parity: the port's meshes have one axis
    pop_axes: tuple[str, ...] | None = None   # split each evaluation over `mesh` (one island)
    polish: str = "none"          # none | asd | fcg | avd | bfgs
    polish_every: int = 1         # sync rounds between polish events
    polish_topk: int = 4          # per-island candidates polished per event
    polish_steps: int = 3         # descent iterations per polish event
    # Heterogeneous portfolio: one policy name per island (cycled
    # round-robin when shorter than n_islands). Non-empty selects portfolio
    # mode — pass algo_maker=None; per-policy params go in
    # IslandOptimizer(params={"de": {...}, ...}).
    portfolio: tuple[str, ...] = ()
    # Async staleness-bounded islands: "async" drops the round barrier;
    # islands advance on an AsyncSchedule and exchange migrants through a
    # mailbox ring (ring or none migration). With n_islands == 1 the mailbox
    # is a self-loop no-op and the engine runs the barrier path.
    sync_policy: str = "barrier"  # barrier | async
    max_staleness: int = 0        # adopt migrants at most this many rounds old
    mailbox_slots: int = 4        # per-island mailbox ring capacity


@dataclasses.dataclass(frozen=True)
class MetaHeuristic:
    """One meta-heuristic = island-batched init + generation step + eval
    accounting.

    ``init(keys (I, 2)) -> state`` and ``gen(state, keys (I, 2)) -> state``.
    ``step_override`` replaces ``gen`` in the round loop when set — the hook
    a fused whole-generation kernel (``de.make(fused=True)``) uses.
    """

    name: str
    init: Callable[[Tensor], State]
    gen: Callable[[State, Tensor], State]
    evals_per_gen: int
    init_evals: int
    step_override: Callable[[State, Tensor], State] | None = None


@dataclasses.dataclass(frozen=True)
class AsyncSchedule:
    """Record/replay hook for the async engine's mailbox (counterpart of the
    reference's ``AsyncSchedule``).

    ``step[t, i]`` — island ``i`` runs a sync round at tick ``t``;
    ``deliver[t, i]`` — the migrant batch island ``i`` posts at tick ``t``
    reaches its ring successor (False models a dropped message). Both
    default to all-ones — every island on every tick, every delivery on
    time — which is exactly the barrier cadence. A ``seed`` generates random
    Bernoulli masks instead, with numpy's ``RandomState`` as the reference
    draws them. Whatever arrays a run used are recorded in
    ``IslandOptimizer.recorded_schedule``; feeding that schedule back in
    replays the run bit-identically.
    """

    step: Any = None          # (n_rounds, n_islands) bool, or None
    deliver: Any = None       # (n_rounds, n_islands) bool, or None
    seed: int | None = None   # random masks when the arrays are absent
    step_prob: float = 0.75
    deliver_prob: float = 0.75

    def materialize(self, n_rounds: int, n_islands: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Concrete ``(step, deliver)`` bool masks of shape
        ``(n_rounds, n_islands)`` — explicit arrays are validated, missing
        ones are filled from ``seed`` (or all-ones without one)."""
        rng = np.random.RandomState(0 if self.seed is None else self.seed)

        def mask(a: Any, p: float, name: str) -> np.ndarray:
            if a is not None:
                a = np.asarray(a, dtype=bool)
                if a.shape != (n_rounds, n_islands):
                    raise ValueError(
                        f"AsyncSchedule.{name} has shape {a.shape}, engine "
                        f"needs {(n_rounds, n_islands)}")
                return a
            if self.seed is None:
                return np.ones((n_rounds, n_islands), dtype=bool)
            return rng.random_sample((n_rounds, n_islands)) < p

        return (mask(self.step, self.step_prob, "step"),
                mask(self.deliver, self.deliver_prob, "deliver"))

    @classmethod
    def from_cadences(cls, cadences, n_rounds: int) -> "AsyncSchedule":
        """Deterministic per-island cadence schedule: island ``i`` steps on
        ticks ``t`` with ``t % cadences[i] == 0`` (a straggler with cadence 4
        completes a round every 4th tick); every delivery fires."""
        c = np.asarray(cadences, dtype=int)
        if (c < 1).any():
            raise ValueError("cadences must be >= 1")
        step = (np.arange(n_rounds)[:, None] % c[None, :]) == 0
        return cls(step=step, deliver=np.ones_like(step))


AlgoMaker = Callable[..., MetaHeuristic]


def _accepts_kernel_cfg(maker: AlgoMaker) -> bool:
    """Whether a policy maker declares a ``kernel_cfg`` parameter (the hook
    the engine threads ``ExecutorConfig.kernel`` into fused kernels
    through). Makers without it are not injected into."""
    import inspect
    try:
        return "kernel_cfg" in inspect.signature(maker).parameters
    except (TypeError, ValueError):      # builtins and odd callables
        return False


class IslandOptimizer:
    """popt4jlib OptimizerIntf over the island engine.

    ``device=None`` runs on CUDA and raises if no GPU is present; pass
    ``device="cpu"`` for the plain PyTorch path. In portfolio mode
    (``cfg.portfolio``) ``algo_maker`` is ``None`` and ``params`` maps each
    policy name to its maker's keyword arguments. ``mesh_cfg`` shards the
    islands over ranks; ``mesh`` (with ``cfg.pop_axes`` and one island)
    shards each evaluation's rows, and the jobs of ``minimize_many``."""

    def __init__(
        self,
        algo_maker: AlgoMaker | None,
        cfg: IslandConfig,
        params: dict[str, Any] | None = None,
        exec_cfg: ExecutorConfig = ExecutorConfig(),
        round_callback: Callable[[int, Tensor, Tensor], None] | None = None,
        device: str | torch.device | None = None,
        mesh: Any = None,
        mesh_cfg: Any = None,
        schedule: AsyncSchedule | None = None,
    ) -> None:
        if cfg.migration not in mig.POLICIES:
            raise ValueError(f"unknown migration policy {cfg.migration!r}")
        if cfg.sync_policy not in ("barrier", "async"):
            raise ValueError(f"unknown sync_policy {cfg.sync_policy!r}")
        if cfg.sync_policy == "async" and cfg.migration == "starvation":
            raise ValueError(
                "async islands support ring|none migration only: starvation "
                "elects its host by a global argmin over every island's live "
                "count, which is inherently a barrier")
        if cfg.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if cfg.mailbox_slots < 1:
            raise ValueError("mailbox_slots must be >= 1")
        # With one island the mailbox is a self-loop no-op, so the engine
        # keeps the barrier path.
        self._async = cfg.sync_policy == "async" and cfg.n_islands > 1
        if schedule is not None and not self._async:
            raise ValueError(
                "an AsyncSchedule needs sync_policy='async' and n_islands > 1")
        if cfg.portfolio:
            if algo_maker is not None:
                raise ValueError(
                    "cfg.portfolio selects per-island policies; pass "
                    "algo_maker=None")
            if cfg.n_islands <= 1:
                raise ValueError(
                    "cfg.portfolio requires n_islands > 1 — each island "
                    "carries one policy")
        elif algo_maker is None:
            raise ValueError("algo_maker is required unless cfg.portfolio is set")
        self.algo_maker = algo_maker
        self.cfg = cfg
        self.params = dict(params or {})
        self.exec_cfg = exec_cfg
        self.round_callback = round_callback
        self.device = resolve_device(device)
        # Island sharding: a MeshConfig lays the island axis over ranks. The
        # placement is checked here, as the reference builds its mesh here.
        self.mesh = mesh
        self.mesh_cfg = mesh_cfg
        self._island_mesh: mesh_mod.Mesh | None = None
        if mesh_cfg is not None:
            if mesh is not None:
                raise ValueError(
                    "mesh (population sharding) and mesh_cfg (island "
                    "sharding) are mutually exclusive")
            if cfg.n_islands <= 1:
                raise ValueError("island sharding requires n_islands > 1")
            mesh_cfg.local_islands(cfg.n_islands)   # divisibility check
            self._island_mesh = mesh_cfg.build(self.device)
        # This rank's view of the island mesh while the engine runs in place
        # in a group (None: unsharded), and the row-splitting group of the
        # population-sharded evaluator.
        self._shard: mesh_mod.Group | None = None
        self._pop_group: mesh_mod.Group | None = None
        self.schedule = schedule
        # The schedule the last async run used (the record half of
        # record/replay); pass it back as ``schedule`` to replay the run.
        self.recorded_schedule: AsyncSchedule | None = None
        # High-water mark of adopted-migrant staleness in the last async run
        # (-1: nothing adopted), never above cfg.max_staleness.
        self.last_max_staleness: int | None = None
        self._steppers: dict[tuple, tuple[Callable, BucketStepper]] = {}

    # -- engine ------------------------------------------------------------

    def _evaluator(self, f: Function) -> Callable[[Tensor], Tensor]:
        """The engine's batch evaluator for ``f`` (memoized by the
        executor), its rows split over ``_pop_group`` when one is set."""
        return make_batch_evaluator(f, self.exec_cfg, self._pop_group)

    # -- sharding ----------------------------------------------------------

    @property
    def _n_local(self) -> int:
        """Islands this rank holds (all of them unsharded)."""
        return self.cfg.n_islands // (self._shard.size if self._shard else 1)

    def _local(self, t: Tensor, dim: int = 0) -> Tensor:
        """This rank's block of a global per-island table along ``dim``."""
        if self._shard is None:
            return t
        return mesh_mod.local_rows(t, self._shard.rank, self._n_local, dim)

    def _reduce(self, t: Tensor, op: str) -> Tensor:
        """``op`` over the ranks of the island mesh (identity unsharded)."""
        return mesh_mod.all_reduce(t, op, self._shard)

    def _best(self, state: State, n_jobs: int = 1) -> tuple[Tensor, Tensor]:
        """Each job's incumbent over every island of every rank: the
        islands' ``best_val``/``best_arg`` all-gathered in global island
        order (as they are, unsharded), then the first minimum: ``((J, D),
        (J,))``."""
        g = self._shard
        bv = mesh_mod.all_gather_rows(_by_job(state["best_val"], n_jobs), g, dim=1)
        ba = mesh_mod.all_gather_rows(_by_job(state["best_arg"], n_jobs), g, dim=1)
        gi = torch.argmin(bv, dim=1)            # the first island on ties
        jobs = torch.arange(n_jobs, device=gi.device)
        return ba[jobs, gi], bv[jobs, gi]

    def _stale(self, state: State) -> list[Tensor]:
        """``[max stale_seen over every island]`` as float32 ``(1,)`` for an
        async state, ``[]`` otherwise."""
        return [self._reduce(t, "max") for t in _stale(state)]

    def _spawned(self, method: str, f: Function, *args: Any) -> Any:
        """Run ``self.<method>(f, *args)`` on freshly spawned ranks of this
        optimizer's mesh and return rank 0's result; the run's record
        (``recorded_schedule``, ``last_max_staleness``) comes back with it.
        The kernel libraries are built here first, so the ranks only load
        them."""
        if self.round_callback is not None:
            raise ValueError("round_callback cannot run in spawned ranks; "
                             "run the mesh in place (torchrun)")
        m = self._island_mesh or self.mesh
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.library("bench_eval")          # builds every source
        recipe = dict(algo_maker=self.algo_maker, cfg=self.cfg, params=self.params,
                      exec_cfg=self.exec_cfg, device=self.device, mesh=self.mesh,
                      mesh_cfg=self.mesh_cfg, schedule=self.schedule)
        args = tuple(a.cpu() if isinstance(a, Tensor) else a for a in args)
        out, sched, stale = mesh_mod.spawn(m.devices, _rank_call, recipe, method, f, args,
                                           backend=m.backend)
        if sched is not None:
            self.recorded_schedule = sched
        self.last_max_staleness = stale
        return out

    def _build(self, f: Function, evaluator: Callable[[Tensor], Tensor] | None = None):
        """The run's policy object: a ``MetaHeuristic`` from ``algo_maker``,
        or a ``core.portfolio.Portfolio`` in portfolio mode.

        ``ExecutorConfig.kernel`` is injected as ``kernel_cfg`` into every
        maker that declares the parameter (explicit per-policy params win),
        so one threaded ``KernelConfig`` reaches the fused generation
        kernels as it reaches the cuda evaluation backend."""
        cfg = self.cfg
        evaluator = evaluator or self._evaluator(f)
        if cfg.portfolio:
            from repro_torch.core import portfolio as pf  # late: pf imports the algos
            port = pf.build_portfolio(
                pf.expand(cfg.portfolio, cfg.n_islands), f=f, evaluator=evaluator,
                pop=cfg.pop, dim=cfg.dim, params=self.params,
                kernel_cfg=self.exec_cfg.kernel)
            if self._shard is not None:
                port.block = (self._shard.rank * self._n_local, self._n_local)
            return port
        kw = dict(self.params)
        if "kernel_cfg" not in kw and _accepts_kernel_cfg(self.algo_maker):
            kw["kernel_cfg"] = self.exec_cfg.kernel
        return self.algo_maker(f=f, evaluator=evaluator, pop=cfg.pop, dim=cfg.dim, **kw)

    def _eval_totals(self, algo) -> tuple[int, int]:
        """(per-generation, init) evaluation totals across all islands —
        each island charged its own policy's count in portfolio mode."""
        if self.cfg.portfolio:
            return algo.per_gen_total, algo.init_total
        return (algo.evals_per_gen * self.cfg.n_islands,
                algo.init_evals * self.cfg.n_islands)

    def _island_keys(self, keys: Tensor) -> Tensor:
        """``(J·I, 2)`` per-island keys from one key per job ``(J, 2)``:
        ``split(key, I)`` when islands are stacked, the key itself for a
        single island — the JAX engine's vmap-or-not rule, job by job.
        Sharded, every rank splits the global table and keeps its islands'
        rows, ``(J·I_l, 2)``."""
        if self.cfg.n_islands > 1:
            return self._local(prng.split(keys, self.cfg.n_islands), 1).reshape(-1, 2)
        return keys

    def _gens(self, algo) -> Callable[[State, Tensor], State]:
        """``(state, round keys (J, 2)) -> state`` after ``sync_every``
        generations of every island of every job."""
        cfg = self.cfg
        if cfg.portfolio:
            step = algo.step_stacked
        else:
            step = algo.step_override if algo.step_override is not None else algo.gen

        def gens(state: State, keys: Tensor) -> State:
            gen_keys = prng.split(keys, cfg.sync_every)             # (J, S, 2)
            for g in range(cfg.sync_every):
                state = step(state, self._island_keys(gen_keys[:, g]))
            return state

        return gens

    def _adopter(self, algo) -> Callable[[State, Tensor], State] | None:
        """``(state, adopted (J·I, P)) -> state``: the destination policy's
        re-initialisation of adopted migrants, or None when the policy has
        no per-individual state to touch. ``adopt_native`` is looked up at
        each call."""
        from repro_torch.core import portfolio as pf  # late: pf imports the algos
        if self.cfg.portfolio:
            return algo.adopt_stacked
        if pf.has_adopt_state(algo.name):
            return lambda state, mask: pf.adopt_native(algo.name, state, mask)
        return None

    def _round_fn(self, algo) -> Callable[..., State]:
        """One sync round of every job in the bucket: ``(state (J·I, ...),
        round keys (J, 2)) -> state`` (a single ``(2,)`` key is one job).
        Migration and incumbent sharing see ``(J, I, ...)`` views, so
        nothing crosses from one job to another.

        In async mode the round also takes the tick's schedule rows,
        ``(state, keys, step_row (I,), deliver_row (I,))``, which every job
        shares; the state carries the mailbox leaves."""
        cfg = self.cfg
        gens = self._gens(algo)
        adopt = self._adopter(algo)
        stacked = cfg.n_islands > 1

        def take_migrants(state: State, pop: Tensor, fit: Tensor) -> State:
            # Slots whose contents changed hold adopted migrants.
            old_pop, old_fit = state["pop"], state["fit"]
            pop, fit = pop.reshape(old_pop.shape), fit.reshape(old_fit.shape)
            new = {**state, "pop": pop, "fit": fit}
            if adopt is None:
                return new
            return adopt(new, torch.any(pop != old_pop, dim=-1) | (fit != old_fit))

        def share(state: State, n_jobs: int) -> State:
            # Sharded, the islands' incumbents are all-gathered first.
            arg, val = self._best(state, n_jobs)
            bv, ba = state["best_val"], state["best_arg"]
            n_isl = bv.shape[0] // n_jobs
            return {**state,
                    "best_val": val[:, None].expand(n_jobs, n_isl).reshape(bv.shape),
                    "best_arg": arg[:, None].expand(n_jobs, n_isl, -1).reshape(ba.shape)}

        def round_fn(state: State, key: Tensor) -> State:
            keys = key.reshape(-1, 2)
            n_jobs = keys.shape[0]
            state = gens(state, keys)
            if stacked and cfg.migration != "none":
                alive = None
                if cfg.migration == "starvation":
                    alive = (algo.migration_alive(state) if cfg.portfolio
                             else state.get("alive"))
                pop, fit = mig.migrate(
                    cfg.migration, _by_job(state["pop"], n_jobs),
                    _by_job(state["fit"], n_jobs), k=cfg.n_migrants,
                    alive=None if alive is None else _by_job(alive, n_jobs),
                    group=self._shard)
                state = take_migrants(state, pop, fit)
            if stacked and cfg.share_incumbent:
                state = share(state, n_jobs)
            return state

        def async_round(state: State, key: Tensor, step_row: Tensor,
                        deliver_row: Tensor) -> State:
            keys = key.reshape(-1, 2)
            step_row, deliver_row = self._local(step_row), self._local(deliver_row)
            n_jobs = keys.shape[0]
            policy = {k: v for k, v in state.items() if k not in mig.MAILBOX_KEYS}
            box = {k: _by_job(state[k], n_jobs) for k in mig.MAILBOX_KEYS}
            # Every island computes its generations from the global key
            # table; the step mask selects, once and after them, which
            # islands keep the result. The rest keep their exact leaves.
            stepped = gens(policy, keys)
            rows = step_row.repeat(n_jobs)
            policy = {k: torch.where(rows.reshape(-1, *(1,) * (v.dim() - 1)), stepped[k], v)
                      for k, v in policy.items()}
            if cfg.migration == "ring":
                pop = _by_job(policy["pop"], n_jobs)
                fit = _by_job(policy["fit"], n_jobs)
                box = mig.mailbox_post(box, pop, fit, cfg.n_migrants,
                                       step_row & deliver_row, group=self._shard)
                pop, fit, box = mig.mailbox_adopt(box, pop, fit, cfg.max_staleness,
                                                  step_row)
                policy = take_migrants(policy, pop, fit)
            if cfg.share_incumbent:
                policy = share(policy, n_jobs)
            box["round_ctr"] = box["round_ctr"] + step_row.to(torch.int32)
            return {**policy, **{k: v.reshape(-1, *v.shape[2:]) for k, v in box.items()}}

        return async_round if self._async else round_fn

    def _init_state(self, algo, ik: Tensor) -> State:
        """Fresh job- and island-stacked state from init keys ``ik`` ``(J,
        2)``; in async mode with the mailbox leaves merged in, so
        checkpoints see one state."""
        cfg = self.cfg
        keys = self._island_keys(ik)
        state = algo.init_stacked(keys) if cfg.portfolio else algo.init(keys)
        if self._async:
            state = {**state, **mig.mailbox_init(
                keys.shape[0], cfg.mailbox_slots, cfg.n_migrants, cfg.dim,
                device=keys.device)}
        return state

    def _materialize_schedule(self, n_rounds: int) -> tuple[Tensor, Tensor]:
        """Concrete ``(step, deliver)`` masks ``(n_rounds, I)`` for an async
        run on the engine's device, recorded in ``recorded_schedule`` — the
        record half of record/replay."""
        sched = self.schedule if self.schedule is not None else AsyncSchedule()
        step, deliver = sched.materialize(n_rounds, self.cfg.n_islands)
        self.recorded_schedule = AsyncSchedule(step=step, deliver=deliver,
                                               seed=sched.seed)
        return (torch.as_tensor(step, device=self.device),
                torch.as_tensor(deliver, device=self.device))

    def _warm_fn(self, algo) -> Callable[[State, Tensor, Tensor], State]:
        """``(state (J·I, ...), warm (W, D), warm_fit (W,)) -> state``:
        immigration at init, the federation hop (``launch/federate.py``).
        Every job adopts the same candidates into island 0's worst slots by
        migration's worst-k rule, the destination policy re-initialises its
        per-individual state there, and island 0's incumbent is refreshed.
        Sharded, island 0 is rank 0's first island; the other ranks keep
        their state."""
        n_isl = self._n_local
        adopt = self._adopter(algo)

        def inject(state: State, w: Tensor, wf: Tensor) -> State:
            if self._shard is not None and self._shard.rank > 0:
                return state
            pop, fit = state["pop"], state["fit"]
            n_jobs = pop.shape[0] // n_isl
            jpop, jfit = _by_job(pop, n_jobs), _by_job(fit, n_jobs)
            old_pop, old_fit = jpop[:, 0], jfit[:, 0]
            pop0, fit0 = mig._replace_worst(old_pop, old_fit,
                                            w.expand(n_jobs, *w.shape),
                                            wf.expand(n_jobs, *wf.shape))
            pop = torch.cat([pop0[:, None], jpop[:, 1:]], 1).reshape(pop.shape)
            fit = torch.cat([fit0[:, None], jfit[:, 1:]], 1).reshape(fit.shape)
            state = {**state, "pop": pop, "fit": fit}
            if adopt is not None:
                changed = torch.any(pop0 != old_pop, dim=-1) | (fit0 != old_fit)
                rest = torch.zeros_like(changed)[:, None].expand(-1, n_isl - 1, -1)
                state = adopt(state, torch.cat([changed[:, None], rest], 1)
                              .reshape(fit.shape))
            new = incumbent(state, pop, fit)
            first = (torch.arange(fit.shape[0], device=fit.device) % n_isl) == 0
            return {**state,
                    "best_val": torch.where(first, new["best_val"], state["best_val"]),
                    "best_arg": torch.where(first[:, None], new["best_arg"],
                                            state["best_arg"])}

        return inject

    def _warm_rows(self, f: Function, warm: Any) -> tuple[Tensor, Tensor]:
        """Warm candidates ``(W, D)`` on the engine's device and their
        fitness by the engine's own evaluator."""
        w = torch.as_tensor(np.asarray(warm, np.float32)).to(self.device)
        if w.dim() != 2 or w.shape[1] != self.cfg.dim:
            raise ValueError(f"warm candidates must have shape (W, {self.cfg.dim}), "
                             f"got {tuple(w.shape)}")
        return w, self._evaluator(f)(w)

    def _polish(self, f: Function) -> tuple[Callable[[State], State] | None, int]:
        """(state -> state polish pass, evaluations per polished point), or
        ``(None, 0)`` when ``cfg.polish`` is off. The pass takes each
        island's ``polish_topk`` best candidates (lowest fitness, the lower
        index first on ties, as ``lax.top_k``) through one batched
        ``make_polish`` call over every island and writes improvements back
        into the population and the incumbent."""
        cfg = self.cfg
        if cfg.polish == "none":
            return None, 0
        from repro_torch.optim import descent  # late: optim.descent imports core.api

        pcfg = descent.PolishConfig(method=cfg.polish, steps=cfg.polish_steps)
        polish = descent.make_polish(f, self._evaluator(f), cfg.dim, pcfg)
        k = min(cfg.polish_topk, cfg.pop)

        def polish_pass(state: State) -> State:
            pop, fit = state["pop"], state["fit"]
            n_isl, _, dim = pop.shape
            idx = torch.argsort(fit, dim=-1, stable=True)[:, :k]        # (I, k)
            rows = idx[..., None].expand(n_isl, k, dim)
            xs, fs = torch.gather(pop, 1, rows), torch.gather(fit, 1, idx)
            xs2, fs2 = polish(xs.reshape(n_isl * k, dim), fs.reshape(-1))
            xs2, fs2 = xs2.reshape(n_isl, k, dim), fs2.reshape(n_isl, k)
            better = fs2 < fs                      # polish is monotone; guard anyway
            pop = pop.scatter(1, rows, torch.where(better[..., None], xs2, xs))
            fit = fit.scatter(1, idx, torch.where(better, fs2, fs))
            return track_best(state, pop, fit)

        return polish_pass, descent.polish_evals_per_point(cfg.dim, pcfg)

    def _budget(self, per_gen_total: int, init_total: int,
                polish_per_point: int = 0) -> tuple[int, int, int, int]:
        """(n_rounds, per_round_evals, n_polish, per_polish_evals) from the
        evaluation budget: the largest number of rounds whose generations
        and polish events (every ``polish_every`` rounds, ``polish_topk *
        polish_per_point`` evaluations per island) fit in ``max_evals``."""
        cfg = self.cfg
        per_round = per_gen_total * cfg.sync_every
        budget = cfg.max_evals - init_total
        if polish_per_point <= 0 or cfg.polish == "none":
            return max(1, budget // max(per_round, 1)), per_round, 0, 0
        per_polish = polish_per_point * min(cfg.polish_topk, cfg.pop) * cfg.n_islands
        every = max(1, cfg.polish_every)

        def cost(n: int) -> int:
            return n * per_round + (n // every) * per_polish

        lo, hi = 1, max(1, budget // max(per_round, 1))
        while lo < hi:                      # largest n_rounds with cost <= budget
            mid = (lo + hi + 1) // 2
            if cost(mid) <= budget:
                lo = mid
            else:
                hi = mid - 1
        return lo, per_round, lo // every, per_polish

    def minimize(self, f: Function, key: Tensor,
                 warm: Any = None) -> OptimizeResult:
        """Run the full evaluation budget on ``f`` from PRNG ``key``.

        ``warm`` (optional, ``(W, dim)``) are externally routed immigrants —
        federation migrants — adopted into the initial population before
        round 0 (see :meth:`_warm_fn`). An async run materialises its
        schedule first and records it in ``recorded_schedule``. Over a mesh
        the run goes to the ranks (spawned, or in place inside a group);
        every rank returns the same result."""
        cfg = self.cfg
        if self._island_mesh is not None:
            if self.round_callback is not None:
                raise ValueError(
                    "round_callback requires the unsharded engine: the "
                    "host-stepped loop does not run over a mesh of ranks")
            self._shard = self._island_mesh.local_group()
            if self._shard is None:
                return self._spawned("minimize", f, key, warm)
        elif self.mesh is not None and cfg.n_islands == 1 and cfg.pop_axes is not None:
            self._pop_group = self.mesh.local_group()
            if self._pop_group is None:
                return self._spawned("minimize", f, key, warm)
        algo = self._build(f)
        polish_pass, pp = self._polish(f)
        per_gen_total, init_total = self._eval_totals(algo)
        n_rounds, per_round, n_polish, per_polish = self._budget(
            per_gen_total, init_total, pp)
        round_fn = self._round_fn(algo)
        masks = self._materialize_schedule(n_rounds) if self._async else ()
        every = max(1, cfg.polish_every)

        def round_and_polish(state: State, r: int) -> State:
            state = round_fn(state, round_keys[r], *(m[r] for m in masks))
            if polish_pass is not None and (r + 1) % every == 0:
                state = polish_pass(state)
            return state

        ks = prng.split(key.to(self.device))
        key, ik = ks[0], ks[1]
        state = self._init_state(algo, ik[None])
        if warm is not None and len(warm):
            state = self._warm_fn(algo)(state, *self._warm_rows(f, warm))
        round_keys = _chain_split(key, n_rounds)

        if self.round_callback is None:
            history = torch.empty(n_rounds, dtype=torch.float32,
                                  device=self.device)
            for r in range(n_rounds):
                state = round_and_polish(state, r)
                history[r] = torch.amin(state["best_val"])
            # Sharded: the minimum over ranks of each round's point, exact.
            history = self._reduce(history, "min")
            arg, val = self._best(state)
            # The one device-to-host transfer of the run.
            host = torch.cat([arg[0], val, history, *self._stale(state)]).cpu().numpy()
            arg, val = host[:cfg.dim], host[cfg.dim]
            history = host[cfg.dim + 1:cfg.dim + 1 + n_rounds]
        else:
            hist = []
            for r in range(n_rounds):
                state = round_and_polish(state, r)
                hist.append(float(torch.amin(state["best_val"])))
                ba, bv = state["best_arg"], state["best_val"]
                if cfg.n_islands == 1:
                    ba, bv = ba[0], bv[0]
                self.round_callback(r, ba, bv)
            arg, val = self._best(state)
            arg = arg[0].cpu().numpy()
            history = np.asarray(hist, dtype=np.float32)
            host = torch.cat([val, *self._stale(state)]).cpu().numpy()
        if self._async:
            self.last_max_staleness = int(host[-1])

        n_evals = init_total + n_rounds * per_round + n_polish * per_polish
        return OptimizeResult(arg=arg, value=float(val), n_evals=n_evals,
                              n_gens=n_rounds * cfg.sync_every, history=history)

    # -- jobs axis ---------------------------------------------------------

    def _stepper(self, f: Function) -> "BucketStepper":
        """The cached :class:`BucketStepper` for objective ``f``, keyed by
        ``Function.cache_token()``."""
        ck = f.cache_token()
        hit = self._steppers.get(ck)
        if hit is not None and hit[0] is f.fn:
            return hit[1]
        stepper = BucketStepper(self, f)
        self._steppers[ck] = (f.fn, stepper)
        return stepper

    def bucket_stepper(self, f: Function) -> "BucketStepper":
        """The cached host-stepped jobs-axis runner for objective ``f`` (see
        :class:`BucketStepper`). As in the reference, portfolio and sharded
        buckets are refused here: the scheduler runs them through
        ``minimize_many``, without streaming or mid-run checkpoints."""
        if self._island_mesh is not None or self.mesh is not None:
            raise ValueError(
                "bucket_stepper requires the unsharded engine: the "
                "host-stepped loop does not run over a mesh of ranks")
        if self.cfg.portfolio:
            raise ValueError(
                "bucket_stepper does not support portfolio islands: the "
                "service runs portfolio buckets resident through "
                "minimize_many, as the reference does")
        return self._stepper(f)

    def minimize_many(self, f: Function, keys: Tensor) -> list[OptimizeResult]:
        """Run one job per row of ``keys (J, 2)`` as one bucket.

        The scheduler's bucket primitive: all jobs share this optimizer's
        configuration and differ by key only. The bucket's state stays on
        the device and the results cross to the host in one transfer; each
        job's result is bit-identical to ``minimize`` with its key. An async
        bucket replays one materialised schedule for every job.

        With ``mesh_cfg`` every rank holds island block ``r`` of every job;
        with a ``mesh`` the jobs are padded to a multiple of the ranks, each
        rank runs its share unsharded and the results are gathered in job
        order."""
        if self.round_callback is not None:
            raise ValueError("minimize_many is device-resident only; "
                             "round_callback requires per-job minimize calls")
        if self._island_mesh is not None:
            self._shard = self._island_mesh.local_group()
            if self._shard is None:
                return self._spawned("minimize_many", f, keys)
        elif self.mesh is not None:
            group = self.mesh.local_group()
            if group is None:
                return self._spawned("minimize_many", f, keys)
            self._pop_group = None       # each rank evaluates its own jobs' rows
            return self._many_over_jobs(f, keys, group)
        return self._many(f, keys)

    def _many_over_jobs(self, f: Function, keys: Tensor,
                        group: mesh_mod.Group) -> list[OptimizeResult]:
        """``minimize_many`` with the jobs split over ``group``: the keys
        padded with copies of the first to a multiple of the ranks, this
        rank's share run unsharded, every job's ``(arg, value, history)``
        all-gathered in job order (and the staleness high-water mark
        reduced)."""
        keys = torch.as_tensor(keys)
        n_jobs, dim = keys.shape[0], self.cfg.dim
        pad = (-n_jobs) % group.size
        if pad:
            keys = torch.cat([keys, keys[:1].expand(pad, 2)])
        mine = self._many(f, mesh_mod.local_rows(keys, group.rank, keys.shape[0] // group.size))
        stale = -1.0 if self.last_max_staleness is None else float(self.last_max_staleness)
        # Gathered on this rank's device, as every other collective here: a
        # group built on nccl refuses host tensors (gloo stages them itself).
        rows = torch.as_tensor(np.stack([np.concatenate([r.arg, [r.value], r.history, [stale]])
                                         for r in mine]).astype(np.float32), device=self.device)
        rows = mesh_mod.all_gather_rows(rows, group)[:n_jobs].cpu().numpy()
        if self._async:
            self.last_max_staleness = int(rows[:, -1].max())
        return [OptimizeResult(arg=row[:dim], value=float(row[dim]),
                               n_evals=mine[0].n_evals, n_gens=mine[0].n_gens,
                               history=row[dim + 1:-1])
                for row in rows]

    def _many(self, f: Function, keys: Tensor) -> list[OptimizeResult]:
        """The jobs-axis run on this process (this rank's islands when
        sharded)."""
        st = self._stepper(f)
        state, round_keys = st.init(keys)
        masks = self._materialize_schedule(st.n_rounds) if self._async else None
        n_jobs, dim = round_keys.shape[0], self.cfg.dim
        history = torch.empty((st.n_rounds, n_jobs), dtype=torch.float32,
                              device=self.device)
        for r in range(st.n_rounds):
            state, history[r] = st.step(state, round_keys, r, masks)
        history = self._reduce(history, "min")
        args, vals = st.best(state)
        stale = [s.expand(n_jobs)[:, None] for s in self._stale(state)]
        host = torch.cat([args, vals[:, None], history.T, *stale], 1).cpu().numpy()
        if self._async:
            self.last_max_staleness = int(host[0, -1])
        return [OptimizeResult(arg=row[:dim], value=float(row[dim]),
                               n_evals=st.evals_done(st.n_rounds),
                               n_gens=st.n_rounds * self.cfg.sync_every,
                               history=row[dim + 1:dim + 1 + st.n_rounds])
                for row in host]


class BucketStepper:
    """Host-stepped jobs-axis runner — the program ``minimize_many`` runs,
    advanced one sync round at a time by its caller (counterpart of the
    reference's ``BucketStepper``).

    Control returns to the host at every round boundary, so the service can
    stream per-round progress, honour cooperative cancellation and
    checkpoint the bucket's state, while the trajectory stays
    bit-identical to ``minimize_many`` (the same init, key streams and
    round/polish/history order). State is job-major ``(J·I, ...)``; each
    ``step`` returns the jobs' incumbent values ``(J,)`` on the device. An
    async bucket runs the all-ones schedule unless ``step`` is given the
    masks (``minimize_many`` passes its materialised schedule)."""

    def __init__(self, opt: IslandOptimizer, f: Function) -> None:
        cfg = opt.cfg
        self.cfg = cfg
        self.device = opt.device
        self._opt, self._f = opt, f
        self._algo = algo = opt._build(f)
        self._polish_pass, pp = opt._polish(f)
        per_gen_total, init_total = opt._eval_totals(algo)
        self.n_rounds, self.per_round, _, self.per_polish = opt._budget(
            per_gen_total, init_total, pp)
        self.init_evals = init_total
        self.every = max(1, cfg.polish_every)
        self.has_polish = self._polish_pass is not None
        self._round = opt._round_fn(algo)
        self._async = opt._async
        self._ones = torch.ones(cfg.n_islands, dtype=torch.bool, device=self.device)
        self._warm = opt._warm_fn(algo)
        self._warm_rows = lambda w: opt._warm_rows(f, w)

    def _split(self, keys: Tensor) -> tuple[Tensor, Tensor]:
        ks = prng.split(torch.as_tensor(keys).to(self.device))      # (J, 2, 2)
        return ks[:, 0], ks[:, 1]

    def init(self, keys: Tensor) -> tuple[State, Tensor]:
        """``keys (J, 2) -> (state, round keys (J, n_rounds, 2))``: each
        job's ``split``/init/``_chain_split`` exactly as ``minimize``."""
        key, ik = self._split(keys)
        return self._opt._init_state(self._algo, ik), _chain_split(key, self.n_rounds)

    def inject(self, state: State, warm: Any) -> State:
        """Adopt warm-start immigrants (``OptRequest.warm``) into every
        job's fresh state; the candidates are evaluated once, by the
        bucket's own evaluator."""
        return self._warm(state, *self._warm_rows(warm))

    def round_keys(self, keys: Tensor) -> Tensor:
        """The ``(J, n_rounds, 2)`` round keys without running init — how a
        resumed run rebuilds the key stream it was stopped on."""
        return _chain_split(self._split(keys)[0], self.n_rounds)

    def state_shape(self, keys: Tensor) -> State:
        """The bucket's state as tensors on the ``meta`` device (shapes and
        dtypes, no data): the template a checkpoint restore checks against.
        Init runs there with a stand-in evaluator, so nothing is launched."""
        algo = self._opt._build(self._f, lambda x: x.new_zeros(x.shape[:-1]))
        ks = prng.split(torch.as_tensor(keys).to("meta"))
        return self._opt._init_state(algo, ks[:, 1])

    def step(self, state: State, round_keys: Tensor, r: int,
             masks: tuple[Tensor, Tensor] | None = None) -> tuple[State, Tensor]:
        """Advance round ``r``: ``sync_every`` generations, migration,
        incumbent merge, and a polish on its cadence; returns the state and
        each job's incumbent value ``(J,)``. An async bucket takes row ``r``
        of ``masks`` (``(step, deliver)``, each ``(n_rounds, I)``), all ones
        when not given."""
        if not self._async:
            state = self._round(state, round_keys[:, r])
        elif masks is None:
            state = self._round(state, round_keys[:, r], self._ones, self._ones)
        else:
            state = self._round(state, round_keys[:, r], masks[0][r], masks[1][r])
        if self.has_polish and (r + 1) % self.every == 0:
            state = self._polish_pass(state)
        n_jobs = round_keys.shape[0]
        return state, torch.amin(state["best_val"].reshape(n_jobs, -1), dim=1)

    def best(self, state: State) -> tuple[Tensor, Tensor]:
        """Each job's incumbent ``(args (J, D), vals (J,))``."""
        return self._opt._best(state, state["best_val"].shape[0] // self._opt._n_local)

    def evals_done(self, rounds: int) -> int:
        """Evaluations one job has used after ``rounds`` rounds, by the rule
        ``minimize`` charges."""
        n_polish = rounds // self.every if self.has_polish else 0
        return self.init_evals + rounds * self.per_round + n_polish * self.per_polish


def _rank_call(recipe: dict, method: str, f: Function, args: tuple):
    """A spawned rank: rebuild the optimizer (on this rank's device), run
    ``method`` in place over the group, and return ``(result, recorded
    schedule, staleness high-water mark)``."""
    group = (recipe["mesh_cfg"].build(recipe["device"]) if recipe["mesh_cfg"] is not None
             else recipe["mesh"]).local_group()
    recipe = {**recipe, "device": mesh_mod.rank_device(recipe["device"], group)}
    opt = IslandOptimizer(**recipe)
    out = getattr(opt, method)(f, *args)
    return out, opt.recorded_schedule, opt.last_max_staleness


def _by_job(t: Tensor, n_jobs: int) -> Tensor:
    """``(J·I, ...)`` as ``(J, I, ...)``."""
    return t.reshape(n_jobs, -1, *t.shape[1:])


def _stale(state: State) -> list[Tensor]:
    """``[max stale_seen]`` as float32 ``(1,)`` for an async state, ``[]``
    otherwise — appended to a run's one device-to-host transfer."""
    if "stale_seen" not in state:
        return []
    return [state["stale_seen"].amax().float()[None]]


def _chain_split(key: Tensor, n: int) -> Tensor:
    """``(..., n, 2)`` round keys from the sequential ``key, rk =
    split(key)`` chain of each key ``(..., 2)`` — the stream the JAX
    engine's round loop draws."""
    rks = []
    for _ in range(n):
        ks = prng.split(key)
        key = ks[..., 0, :]
        rks.append(ks[..., 1, :])
    return torch.stack(rks, dim=-2) if rks else key.new_empty((*key.shape[:-1], 0, 2))


def uniform_init(keys: Tensor, pop: int, dim: int, lo: float, hi: float) -> Tensor:
    """Uniform-random ``(I, pop, dim)`` populations in the box, one per key."""
    return prng.uniform(keys, (pop, dim), lo, hi)


def clip_box(x: Tensor, lo: float, hi: float) -> Tensor:
    """Project candidates back into the box domain (the paper's constraint)."""
    return torch.clamp(x, lo, hi)


def evaluate_rows(evaluator: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    """Fitness ``(I, N)`` of island-stacked rows ``(I, N, D)``: one call of
    the row-local evaluator over every island's rows at once."""
    return evaluator(x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1])


def incumbent(state: State, pop: Tensor, fit: Tensor) -> State:
    """Each island's ``best_val``/``best_arg`` after a generation: the first
    minimum of ``fit`` replaces the incumbent only if strictly better."""
    i = torch.argmin(fit, dim=-1)                                   # (I,)
    fi = torch.gather(fit, -1, i[:, None])[:, 0]
    pi = torch.gather(pop, 1, i[:, None, None].expand(-1, 1, pop.shape[-1]))[:, 0]
    better = fi < state["best_val"]
    return {"best_val": torch.where(better, fi, state["best_val"]),
            "best_arg": torch.where(better[:, None], pi, state["best_arg"])}


def track_best(state: State, pop: Tensor, fit: Tensor) -> State:
    """The state with a new population and its incumbent updated from it."""
    return {**state, "pop": pop, "fit": fit, **incumbent(state, pop, fit)}


def init_state(pop: Tensor, fit: Tensor) -> State:
    """A fresh island-stacked state: the population, its fitness, and each
    island's first minimum as the incumbent."""
    i = torch.argmin(fit, dim=-1)
    isl = torch.arange(pop.shape[0], device=pop.device)
    return {"pop": pop, "fit": fit, "best_arg": pop[isl, i],
            "best_val": fit[isl, i]}
