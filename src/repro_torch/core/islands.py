"""Island-model engine (counterpart of ``repro.core.islands``).

Islands are an explicit leading dimension of every state tensor: ``pop``
``(I, P, D)``, ``fit`` ``(I, P)``, ``best_arg`` ``(I, D)``, ``best_val``
``(I,)``, also when ``I == 1``. A policy's ``init`` and ``gen`` take a batch
of ``I`` keys and step every island at once, which is what ``vmap`` does in
the JAX engine. One *sync round* = ``sync_every`` generations + migration +
incumbent merge.

Two drivers, with the same trajectory for a fixed key:

  * device-resident (default): state and the per-round incumbent history
    stay on the device; nothing is read back until the run ends, and then
    the result crosses to the host in one transfer.
  * host-stepped (``round_callback``): after each round the incumbent is
    read on the host and handed to the callback (checkpointing, coupling).

The key discipline is the JAX engine's, draw for draw, so a seed gives the
same trajectory in both packages up to float32 rounding of the fitness.
This slice carries barrier islands with ring/none migration; starvation,
polish, portfolios, async islands, warm starts, meshes and the jobs axis
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import migration as mig
from repro_torch.core.api import OptimizeResult
from repro_torch.core.executor import ExecutorConfig, make_batch_evaluator
from repro_torch.functions.benchmarks import Function

Tensor = torch.Tensor
State = dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    """Engine topology + budget. Same fields as the JAX engine's config;
    the ones marked "later slice" must keep their defaults here."""

    n_islands: int = 1
    pop: int = 64                 # per-island population capacity
    dim: int = 10
    sync_every: int = 10          # generations between migration/incumbent rounds
    migration: str = "ring"       # ring | none (starvation: later slice)
    n_migrants: int = 2           # paper: at most 2 leave an island per round
    share_incumbent: bool = False # broadcast the global best at each round
    max_evals: int = 100_000      # Fig.4 budget unit: function evaluations
    island_axes: tuple[str, ...] = ("data",)  # mesh axes (later slice)
    pop_axes: tuple[str, ...] | None = None   # mesh axes (later slice)
    polish: str = "none"          # memetic polish (later slice)
    polish_every: int = 1
    polish_topk: int = 4
    polish_steps: int = 3
    portfolio: tuple[str, ...] = ()  # heterogeneous islands (later slice)
    sync_policy: str = "barrier"  # barrier (async: later slice)
    max_staleness: int = 0
    mailbox_slots: int = 4


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


AlgoMaker = Callable[..., MetaHeuristic]


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: later slice")


class IslandOptimizer:
    """popt4jlib OptimizerIntf over the island engine.

    ``device=None`` runs on CUDA and raises if no GPU is present; pass
    ``device="cpu"`` for the plain PyTorch path."""

    def __init__(
        self,
        algo_maker: AlgoMaker,
        cfg: IslandConfig,
        params: dict[str, Any] | None = None,
        exec_cfg: ExecutorConfig = ExecutorConfig(),
        round_callback: Callable[[int, Tensor, Tensor], None] | None = None,
        device: str | torch.device | None = None,
        mesh: Any = None,
        mesh_cfg: Any = None,
    ) -> None:
        if cfg.migration == "starvation":
            raise _later("starvation migration")
        if cfg.migration not in ("ring", "none"):
            raise ValueError(f"unknown migration policy {cfg.migration!r}")
        if cfg.polish != "none":
            raise _later("memetic polish (IslandConfig.polish)")
        if cfg.portfolio:
            raise _later("the algorithm portfolio (IslandConfig.portfolio)")
        if cfg.sync_policy == "async":
            raise _later("async islands (sync_policy='async')")
        if cfg.sync_policy != "barrier":
            raise ValueError(f"unknown sync_policy {cfg.sync_policy!r}")
        if mesh is not None or mesh_cfg is not None or cfg.pop_axes is not None:
            raise _later("mesh sharding")
        if algo_maker is None:
            raise ValueError("algo_maker is required")
        self.algo_maker = algo_maker
        self.cfg = cfg
        self.params = dict(params or {})
        self.exec_cfg = exec_cfg
        self.round_callback = round_callback
        self.device = resolve_device(device)

    # -- engine ------------------------------------------------------------

    def _evaluator(self, f: Function) -> Callable[[Tensor], Tensor]:
        return make_batch_evaluator(f, self.exec_cfg)

    def _build(self, f: Function) -> MetaHeuristic:
        cfg = self.cfg
        return self.algo_maker(f=f, evaluator=self._evaluator(f), pop=cfg.pop,
                               dim=cfg.dim, **self.params)

    def _eval_totals(self, algo: MetaHeuristic) -> tuple[int, int]:
        """(per-generation, init) evaluation totals across all islands."""
        return (algo.evals_per_gen * self.cfg.n_islands,
                algo.init_evals * self.cfg.n_islands)

    def _island_keys(self, key: Tensor) -> Tensor:
        """``(I, 2)`` per-island keys from one key: ``split(key, I)`` when
        islands are stacked, the key itself for a single island — the JAX
        engine's vmap-or-not rule."""
        if self.cfg.n_islands > 1:
            return prng.split(key, self.cfg.n_islands)
        return key[None]

    def _round_fn(self, algo: MetaHeuristic) -> Callable[[State, Tensor], State]:
        cfg = self.cfg
        step = algo.step_override if algo.step_override is not None else algo.gen
        stacked = cfg.n_islands > 1

        def round_fn(state: State, key: Tensor) -> State:
            gen_keys = prng.split(key, cfg.sync_every)
            for g in range(cfg.sync_every):
                state = step(state, self._island_keys(gen_keys[g]))
            if stacked and cfg.migration != "none":
                pop, fit = mig.migrate(cfg.migration, state["pop"], state["fit"],
                                       k=cfg.n_migrants)
                state = {**state, "pop": pop, "fit": fit}
            if stacked and cfg.share_incumbent:
                bv, ba = state["best_val"], state["best_arg"]
                gi = torch.argmin(bv)
                state = {**state, "best_val": bv[gi].expand(bv.shape).clone(),
                         "best_arg": ba[gi].expand(ba.shape).clone()}
            return state

        return round_fn

    def _init_state(self, algo: MetaHeuristic, ik: Tensor) -> State:
        """Fresh island-stacked state from init key ``ik``."""
        return algo.init(self._island_keys(ik))

    def _budget(self, per_gen_total: int, init_total: int) -> tuple[int, int]:
        """(n_rounds, per_round_evals) from the evaluation budget."""
        per_round = per_gen_total * self.cfg.sync_every
        budget = self.cfg.max_evals - init_total
        return max(1, budget // max(per_round, 1)), per_round

    def minimize(self, f: Function, key: Tensor,
                 warm: Any = None) -> OptimizeResult:
        """Run the full evaluation budget on ``f`` from PRNG ``key``."""
        if warm is not None:
            raise _later("warm-start immigrants")
        cfg = self.cfg
        algo = self._build(f)
        per_gen_total, init_total = self._eval_totals(algo)
        n_rounds, per_round = self._budget(per_gen_total, init_total)
        round_fn = self._round_fn(algo)

        ks = prng.split(key.to(self.device))
        key, ik = ks[0], ks[1]
        state = self._init_state(algo, ik)
        round_keys = _chain_split(key, n_rounds)

        if self.round_callback is None:
            history = torch.empty(n_rounds, dtype=torch.float32,
                                  device=self.device)
            for r in range(n_rounds):
                state = round_fn(state, round_keys[r])
                history[r] = torch.amin(state["best_val"])
            arg, val = _select_best(state)
            # The one device-to-host transfer of the run.
            host = torch.cat([arg, val[None], history]).cpu().numpy()
            arg, val, history = host[:cfg.dim], host[cfg.dim], host[cfg.dim + 1:]
        else:
            hist = []
            for r in range(n_rounds):
                state = round_fn(state, round_keys[r])
                hist.append(float(torch.amin(state["best_val"])))
                ba, bv = state["best_arg"], state["best_val"]
                if cfg.n_islands == 1:
                    ba, bv = ba[0], bv[0]
                self.round_callback(r, ba, bv)
            arg, val = _select_best(state)
            arg = arg.cpu().numpy()
            history = np.asarray(hist, dtype=np.float32)

        n_evals = init_total + n_rounds * per_round
        return OptimizeResult(arg=arg, value=float(val), n_evals=n_evals,
                              n_gens=n_rounds * cfg.sync_every, history=history)

    def minimize_many(self, *args: Any, **kwargs: Any):
        raise _later("the jobs axis (minimize_many)")


def _select_best(state: State) -> tuple[Tensor, Tensor]:
    """Global incumbent from island-stacked state (first island on ties)."""
    bv = state["best_val"]
    gi = torch.argmin(bv)
    return state["best_arg"][gi], bv[gi]


def _chain_split(key: Tensor, n: int) -> Tensor:
    """``(n, 2)`` round keys from the sequential ``key, rk = split(key)``
    chain — the stream the JAX engine's round loop draws."""
    rks = []
    for _ in range(n):
        ks = prng.split(key)
        key = ks[0]
        rks.append(ks[1])
    return torch.stack(rks) if rks else key.new_empty((0, 2))


def uniform_init(keys: Tensor, pop: int, dim: int, lo: float, hi: float) -> Tensor:
    """Uniform-random ``(I, pop, dim)`` populations in the box, one per key."""
    return prng.uniform(keys, (pop, dim), lo, hi)


def clip_box(x: Tensor, lo: float, hi: float) -> Tensor:
    """Project candidates back into the box domain (the paper's constraint)."""
    return torch.clamp(x, lo, hi)


def track_best(state: State, pop: Tensor, fit: Tensor) -> State:
    """Update each island's incumbent from its population: the first
    minimum of ``fit`` replaces the incumbent only if strictly better."""
    i = torch.argmin(fit, dim=-1)                                   # (I,)
    fi = torch.gather(fit, -1, i[:, None])[:, 0]
    pi = torch.gather(pop, 1, i[:, None, None].expand(-1, 1, pop.shape[-1]))[:, 0]
    better = fi < state["best_val"]
    return {
        **state,
        "pop": pop,
        "fit": fit,
        "best_val": torch.where(better, fi, state["best_val"]),
        "best_arg": torch.where(better[:, None], pi, state["best_arg"]),
    }
