"""Unified-state policy registry — heterogeneous algorithm portfolios for the
island engine (counterpart of ``repro.core.portfolio``).

The paper's Fig. 4 runs DGA, DDE, DPSO, DSA, DFA and DGABH side by side
because no single method dominates across functions. Every registered
policy declares its auxiliary state slots (PSO velocity, SA temperature, GA
ages, ...); the slots are padded into one common schema shared by all eight
algorithms, so one island-stacked state holds islands of different
policies.

Schema (the *unified state*; every leaf carries the leading row axis of
the island-stacked engine state, ``(J·I, ...)`` for a bucket of jobs):

    pop (P, D)  fit (P,)  best_arg (D,)  best_val ()      — common, every policy
    alive (P,) bool                                       — common liveness mask
                                                            (GA aging; all-True
                                                            for other policies)
    aux_vec (NV, P, D)  aux_ind (NP, P)  aux_scl (NS,)    — declared slots,
                                                            zero-padded to the
                                                            registry-wide maxima

The keys, shapes and slot order are the reference's, so a JAX portfolio
state crosses over leaf by leaf (``convert.state_from_numpy``).

The reference dispatches each island's generation through ``lax.switch``
under ``vmap``. Torch has none, so :meth:`Portfolio.step_stacked` groups the
rows by policy instead: for each distinct policy, in order of first
appearance, it gathers that policy's rows into contiguous copies, runs the
policy's generation (or its fused kernel) once on the whole group, and
scatters the result back — one kernel launch per group per generation. With
a single distinct policy the grouping is skipped and the policy is called
on the whole state directly, which keeps a homogeneous portfolio
bit-identical to the plain engine.

Migration carries position and fitness only. When an island adopts a
migrant, the destination policy's slots re-initialise per the slot's
``adopt`` rule (``zero`` | ``pos`` | ``fit`` | ``keep``): a PSO island zeroes
the adopted particle's velocity and restarts its personal best at the
migrant; a GA island resets the age and revives the slot. Per-island scalars
(SA's step, EA's sigma, FA's alpha) are never touched by adoption.

``algo_id`` values are frozen: they identify policies across processes and
in serialized requests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import bh, de, ea, fa, ga, mc, pso, sa
from repro_torch.core.islands import AlgoMaker, MetaHeuristic, State, _accepts_kernel_cfg
from repro_torch.functions.benchmarks import Function

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AuxSlot:
    """One piece of a policy's state beyond pop/fit/best.

    ``kind``: ``vec`` is per-individual ``(P, D)``, ``ind`` per-individual
    ``(P,)``, ``scl`` one value per island. ``adopt`` is the rule for an
    adopted row: ``zero`` | ``pos`` (the migrant's position) | ``fit`` (its
    fitness) | ``keep``; scalars are never re-initialised."""

    name: str
    kind: str          # "vec" | "ind" | "scl"
    adopt: str = "keep"


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Registry entry: a policy's stable wire identity (``algo_id``), its
    per-island factory, its aux slots, and whether its state owns the
    ``alive`` mask (GA aging)."""

    name: str
    algo_id: int
    maker: AlgoMaker
    slots: tuple[AuxSlot, ...] = ()
    needs_alive: bool = False


REGISTRY: dict[str, PolicySpec] = {}


def register(spec: PolicySpec) -> None:
    """Add a policy to the registry; name and algo_id must both be unused."""
    if any(s.kind not in ("vec", "ind", "scl") for s in spec.slots):
        raise ValueError(f"{spec.name}: unknown slot kind")
    if spec.name in REGISTRY:
        raise ValueError(f"policy {spec.name!r} already registered")
    if any(p.algo_id == spec.algo_id for p in REGISTRY.values()):
        raise ValueError(f"algo_id {spec.algo_id} already taken")
    REGISTRY[spec.name] = spec


# The eight policies of the paper's Fig. 4 portfolio. algo_ids are frozen.
register(PolicySpec("de", 0, de.make))
register(PolicySpec("ga", 1, ga.make, slots=(
    AuxSlot("age", "ind", adopt="zero"),        # migrants arrive newborn
    AuxSlot("age_limit", "ind", adopt="keep"),  # slot keeps its drawn limit
), needs_alive=True))
register(PolicySpec("pso", 2, pso.make, slots=(
    AuxSlot("vel", "vec", adopt="zero"),        # adopted particle starts at rest
    AuxSlot("pbest", "vec", adopt="pos"),       # personal best restarts at the
    AuxSlot("pbest_f", "ind", adopt="fit"),     # migrant's position/fitness
)))
register(PolicySpec("sa", 3, sa.make, slots=(AuxSlot("t", "scl"),)))
register(PolicySpec("ea", 4, ea.make, slots=(AuxSlot("sigma", "scl"),)))
register(PolicySpec("fa", 5, fa.make, slots=(AuxSlot("alpha", "scl"),)))
register(PolicySpec("bh", 6, bh.make))
register(PolicySpec("mc", 7, mc.make))


def schema() -> tuple[int, int, int]:
    """(NV, NP, NS) — aux slot counts of the unified schema: per-kind maxima
    over the whole registry, so every portfolio shares one state layout."""
    nv = np_ = ns = 0
    for spec in REGISTRY.values():
        nv = max(nv, sum(1 for s in spec.slots if s.kind == "vec"))
        np_ = max(np_, sum(1 for s in spec.slots if s.kind == "ind"))
        ns = max(ns, sum(1 for s in spec.slots if s.kind == "scl"))
    return nv, np_, ns


def expand(portfolio: tuple[str, ...], n_islands: int) -> tuple[str, ...]:
    """Per-island policy names from a portfolio spec: used as-is when its
    length equals ``n_islands``, cycled round-robin when shorter (so
    ``("de", "pso", "sa")`` over 6 islands interleaves the three policies —
    ring neighbours run different algorithms). A spec longer than the
    island count is rejected: dropping requested policies would run a
    different portfolio than the one submitted."""
    if not portfolio:
        raise ValueError("empty portfolio")
    unknown = [n for n in portfolio if n not in REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown portfolio policies {unknown}; registered: "
            f"{sorted(REGISTRY)}")
    if len(portfolio) > n_islands:
        raise ValueError(
            f"portfolio names {len(portfolio)} policies but there are only "
            f"{n_islands} islands — raise n_islands or drop policies")
    if len(portfolio) == n_islands:
        return tuple(portfolio)
    return tuple(portfolio[i % len(portfolio)] for i in range(n_islands))


class UnifiedPolicy:
    """One policy instance adapted to the unified state schema.

    Wraps the policy's native ``MetaHeuristic`` (island-batched dict state
    with its own keys) in pack/unpack shims so ``init``/``gen`` consume and
    produce the common schema. The wrapped arithmetic and key discipline
    are untouched, which is what makes a homogeneous portfolio
    bit-identical to the plain engine.
    """

    def __init__(self, spec: PolicySpec, algo: MetaHeuristic,
                 pop: int, dim: int) -> None:
        self.spec = spec
        self.algo = algo
        self.pop = pop
        self.dim = dim
        self._nv, self._np, self._ns = schema()

    # -- schema shims ------------------------------------------------------

    def _pack(self, d: State, base: State | None = None) -> State:
        """Native policy state -> unified state. Slots the policy does not
        declare are zero-padded on every pack (nothing ever writes an
        island's undeclared slots); ``base`` only supplies the common
        ``alive`` mask for policies that do not own one."""
        n, P, D = d["pop"].shape
        dev = d["pop"].device
        zv = torch.zeros((n, P, D), device=dev)
        zp = torch.zeros((n, P), device=dev)
        vecs = [d[s.name] for s in self.spec.slots if s.kind == "vec"]
        inds = [d[s.name].float() for s in self.spec.slots if s.kind == "ind"]
        scls = [d[s.name].float() for s in self.spec.slots if s.kind == "scl"]
        vecs += [zv] * (self._nv - len(vecs))
        inds += [zp] * (self._np - len(inds))
        scls += [torch.zeros((n,), device=dev)] * (self._ns - len(scls))
        if self.spec.needs_alive:
            alive = d["alive"]
        else:
            alive = (base["alive"] if base is not None
                     else torch.ones((n, P), dtype=torch.bool, device=dev))
        return {
            "pop": d["pop"], "fit": d["fit"], "alive": alive,
            "best_arg": d["best_arg"], "best_val": d["best_val"],
            "aux_vec": torch.stack(vecs, 1) if self._nv else d["pop"].new_zeros((n, 0, P, D)),
            "aux_ind": torch.stack(inds, 1) if self._np else d["fit"].new_zeros((n, 0, P)),
            "aux_scl": torch.stack(scls, 1) if self._ns else d["fit"].new_zeros((n, 0)),
        }

    def _unpack(self, u: State) -> State:
        """Unified state -> exactly the native keys the wrapped policy's
        ``gen`` expects. A slot is a strided view of ``aux_*`` across
        islands, and the fused kernels take contiguous inputs, so each is
        made contiguous (a no-op for one island)."""
        d = {"pop": u["pop"], "fit": u["fit"],
             "best_arg": u["best_arg"], "best_val": u["best_val"]}
        if self.spec.needs_alive:
            d["alive"] = u["alive"]
        vi = pi = si = 0
        for s in self.spec.slots:
            if s.kind == "vec":
                d[s.name] = u["aux_vec"][:, vi].contiguous()
                vi += 1
            elif s.kind == "ind":
                d[s.name] = u["aux_ind"][:, pi].contiguous()
                pi += 1
            else:
                d[s.name] = u["aux_scl"][:, si].contiguous()
                si += 1
        return d

    # -- unified interface -------------------------------------------------

    def init(self, keys: Tensor) -> State:
        """Unified-schema init of one island per key row (wraps the native
        init)."""
        return self._pack(self.algo.init(keys))

    def gen(self, u: State, keys: Tensor) -> State:
        """Unified-schema generation step of every row of ``u`` (the fused
        kernel when the policy has one)."""
        step = (self.algo.step_override if self.algo.step_override is not None
                else self.algo.gen)
        return self._pack(step(self._unpack(u), keys), base=u)

    def adopt(self, u: State, mask: Tensor) -> State:
        """Re-initialise aux slots of adopted migrants.

        ``mask (n, P)`` marks slots whose pop/fit changed in this round's
        migration. Every policy revives adopted slots (``alive |= mask``);
        declared slots apply their ``adopt`` rule; rows where ``mask`` is
        all False are returned unchanged."""
        out = {"aux_vec": u["aux_vec"], "aux_ind": u["aux_ind"]}
        index = {"vec": 0, "ind": 0}
        for s in self.spec.slots:
            if s.kind == "scl":
                continue
            i, key = index[s.kind], "aux_" + s.kind
            index[s.kind] += 1
            if s.adopt == "keep":
                continue
            if out[key] is u[key]:
                out[key] = out[key].clone()
            m = mask[..., None] if s.kind == "vec" else mask
            new = {"zero": 0.0, "pos": u["pop"], "fit": u["fit"]}[s.adopt]
            out[key][:, i] = torch.where(m, new, out[key][:, i])
        return {**u, **out, "alive": u["alive"] | mask}


def adopt_native(name: str, state: State, mask: Tensor) -> State:
    """Apply policy ``name``'s adopt rules to its island-stacked native
    state where ``mask`` ``(I, P)`` marks adopted rows — the plain engine's
    analogue of :meth:`UnifiedPolicy.adopt`, so homogeneous portfolios and
    the plain engine share one adoption semantic: revive ``alive`` if the
    state has it, then re-initialise each aux slot by its rule. An
    unregistered policy gets the revive alone."""
    out = dict(state)
    if "alive" in out:
        out["alive"] = out["alive"] | mask
    spec = REGISTRY.get(name)
    if spec is None:
        return out
    for s in spec.slots:
        if s.name not in out or s.kind == "scl" or s.adopt == "keep":
            continue
        m = mask[..., None] if s.kind == "vec" else mask
        new = {"zero": 0.0, "pos": out["pop"], "fit": out["fit"]}[s.adopt]
        out[s.name] = torch.where(m, new, out[s.name])
    return out


def has_adopt_state(name: str) -> bool:
    """Whether a policy carries per-individual state that migration adoption
    must touch — decides if the engine computes the adopted mask."""
    spec = REGISTRY.get(name)
    return spec is not None and (
        spec.needs_alive or any(s.kind in ("vec", "ind") for s in spec.slots))


class Portfolio:
    """A built per-island policy assignment: the engine-facing object.

    ``names`` holds one policy name per island; ``policies`` one
    :class:`UnifiedPolicy` per distinct policy, in order of first
    appearance; ``branch_of`` maps island -> index into ``policies``. The
    stacked entry points take the engine's job-major rows ``(J·I, ...)``:
    row ``r`` is island ``r % I``.

    With a single distinct policy every entry point calls that policy on
    the whole state; otherwise each policy's rows are gathered, stepped as
    one group and scattered back (:meth:`step_stacked`).

    ``block`` ``(start, n)`` (set by a sharded engine) says the rows are
    islands ``start .. start + n - 1`` of each job: the index tables are
    then built from that block of ``branch_of``, as the reference passes a
    shard its local block of the branch table.
    """

    def __init__(self, names: tuple[str, ...],
                 policies: list[UnifiedPolicy]) -> None:
        self.names = names
        self.policies = policies
        order = [p.spec.name for p in policies]
        self.branch_of = np.asarray([order.index(n) for n in names],
                                    dtype=np.int32)
        self.algo_ids = tuple(REGISTRY[n].algo_id for n in names)
        # Islands whose policy owns the alive mask (ga aging); the engine's
        # migration uses isfinite(fit) for the rest, as the plain engine's
        # alive=None default does.
        self.owns_alive = np.asarray(
            [REGISTRY[n].needs_alive for n in names])
        self.block: tuple[int, int] | None = None
        self._rows: dict[tuple, list[Tensor]] = {}

    @property
    def n_branches(self) -> int:
        """Distinct policies in the portfolio."""
        return len(self.policies)

    @property
    def per_gen_total(self) -> int:
        """Function evaluations one generation costs across all islands —
        the heterogeneous analogue of ``evals_per_gen * n_islands``."""
        return sum(self.policies[b].algo.evals_per_gen for b in self.branch_of)

    @property
    def init_total(self) -> int:
        """Function evaluations initialization costs across all islands."""
        return sum(self.policies[b].algo.init_evals for b in self.branch_of)

    def _layout(self, n_rows: int, device) -> tuple[list[Tensor], Tensor, Tensor]:
        """For ``n_rows`` job-major rows on ``device``: each policy's row
        indices (in the order of ``policies``; empty for a policy with no
        island in ``block``), each row's policy index, and whether each
        row's policy owns ``alive`` — cached per row count, device and
        block, so a generation copies no index table to the card."""
        ck = (n_rows, str(device), self.block)
        hit = self._rows.get(ck)
        if hit is None:
            isl = (slice(None) if self.block is None
                   else slice(self.block[0], self.block[0] + self.block[1]))
            reps = n_rows // len(self.branch_of[isl])
            branch = np.tile(self.branch_of[isl], reps)
            hit = ([torch.as_tensor(np.flatnonzero(branch == b), device=device)
                    for b in range(self.n_branches)],
                   torch.as_tensor(branch, device=device),
                   torch.as_tensor(np.tile(self.owns_alive[isl], reps), device=device))
            self._rows[ck] = hit
        return hit

    def _grouped(self, call, state: State | None, keys: Tensor) -> State:
        """``call(policy, rows' state, rows' keys)`` once per policy on its
        gathered rows, the results scattered into new row-stacked leaves.
        The groups partition the rows, so every row is written once."""
        n = keys.shape[0]
        out: State = {}
        for p, rows in zip(self.policies, self._layout(n, keys.device)[0]):
            if not len(rows):          # no island of this policy in the block
                continue
            sub = (None if state is None
                   else {k: v.index_select(0, rows) for k, v in state.items()})
            for k, v in call(p, sub, keys.index_select(0, rows)).items():
                if k not in out:
                    out[k] = v.new_empty((n, *v.shape[1:]))
                out[k].index_copy_(0, rows, v)
        return out

    def init_stacked(self, keys: Tensor) -> State:
        """Unified init of every row: one key row per island."""
        if self.n_branches == 1:
            return self.policies[0].init(keys)
        return self._grouped(lambda p, _, k: p.init(k), None, keys)

    def step_stacked(self, state: State, keys: Tensor) -> State:
        """One generation of every row: each policy's rows gathered into a
        contiguous group, stepped by one call of its ``gen`` (one fused
        kernel launch), and scattered back."""
        if self.n_branches == 1:
            return self.policies[0].gen(state, keys)
        return self._grouped(lambda p, s, k: p.gen(s, k), state, keys)

    def adopt_stacked(self, state: State, mask: Tensor) -> State:
        """Each island's policy-specific re-initialisation of adopted
        migrants (:meth:`UnifiedPolicy.adopt`), ``mask (J·I, P)``. Adoption
        is elementwise, so each policy applies its rules to its own rows
        through a restricted mask instead of a gather."""
        if self.n_branches == 1:
            return self.policies[0].adopt(state, mask)
        branch = self._layout(mask.shape[0], mask.device)[1]
        for b, p in enumerate(self.policies):
            state = p.adopt(state, mask & (branch == b)[:, None])
        return state

    def migration_alive(self, state: State) -> Tensor:
        """Per-row liveness for starvation's counts: the ``alive`` mask of
        islands whose policy owns one (ga), ``isfinite(fit)`` elsewhere —
        what the plain engine's ``alive=None`` default computes, so a
        homogeneous portfolio stays bit-identical to it when the executor
        has evicted candidates to +inf."""
        owns = self._layout(state["fit"].shape[0], state["fit"].device)[2]
        return torch.where(owns[:, None], state["alive"], torch.isfinite(state["fit"]))


def build_portfolio(
    names: tuple[str, ...],
    f: Function,
    evaluator: Callable[[Tensor], Tensor],
    pop: int,
    dim: int,
    params: dict[str, Any] | None = None,
    kernel_cfg: Any = None,
) -> Portfolio:
    """Materialize a per-island policy assignment into a :class:`Portfolio`.

    ``names`` is the expanded (length ``n_islands``) assignment from
    :func:`expand`. ``params`` maps policy name -> extra maker kwargs (a
    dict, or the pair-tuple form JSONL requests freeze it to); entries for
    policies outside the portfolio are rejected so typos fail loudly.
    ``kernel_cfg`` (a ``kernels.autotune.KernelConfig``, threaded from
    ``ExecutorConfig.kernel`` by the engine) is injected into every maker
    that declares the parameter; explicit per-policy params win. Unlike the
    reference, which writes it into the per-policy dicts it is given, the
    port leaves the caller's dicts as they are.
    """
    params = dict(params or {})
    distinct = list(dict.fromkeys(names))
    extra = set(params) - set(distinct)
    if extra:
        raise ValueError(
            f"params for policies not in the portfolio: {sorted(extra)} "
            f"(portfolio: {distinct})")
    policies = []
    for n in distinct:
        kw = dict(params.get(n, {}))   # OptRequest freezes dicts to pairs
        spec = REGISTRY[n]
        if (kernel_cfg is not None and "kernel_cfg" not in kw
                and _accepts_kernel_cfg(spec.maker)):
            kw["kernel_cfg"] = kernel_cfg
        algo = spec.maker(f=f, evaluator=evaluator, pop=pop, dim=dim, **kw)
        policies.append(UnifiedPolicy(spec, algo, pop, dim))
    return Portfolio(tuple(names), policies)
