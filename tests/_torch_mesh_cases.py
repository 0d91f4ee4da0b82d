"""Engine configurations the mesh tests run sharded and unsharded.

Imported by ``test_torch_mesh_engine.py`` and by the ranks it spawns, so it
imports torch and the port only (a rank never loads JAX). Each case is a
name and the keyword arguments of one run; :func:`run` builds the engine
(over a mesh of ``devices`` ranks, or unsharded for ``devices=None``) and
returns what the run gives back.
"""
import dataclasses

import numpy as np

from repro_torch import core as tcore
from repro_torch import prng
from repro_torch.core.mesh import MeshConfig
from repro_torch.functions import get

BASE = dict(n_islands=4, pop=16, dim=6, sync_every=5, migration="ring",
            max_evals=2000)
STARVING = {"n_offspring": 1, "age_mean": 2.0, "age_sd": 6.0}
MIXED = {"de": {}, "pso": {"fused": True}, "sa": {}, "ga": {}}
# The straggler: island 0 completes a round every 4th tick.
STRAGGLER_ROUNDS = (2000 - 4 * 16) // (4 * 16 * 5)
STRAGGLER = tcore.AsyncSchedule.from_cadences([4, 1, 1, 1], STRAGGLER_ROUNDS)

CASES = {
    "de": dict(algo="de", fn="rastrigin"),
    "ga_starvation": dict(algo="ga", fn="rastrigin", params=STARVING,
                          cfg=dict(migration="starvation", sync_every=2, max_evals=500)),
    "pso": dict(algo="pso", fn="rastrigin", params={"fused": True}),
    "share_polish": dict(algo="de", fn="rosenbrock",
                         cfg=dict(share_incumbent=True, max_evals=3000, polish="asd",
                                  polish_every=2, polish_topk=2, polish_steps=2)),
    "many": dict(algo="de", fn="sphere", seeds=(0, 3, 11)),
    "homogeneous": dict(algo=None, fn="rastrigin", params={"de": {}},
                        cfg=dict(portfolio=("de",))),
    "mixed": dict(algo=None, fn="rastrigin", params=MIXED,
                  cfg=dict(portfolio=("de", "pso", "sa", "ga"), share_incumbent=True)),
    "mixed_many": dict(algo=None, fn="rastrigin", params=MIXED, seeds=(1, 2),
                       cfg=dict(portfolio=("de", "pso", "sa", "ga"))),
    "async0": dict(algo="de", fn="rastrigin", cfg=dict(sync_policy="async")),
    "straggler": dict(algo="de", fn="rastrigin", schedule=STRAGGLER,
                      cfg=dict(sync_policy="async", max_staleness=4)),
    "async_many": dict(algo="de", fn="rastrigin", seeds=(0, 5),
                       schedule=tcore.AsyncSchedule(seed=4),
                       cfg=dict(sync_policy="async", max_staleness=2)),
    "warm": dict(algo="pso", fn="sphere", warm=np.full((2, 6), 0.25, np.float32)),
}


def optimizer(case: dict, devices: int | None, device: str = "cpu"):
    cfg = tcore.IslandConfig(**{**BASE, **case.get("cfg", {})})
    algo = case["algo"]
    return tcore.IslandOptimizer(
        None if algo is None else tcore.ALGORITHMS[algo], cfg,
        params=case.get("params"), device=device, schedule=case.get("schedule"),
        mesh_cfg=None if devices is None else MeshConfig(devices=devices))


def run(name: str, devices: int | None) -> dict:
    """Case ``name`` unsharded (``devices=None``) or over ``devices`` ranks:
    ``{"results": [OptimizeResult, ...], "stale": ..., "schedule": ...}``."""
    case = CASES[name]
    opt = optimizer(case, devices)
    f = get(case["fn"], BASE["dim"])
    if "seeds" in case:
        keys = np.stack([prng.PRNGKey(s).numpy() for s in case["seeds"]])
        results = opt.minimize_many(f, keys)
    else:
        results = [opt.minimize(f, prng.PRNGKey(7), warm=case.get("warm"))]
    sched = opt.recorded_schedule
    return {"results": [dataclasses.astuple(r) for r in results],
            "stale": opt.last_max_staleness,
            "schedule": None if sched is None else (sched.step, sched.deliver)}


def run_all(names, devices: int) -> dict:
    """Every case of ``names`` over ``devices`` ranks, in place: what a
    spawned rank runs."""
    return {n: run(n, devices) for n in names}


def run_all_counting(names) -> tuple[dict, dict]:
    """``run_all(names, 1)`` in a 1-rank group, with the number of each
    ``torch.distributed`` call the mesh's collectives issued."""
    import torch.distributed as dist
    issued = {}
    for call in ("batch_isend_irecv", "all_gather", "all_reduce"):
        def counting(*a, _orig=getattr(dist, call), _name=call, **kw):
            issued[_name] = issued.get(_name, 0) + 1
            return _orig(*a, **kw)
        setattr(dist, call, counting)
    return run_all(names, 1), issued


# -- test_torch_mesh.py's rank side -------------------------------------------

def square(x):
    """The map of the map/reduce checks: elementwise, so every package and
    every device computes the same bits."""
    return x * x


def primitives(arrays: dict, devices: int) -> dict:
    """In a rank of ``devices``: the sharded ring, starvation and
    ``mailbox_post`` on this rank's island block of the global job-stacked
    arrays (``(J, I, ...)``), each result all-gathered back to ``(J, I,
    ...)`` numpy arrays."""
    import torch

    from repro_torch.core import mesh, migration
    group = mesh.Mesh(devices, mesh.ISLAND_AXIS, "gloo").local_group()
    n = arrays["pop"].shape[1] // devices
    t = {k: mesh.local_rows(torch.as_tensor(v), group.rank, n, 1).clone()
         for k, v in arrays.items()}

    def full(x):
        return mesh.all_gather_rows(x, group, dim=1).numpy()

    out = {}
    for k in (1, 2):
        pop, fit = migration.ring(t["pop"], t["fit"], k, group)
        out[f"ring{k}"] = (full(pop), full(fit))
    pop, fit = migration.starvation(t["pop"], t["fit"], 2, t["alive"], group)
    out["starvation"] = (full(pop), full(fit))
    pop, fit = migration.starvation(t["pop"], t["fit"], 2, None, group)
    out["starvation_isfinite"] = (full(pop), full(fit))
    box = {k[4:]: v for k, v in t.items() if k.startswith("box_")}
    posted = migration.mailbox_post(box, t["pop"], t["fit"], 2, t["post"], group)
    out["mailbox_post"] = {k: full(v) for k, v in posted.items()}
    return out


def mesh_runs(devices: int, f_name: str, dim: int, pop, xs, keys) -> dict:
    """In a rank of ``devices``: the population-sharded evaluator on
    ``pop``, a population-sharded DE run, ``minimize_many`` with its jobs
    split over the ranks, ``distributed_map_reduce`` of :func:`square` over
    ``xs`` for each op, and DE over an island mesh (the run compared with
    the reference's sharded engine)."""
    import torch

    from repro_torch.core import executor, mesh
    m = MeshConfig(devices=devices).build("cpu")
    group = m.local_group()
    f = get(f_name, dim)
    out = {"eval": executor.make_batch_evaluator(f, tcore.ExecutorConfig(), group)(
        torch.as_tensor(pop)).numpy()}
    one = tcore.IslandConfig(n_islands=1, pop=16, dim=dim, sync_every=5,
                             max_evals=1200, pop_axes=("data",))
    opt = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], one, device="cpu", mesh=m)
    out["pop_sharded"] = dataclasses.astuple(opt.minimize(f, prng.PRNGKey(7)))
    two = dataclasses.replace(one, n_islands=2, pop_axes=None)
    opt = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], two, device="cpu", mesh=m)
    out["jobs"] = [dataclasses.astuple(r) for r in opt.minimize_many(f, keys)]
    out["map_reduce"] = {op: executor.distributed_map_reduce(
        m, m.axis, square, op, torch.as_tensor(xs)).numpy() for op in ("sum", "min", "max")}
    out["island_mesh"] = run("de", devices)["results"][0]
    return out


def failing(wait: bool):
    """Rank 1 raises; rank 0 waits in a collective rank 1 never reaches."""
    import torch
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise KeyError("rank 1 fails on purpose")
    if wait:
        dist.all_reduce(torch.zeros(1))
    return "rank 0 finished"


JOB_KEYS = ((0, 3), (0, 11), (0, 29))
JOBS_CFG = dict(n_islands=2, pop=16, dim=6, sync_every=5, max_evals=1200)


def jobs_over_mesh(backend: str | None, device: str) -> list:
    """``minimize_many`` of three DE jobs on ``device``: over a 1-rank
    ``mesh=`` of ``backend`` when one is named (inside the group the
    caller spawned), else unsharded."""
    import torch

    cfg = tcore.IslandConfig(**JOBS_CFG)
    m = None if backend is None else MeshConfig(1, backend=backend).build(device)
    opt = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], cfg, device=device, mesh=m)
    keys = torch.tensor(JOB_KEYS, dtype=torch.int64, device=device)
    return [dataclasses.astuple(r) for r in opt.minimize_many(get("rastrigin", 6), keys)]
