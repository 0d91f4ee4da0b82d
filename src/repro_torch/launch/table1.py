"""Table I on the card: the paper's production DDE workload, timed.

The port's counterpart of ``benchmarks/table1_de_scaling.py``'s
``measure_single_device``: one island of chunked DE ("non-determinism-ok")
on the CEC'2008 shifted Rosenbrock at ``configs.popt_bench.CONFIG``'s width
(pop 800, dim 1000, w 0.5, px 0.2), for ``--gens`` generations on the
``cuda`` evaluation backend; ``--hybrid`` runs ``HYBRID_CONFIG`` (asd polish
of the top 2 every 8 rounds, 2 steps). It prints ms per generation, the
evaluations and the incumbent. The reference's modelled multi-worker
scaling (a TPU roofline model) is not ported.

    python -m repro_torch.launch.table1 --gens 100 [--hybrid] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.popt_bench import CONFIG, HYBRID_CONFIG, PoptBenchConfig
from repro_torch.core import ALGORITHMS, ExecutorConfig, IslandConfig, IslandOptimizer
from repro_torch.functions.benchmarks import get

SYNC_EVERY = 10


def measure_single_device(cfg: PoptBenchConfig, gens: int, seed: int = 0,
                          device: str | torch.device | None = None) -> dict:
    """Run ``cfg`` for ``gens`` generations (rounded down to whole sync
    rounds; the polish events of a hybrid config are charged on top) and
    time it, host clock around ``minimize``."""
    dev = resolve_device(device)
    f = get(cfg.function, cfg.dim)
    params = {"w": cfg.w, "px": cfg.px, "strategy": cfg.strategy,
              "barrier_mode": cfg.barrier_mode}
    icfg = IslandConfig(n_islands=1, pop=cfg.pop, dim=cfg.dim, migration="none",
                        sync_every=SYNC_EVERY, polish=cfg.polish,
                        polish_every=cfg.polish_every, polish_topk=cfg.polish_topk,
                        polish_steps=cfg.polish_steps)
    backend = "cuda" if dev.type == "cuda" else "torch"
    opt = IslandOptimizer(ALGORITHMS["de"], icfg, params=params,
                          exec_cfg=ExecutorConfig(backend=backend), device=dev)
    algo = opt._build(f)
    _, per_point = opt._polish(f)
    rounds = max(1, gens // SYNC_EVERY)
    n_polish = rounds // max(1, cfg.polish_every) if cfg.polish != "none" else 0
    max_evals = (algo.init_evals + rounds * SYNC_EVERY * algo.evals_per_gen
                 + n_polish * per_point * min(cfg.polish_topk, cfg.pop))
    opt = IslandOptimizer(ALGORITHMS["de"], dataclasses.replace(icfg, max_evals=max_evals),
                          params=params, exec_cfg=ExecutorConfig(backend=backend),
                          device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = opt.minimize(f, prng.PRNGKey(seed))
    wall = time.perf_counter() - t0
    return {"device": str(dev), "polish": cfg.polish, "gens": res.n_gens,
            "polish_events": n_polish, "n_evals": res.n_evals, "wall_s": wall,
            "ms_per_gen": wall / max(res.n_gens, 1) * 1e3, "best": res.value}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gens", type=int, default=100,
                    help="generations (paper: 20000), whole rounds of 10")
    ap.add_argument("--hybrid", action="store_true",
                    help="HYBRID_CONFIG: asd polish of the top 2 every 8 rounds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    cfg = HYBRID_CONFIG if args.hybrid else CONFIG
    out = measure_single_device(cfg, args.gens, args.seed, args.device)
    if out["device"].startswith("cuda"):
        out["card"] = torch.cuda.get_device_name(0)
    print(f"[table1] {'hybrid' if args.hybrid else 'plain'} DDE {cfg.pop} x {cfg.dim}: "
          f"{out['ms_per_gen']:.2f} ms/gen over {out['gens']} gens "
          f"({out['polish_events']} polish events), best {out['best']:.6g}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
