"""Round throughput of the island engine over 1, 2 and 4 ranks.

The port's counterpart of ``benchmarks/distributed.py`` and
``examples/distributed_de.py --islands N --devices D``: the same island DE
configuration (ring migration) with its islands over ``D`` ranks
(``core.mesh.MeshConfig``), timed in the ranks themselves after a warm-up
run, so the spawn of the ranks (reported on its own) is not in the rate.
It reports sync rounds per second and the speedup over one rank (the
unsharded engine), and checks every rank count's result equals the
unsharded one bit for bit. No speedup is asserted.

Routes: ``--backend nccl`` places one rank per GPU; ``gloo`` puts every
rank on ``--device`` (the CPU, or all on one card, where the ranks
time-slice it, so its rate says nothing of NCCL scaling). The default is
nccl on the card when it has a GPU per rank, gloo otherwise.

    python -m repro_torch.launch.distributed [--devices 1,2,4] [--islands 8]
        [--pop 800] [--dim 1000] [--rounds 10] [--fused] [--device cpu]
        [--backend gloo]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import ALGORITHMS, ExecutorConfig, IslandConfig, IslandOptimizer
from repro_torch.core import mesh
from repro_torch.functions.benchmarks import get


def _timed(opt: IslandOptimizer, f, repeats: int, device: torch.device):
    """(wall seconds of each of ``repeats`` runs after a warm-up, the last
    result)."""
    key = prng.PRNGKey(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    res = opt.minimize(f, key)
    walls = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        res = opt.minimize(f, key)
        sync()
        walls.append(time.perf_counter() - t0)
    return walls, res


def _in_ranks(devices: int, backend: str, device: str, kw: dict, repeats: int):
    """A rank of the timed run: the mesh run in place, on this rank's
    device; returns its walls, result and device."""
    m = mesh.MeshConfig(devices=devices, backend=backend)
    dev = mesh.rank_device(device, m.build(device).local_group())
    opt = _optimizer(kw, dev, m)
    walls, res = _timed(opt, get(kw["fn"], kw["dim"]), repeats, dev)
    return walls, res, str(dev)


def _optimizer(kw: dict, device, mesh_cfg=None) -> IslandOptimizer:
    cfg = IslandConfig(n_islands=kw["islands"], pop=kw["pop"], dim=kw["dim"],
                       sync_every=kw["sync_every"], migration="ring",
                       max_evals=kw["islands"] * kw["pop"] * (1 + kw["rounds"] * kw["sync_every"]))
    backend = "cuda" if torch.device(device).type == "cuda" else "torch"
    return IslandOptimizer(ALGORITHMS["de"], cfg, params={"fused": kw["fused"]},
                           exec_cfg=ExecutorConfig(backend=backend), device=device,
                           mesh_cfg=mesh_cfg)


def time_devices(devices: int, kw: dict, device: torch.device, backend: str,
                 repeats: int) -> dict:
    """Median wall and round throughput of the run over ``devices`` ranks
    (1: the unsharded engine in this process)."""
    t0 = time.perf_counter()
    if devices == 1:
        walls, res = _timed(_optimizer(kw, device), get(kw["fn"], kw["dim"]), repeats,
                            device)
        used, route = [str(device)], "none"
    else:
        walls, res, dev0 = mesh.spawn(devices, _in_ranks, devices, backend, str(device),
                                      kw, repeats, backend=backend)
        used = ([f"cuda:{r}" for r in range(devices)] if backend == "nccl"
                else [dev0] * devices)
        route = backend
    total = time.perf_counter() - t0
    wall = statistics.median(walls)
    rounds = res.n_gens // kw["sync_every"]
    return {"devices": devices, "route": route, "rank_devices": used,
            "wall_s": wall, "rounds_per_s": rounds / wall, "ms_per_gen": wall / res.n_gens * 1e3,
            "spawn_and_warmup_s": total - sum(walls), "value": res.value,
            "history": res.history, "arg": res.arg}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default="1,2,4", help="rank counts, comma-separated")
    ap.add_argument("--fn", default="rastrigin")
    ap.add_argument("--islands", type=int, default=8)
    ap.add_argument("--pop", type=int, default=512)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--sync-every", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=10, help="sync rounds per run")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--fused", action="store_true", help="the fused de_step generation")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the plain path)")
    ap.add_argument("--backend", default=None, choices=mesh.BACKENDS,
                    help="route of the ranks (default: nccl when the card has a GPU "
                         "per rank, else gloo)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    counts = [int(d) for d in args.devices.split(",")]
    kw = {"fn": args.fn, "islands": args.islands, "pop": args.pop, "dim": args.dim,
          "sync_every": args.sync_every, "rounds": args.rounds, "fused": args.fused}
    rows = []
    for d in counts:
        backend = args.backend or mesh.default_backend(device, d)
        rows.append(time_devices(d, kw, device, backend, args.repeats))
    base = rows[0]
    for r in rows:
        r["speedup_vs_first"] = base["wall_s"] / r["wall_s"]
        r["same_as_first"] = bool(r["value"] == base["value"]
                                  and np.array_equal(r["history"], base["history"])
                                  and np.array_equal(r["arg"], base["arg"]))
        print(f"[distributed] {r['devices']} rank(s), route {r['route']} on "
              f"{','.join(r['rank_devices'])}: {r['rounds_per_s']:.3f} rounds/s, "
              f"{r['ms_per_gen']:.3f} ms/gen, speedup {r['speedup_vs_first']:.3f}, "
              f"same result {r['same_as_first']}")
    out = {"config": kw, "card": (torch.cuda.get_device_name(0)
                                  if device.type == "cuda" else None),
           "rows": [{k: v for k, v in r.items() if k not in ("history", "arg")}
                    for r in rows]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
