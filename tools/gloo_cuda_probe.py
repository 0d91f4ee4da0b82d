#!/usr/bin/env python3
"""Which DTensor collectives run on CUDA tensors over gloo, with 2 ranks on
one card: each op in its own pair of spawned ranks (a segfault ends only
that pair), once on gloo's own CUDA paths and once on
``launch.mesh.StagedGloo`` (gloo on host copies).

    python3 tools/gloo_cuda_probe.py            # every op, both routes
    python3 tools/gloo_cuda_probe.py --ops allgather_model --routes gloo

Prints one line an (route, op, mesh shape): ``ok`` with the largest error
against the plain result, or ``FAIL`` with the error (a rank that dies
shows as its exit code, -11 for a segfault).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OPS = ("distribute", "allgather_model", "allgather_data", "allreduce", "reducescatter_model",
       "reducescatter_data", "alltoall", "mm_grad", "allreduce_max_f32", "allreduce_sum_i32")


def body(route: str, dev: str, op: str, shape: tuple) -> object:
    """One op on this rank of a (data, model) mesh of ``shape``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    from repro_torch.launch import mesh as lmesh
    if dev == "cuda":
        torch.cuda.set_device(0)
    ranks = torch.arange(2).reshape(shape)
    if route == "staged" or dev == "cpu":
        m = lmesh.make_host_mesh(*shape, device=dev)
    else:
        m = DeviceMesh(dev, ranks, mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 6, generator=g).to(dev)
    R, S0 = Replicate(), Shard(0)
    d_model = distribute_tensor(a, m, [R, S0], src_data_rank=None)
    d_data = distribute_tensor(a, m, [S0, R], src_data_rank=None)

    def err(x, want):
        return float((x - want).abs().max())

    if op == "distribute":
        return tuple(d_model.to_local().shape)
    if op == "allgather_model":
        return err(d_model.redistribute(m, [R, R]).to_local(), a)
    if op == "allgather_data":
        return err(d_data.redistribute(m, [R, R]).to_local(), a)
    if op == "allreduce":
        p = DTensor.from_local(a.clone(), m, [R, Partial()])
        return err(p.redistribute(m, [R, R]).to_local(), a * m.size(1))
    if op == "reducescatter_model":
        p = DTensor.from_local(a.clone(), m, [R, Partial()])
        return err(p.redistribute(m, [R, S0]).full_tensor(), a * m.size(1))
    if op == "reducescatter_data":
        p = DTensor.from_local(a.clone(), m, [Partial(), R])
        return err(p.redistribute(m, [S0, R]).full_tensor(), a * m.size(0))
    if op == "alltoall":
        return err(d_model.redistribute(m, [R, Shard(1)]).full_tensor(), a)
    if op == "mm_grad":
        w0 = torch.randn(6, 4, generator=g).to(dev)
        w = distribute_tensor(w0, m, [R, Shard(1)], src_data_rank=None).requires_grad_()
        (gw,) = torch.autograd.grad((d_data @ w).sum(), [w])
        want = a.sum(0)[:, None].expand(6, 4)
        return err(gw.redistribute(m, w.placements).full_tensor(), want)
    kind = torch.float32 if op == "allreduce_max_f32" else torch.int32
    x = torch.full((5,), dist.get_rank() + 1, dtype=kind, device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.MAX if kind == torch.float32 else dist.ReduceOp.SUM,
                    group=m.get_group("data"))
    return x.tolist()


def one(route: str, op: str) -> None:
    import torch
    from repro_torch.core import mesh as cm
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for shape in ((1, 2), (2, 1)):
        try:
            res = cm.spawn(2, body, route, dev, op, shape, backend="gloo", timeout=120)
            print(f"{route} {op} {shape}: ok {res}", flush=True)
        except Exception as e:  # noqa: BLE001 — reported, the next op still runs
            print(f"{route} {op} {shape}: FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ops", default=",".join(OPS))
    ap.add_argument("--routes", default="gloo,staged")
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)  # route op, in a child
    args = ap.parse_args()
    if args.one:
        one(*args.one)
        return 0
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout,
              end="", flush=True)
    jobs = [(r, o) for r in args.routes.split(",") for o in args.ops.split(",")]
    # each (route, op) in a process of its own, four at a time
    running = []
    for route, op in jobs:
        running.append(subprocess.Popen([sys.executable, __file__, "--one", route, op]))
        if len(running) == 4:
            running.pop(0).wait()
    for p in running:
        p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
