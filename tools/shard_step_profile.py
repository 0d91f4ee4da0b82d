#!/usr/bin/env python3
"""Where a sharded train step's time goes: 2 gloo ranks on the card
(``launch.mesh.make_host_mesh``, collectives through ``StagedGloo``),
llama3.2-1b at full width and 2 layers, bf16 on float32 masters, 512-token
rows, the ``parallel.sharding`` layouts; after two warm steps, one step
timed with each staged collective's seconds, calls and bytes, then one
under ``torch.profiler`` on rank 0 (its top operators by self CPU time).

    python3 tools/shard_step_profile.py     # (1, 2) at batch 8, (2, 1) at 16

One line of readings a mesh, then the profiler's table.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = (((1, 2), 8), ((2, 1), 16))
STAGED_OPS = ("allreduce", "all_gather_single", "reduce_scatter_single", "all_to_all_single",
              "allgather", "broadcast")


def _tally(StagedGloo) -> tuple[collections.Counter, ...]:
    """Wrap StagedGloo's collectives: seconds, calls and bytes by kind."""
    spent, calls, nbytes = collections.Counter(), collections.Counter(), collections.Counter()
    for name in STAGED_OPS:
        f = getattr(StagedGloo, name)

        def timed(self, *a, _f=f, _n=name, **k):
            t0 = time.perf_counter()
            out = _f(self, *a, **k)
            spent[_n] += time.perf_counter() - t0
            calls[_n] += 1
            x = a[1] if _n in ("all_gather_single", "reduce_scatter_single",
                               "all_to_all_single") else a[0]
            x = x[0] if isinstance(x, list) else x
            nbytes[_n] += x.numel() * x.element_size()
            return out

        setattr(StagedGloo, name, timed)
    StagedGloo._allgather_base = StagedGloo.all_gather_single
    StagedGloo._reduce_scatter_base = StagedGloo.reduce_scatter_single
    StagedGloo.alltoall_base = StagedGloo.all_to_all_single
    return spent, calls, nbytes


def body(shape: tuple, batch: int) -> dict:
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream, to_device
    from repro_torch.launch import mesh as lmesh, steps, train
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adam
    from repro_torch.parallel import sharding
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2, compute_dtype="bfloat16",
                              seq_len=512, global_batch=batch)
    mesh = lmesh.make_host_mesh(*shape, device="cuda")
    spent, calls, nbytes = _tally(lmesh.StagedGloo)
    p_sh, o_sh, c_sh, b_sh = train.layouts(cfg, mesh)
    params = sharding.place(init_params(prng.PRNGKey(0, "cuda"), cfg), p_sh)
    opt = sharding.place(adam.init(params), o_sh)
    batch_ = sharding.place(to_device(next(SyntheticStream(cfg)), "cuda"), b_sh)
    step = steps.make_train_step(cfg, adam.AdamConfig(lr=1e-3), c_sh)
    for _ in range(2):
        step(params, opt, batch_)
        torch.cuda.synchronize()
    for tally in (spent, calls, nbytes):
        tally.clear()
    t0 = time.perf_counter()
    step(params, opt, batch_)
    torch.cuda.synchronize()
    out = {"mesh": dict(zip(("data", "model"), shape)), "batch": batch,
           "step_s": time.perf_counter() - t0, "staged_s": dict(spent),
           "staged_calls": dict(calls), "staged_mb": {k: v / 1e6 for k, v in nbytes.items()}}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch_)
        torch.cuda.synchronize()
    if dist.get_rank() == 0:
        ka = prof.key_averages()
        out["device_ms"] = sum(e.self_device_time_total for e in ka
                               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out["table"] = ka.table(sort_by="self_cpu_time_total", row_limit=15,
                                max_name_column_width=50)
    return out


def main() -> int:
    import torch
    from repro_torch.core import mesh as cm
    if not torch.cuda.is_available():
        print("shard_step_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for shape, batch in CASES:
        res = cm.spawn(2, body, shape, batch, backend="gloo", timeout=400)
        table = res.pop("table")
        print(json.dumps(res), flush=True)
        print(table, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
