#!/usr/bin/env python3
"""Where the trainer's donated step spends its host time: one train step of
llama3.2-1b and of mamba2-370m (full width and depth, bf16 on float32
masters, 8 x 512 tokens, phase 23's setup) timed four ways on the card, in
turns, each step followed by a host read of its loss as ``launch.train``
makes it:

* ``pure``: ``make_train_step(donate=False)``, Adam on copies of the state;
* ``donated``: ``make_train_step(donate=True)``, the trainer's step: a host
  read of the loss, then Adam in place;
* ``in place, no read``: ``loss_and_grads`` then Adam in place with no host
  read before it;
* ``pure, read``: ``loss_and_grads``, a host read of the loss, then Adam on
  copies.

    python3 tools/donate_step_time.py [--rounds 3] [--steps 3]

One JSON line an arch: each way's ms a step (the mean of ``--steps`` steps
after one warm step) per round, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("llama3.2-1b", "mamba2-370m")
WAYS = ("pure", "donated", "in place, no read", "pure, read")


def _step(way: str, cfg, acfg):
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    if way in ("pure", "donated"):
        return steps.make_train_step(cfg, acfg, donate=way == "donated")

    def step(params, opt_state, batch):
        loss, metrics, grads = steps.loss_and_grads(params, cfg, batch)
        if way == "pure, read":
            float(loss)
            params, opt_state = adam.update(grads, opt_state, params, acfg)
        else:
            opt_state = adam.update_(grads, opt_state, params, acfg)
        return params, opt_state, {**metrics, "loss": loss}
    return step


def arch_times(arch: str, rounds: int, n_steps: int) -> dict:
    import dataclasses
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream, to_device
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adam
    cfg = dataclasses.replace(get_config(arch), global_batch=8, seq_len=512,
                              compute_dtype="bfloat16")
    acfg = adam.AdamConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    params = init_params(prng.PRNGKey(0, "cuda"), cfg)
    opt = adam.init(params)
    batch = to_device(next(SyntheticStream(cfg)), "cuda")
    out = {w: [] for w in WAYS}
    for r in range(rounds):
        for way in (WAYS if r % 2 == 0 else WAYS[::-1]):
            step = _step(way, cfg, acfg)
            ms = []
            for i in range(n_steps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                float(metrics["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
            out[way].append(statistics.fmean(ms[1:]))
    return {"arch": arch, "ms_per_step": out,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("donate_step_time: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    for arch in ARCHS:
        print(json.dumps({**arch_times(arch, args.rounds, args.steps), "card": card}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
