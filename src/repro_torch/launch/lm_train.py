"""End-to-end LM training drill: the counterpart of ``examples/lm_train.py``.

A ~20M-parameter llama-family model trained on the synthetic stream with
async checkpoints, stopped half way ("pre-empted") and resumed from the
last checkpoint and its data cursor, as the reference's example does. It
prints the mean loss of the first 20 and the last 20 steps. Runs on the
card unless asked otherwise:

    PYTHONPATH=src python -m repro_torch.launch.lm_train --steps 300
    PYTHONPATH=src python -m repro_torch.launch.lm_train --steps 40 --device cpu

Checkpoints go to ``build/lm_train/`` at the root of the checkout unless
``--ckpt-dir`` names another directory; the directory is emptied first, so
a drill never resumes from an earlier one.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
from pathlib import Path

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.optim import adam

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "lm_train"


def mini_config():
    """llama3.2-1b's family at 4 layers, width 256, vocab 8192: about 20 M
    parameters, float32 throughout (the reference example's model)."""
    return dataclasses.replace(
        get_config("llama3.2-1b"),
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=1024, vocab=8192, seq_len=256, global_batch=8,
        remat=False, compute_dtype="float32", sharding_mode="tp",
        name="llama-mini-20m")


def drill(steps: int, ckpt_dir: str, device=None) -> tuple[list[float], list[float]]:
    """Train half of ``steps``, then resume from the last checkpoint to
    ``steps``; returns the two calls' losses."""
    cfg = mini_config()
    acfg = adam.AdamConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    half = steps // 2
    _, _, losses1 = train(cfg, steps=half, ckpt_dir=ckpt_dir, ckpt_every=25,
                          adam_cfg=acfg, log_every=25, resume=False, device=device)
    print(f"\n-- simulated preemption at step {half}; restarting from the last "
          f"checkpoint --\n", flush=True)
    _, _, losses2 = train(cfg, steps=steps, ckpt_dir=ckpt_dir, ckpt_every=25,
                          adam_cfg=acfg, log_every=25, resume=True, device=device)
    return losses1, losses2


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; cpu runs the plain path)")
    args = ap.parse_args()
    losses1, losses2 = drill(args.steps, args.ckpt_dir, args.device)
    first = np.mean(losses1[:20])
    last = np.mean(losses2[-20:])
    print(f"\nloss: first-20 {first:.3f} -> last-20 {last:.3f} "
          f"({'OK: decreasing' if last < first else 'NOT decreasing'})")


if __name__ == "__main__":
    main()
