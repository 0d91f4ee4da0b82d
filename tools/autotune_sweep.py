#!/usr/bin/env python3
"""Every geometry of the five population kernels on the card: the tuner's
model against CUDA-event timings, in both storage types.

For each kernel and each row count the main path launches it at (D = 1000),
times every candidate of ``kernels.autotune.candidates`` through the
kernel's wrapper (``autotune.time_launch``: a warm-up, then the best of 3
samples of 10 back-to-back launches behind a spin kernel, L2-warm) and
prints the model's prediction beside it, marking the tuner's pick
(``autotune.choose``), the fastest and
``kernels.bench_eval.launch_geometry``'s pick. First it holds each kernel
at bfloat16 storage against its plain version at 800 x 1000. Run from the
root of a checkout on a Hopper GPU:

    PYTHONPATH=src python3 tools/autotune_sweep.py [--out build/autotune_sweep.json]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import de_step as de  # noqa: E402
from repro_torch.kernels import eval_select as es  # noqa: E402
from repro_torch.kernels import ga_step as ga  # noqa: E402
from repro_torch.kernels import pso_step as ps  # noqa: E402
from repro_torch.parallel import roofline as rl  # noqa: E402

D = 1000
TAG = "shifted_rosenbrock"
# Rows each kernel is launched at on the main path (chip_smoke.py's tables):
# Table I's 800, the chunked path's 100, 8 islands' 6400, the polish
# batch's 8000, 2 islands' 1600; GA's wave of 200 and 8 x 200, its steady
# state's 8.
ROWS = {"bench_eval": (800, 100, 8000, 6400), "de_step": (800, 6400, 1600),
        "eval_select": (800, 1600, 6400), "pso_step": (800, 1600, 6400),
        "ga_step": (200, 1600, 8)}


def check_bf16(dev) -> dict:
    """Each kernel at bfloat16 storage against its plain version at 800 x
    1000: the largest fitness error relative to |f| + 1 and the largest
    stored-element difference."""
    g = torch.Generator(device=dev).manual_seed(0)
    P = 800
    u = lambda *s: torch.rand(*s, generator=g, device=dev)   # noqa: E731
    pop = u(P, D) * 200 - 100
    shift = u(D) * 160 - 80
    cfg = at.KernelConfig(dtype="bfloat16")
    args = (TAG, shift, 390.0)
    fit = be.bench_eval_ref(pop, *args)
    rel = lambda a, b: float(((a - b).abs() / (b.abs() + 1)).max())   # noqa: E731
    out = {"bench_eval": rel(be.bench_eval(pop, *args, kernel_cfg=cfg),
                             be.bench_eval_ref(pop, *args, dtype="bfloat16"))}
    idx = torch.stack([(torch.arange(P, device=dev) + k) % P for k in (1, 2, 3)])
    uu, jr = u(P, D), torch.randint(0, D, (P,), generator=g, device=dev)
    got = de.de_step(pop, fit, idx, uu, jr, *args, kernel_cfg=cfg)
    want = de.de_step_ref(pop, fit, idx, uu, jr, *args, dtype="bfloat16")
    out["de_step"] = (rel(got[1], want[1]), float((got[0] - want[0]).abs().max()))
    trial = u(P, D) * 200 - 100
    got = es.eval_select(pop, fit, trial, None, *args, kernel_cfg=cfg)
    want = es.eval_select_ref(pop, fit, trial, None, *args, dtype="bfloat16")
    out["eval_select"] = (rel(got[1], want[1]), float((got[0] - want[0]).abs().max()))
    v, r1, r2 = u(P, D) - 0.5, u(P, D), u(P, D)
    got = ps.pso_step(pop, v, trial, fit, r1, r2, pop[0], *args, kernel_cfg=cfg)
    want = ps.pso_step_ref(pop, v, trial, fit, r1, r2, pop[0], *args, dtype="bfloat16")
    out["pso_step"] = (rel(got[2], want[2]), float((got[0] - want[0]).abs().max()))
    cut = torch.randint(0, D, (P,), generator=g, device=dev)
    co, um, nz = u(P), u(P, D), u(P, D) - 0.5
    got = ga.ga_step(pop, trial, pop, fit, cut, co, um, nz, *args, kernel_cfg=cfg)
    want = ga.ga_step_ref(pop, trial, pop, fit, cut, co, um, nz, *args, dtype="bfloat16")
    out["ga_step"] = (rel(got[1], want[1]), float((got[0] - want[0]).abs().max()))
    return out


def sweep(dev) -> list[dict]:
    card = rl.card_of(dev)
    rows = []
    for kind, counts in ROWS.items():
        for P in counts:
            for dtype in ("float32", "bfloat16"):
                preds = at.ranked(kind, P, D, TAG, card=card, dtype=dtype)
                pick = at.choose(kind, P, D, TAG, dtype=dtype, card=card)
                run = at._runner(kind, P, D, TAG, dtype, dev)
                times = {p.config: at.time_launch(lambda c=p.config: run(c), dev)
                         for p in preds}
                isz = 4 if dtype == "float32" else 2
                old = be.launch_geometry(P, D, 16, card.sms, isz)
                old_cfg = (at.KernelConfig(threads=ps.MAX_THREADS, dtype=dtype)
                           if kind == "pso_step" else
                           at.KernelConfig(vec=old.vec, warps_per_row=old.warps_per_row,
                                           rows_per_block=old.rows_per_block, dtype=dtype))
                fastest = min(times, key=times.get)
                for p in preds:
                    c = p.config
                    rows.append({"kind": kind, "rows": P, "dtype": dtype,
                                 "geometry": [c.vec, c.warps_per_row, c.rows_per_block,
                                              c.threads],
                                 "model_us": p.t_total * 1e6, "us": times[c] * 1e6,
                                 "model_pick": c == pick, "fastest": c == fastest,
                                 "heuristic": c == old_cfg})
                print(f"{kind:12s} {P:5d} {dtype:9s} model {pick} {times[pick] * 1e6:.2f} us; "
                      f"fastest {fastest} {times[fastest] * 1e6:.2f}; "
                      f"heuristic {times[old_cfg] * 1e6:.2f}", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/autotune_sweep.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    from repro_torch.kernels import _build
    _build.library("bench_eval")
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    errs = check_bf16(dev)
    print("bf16 vs plain:", json.dumps(errs), flush=True)
    rows = sweep(dev)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps({"card": smi.stdout.strip(), "bf16_errors": errs,
                                       "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
