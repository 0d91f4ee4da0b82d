#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py              # all phases
    python3 chip_smoke.py --phases 1,2 # a subset, for a quick check

The kernels are built from ``src/repro_torch/kernels/csrc`` with nvcc into
``build/`` on first use. Phases (any failure exits non-zero):

  1. each kernel against its plain PyTorch version on the card, at every
     shape a later phase launches it at (derived from the run tables
     below) and at odd sizes; bench_eval also on a row view and an
     unaligned view of Table I's population; de_step, ga_step and
     eval_select past the staging cap of csrc/eval_row.cuh (their two-pass
     kernels), ga_step and eval_select also on unaligned views; de_step and
     pso_step on a NaN lane (a NaN DE trial must keep its parent, a NaN PSO
     velocity stay NaN), as their plain versions clip; bench_eval also at
     128,000 rows; flash_attention at every model case with its mask
     (gemma2's local and global layers, zamba2's hd 112, gemma's hd 256)
     and at wide head dims in both types; the two backward kernels
     (flash_attention_bwd, ssd_scan_bwd) against autograd of their plain
     versions at every case phases 23-24 launch them at, in both types,
     with gemma2's window and softcap at head dim 256 and an odd SSD scan,
     each backward run twice for the same bits;
  2. the draws on the card against the CPU: threefry, uniform, randint
     bitwise; normal and categorical to the last bit or ulp;
  3. Table I fused: 1 island, pop 800, shifted Rosenbrock-1000, 200 gens;
  4. Table I unfused: sync, 20 gens, and chunked, 50 gens
     (benchmarks/table1_de_scaling.py's setup);
  5. 8 islands x pop 800 x dim 1000, ring migration, fused, 100 gens;
  6. small DE runs (fused, sync, chunked) on the card against the same runs
     on the CPU;
  7. PSO, GA and SA, each fused and unfused, at Table I's objective and
     width (1 island, pop 800, dim 1000); then the paper's Fig. 4 settings
     on rastrigin-1000 (GA and SA pop 100, PSO pop 10);
  8. DGA: 8 GA islands x pop 800 x dim 1000, fused, aging, starvation
     migration, with the default offspring wave and in a steady-state form
     whose islands starve; and 8 PSO islands, fused, ring migration;
  9. small PSO, GA (steady-state aging, starvation) and SA runs, fused and
     unfused, on the card against the same runs on the CPU;
 10. llama3.2-1b at full width and depth, bf16, random weights from a fixed
     key: ``serve`` with batch 4, a 2048-token prompt and 32 greedy decode
     steps, then ``make_prefill_step`` at batch 1 x 4096 (flash_attention
     once per layer and prefill: 16);
 11. mamba2-370m at full width and depth, bf16: ``make_prefill_step`` at
     batch 4 x 2048 (ssd_scan once per layer: 48), then ``serve`` with
     batch 4, a 64-token prompt and 32 decode steps (the recurrent
     cache-filling prefill launches no kernel);
 12. both at full width with 2 layers in float32 and in bfloat16, on the
     card against the plain path on the CPU on the same weights: prefill
     logits, and greedy decoding teacher-forced by the CPU's tokens;
 13. EA, FA, BH and MC at Table I's objective and width (1 island, pop 800,
     dim 1000, unfused on the cuda backend), 20-30 generations each; then
     8 EA islands with ring migration, which must adopt migrants;
 14. small EA, FA, BH and MC runs and DE with each polish method (asd, fcg,
     avd, bfgs) on the card against the same runs on the CPU (4 islands,
     pop 64, dim 100); a polish run also on the CPU with the card's
     objective values (see _card_vs_cpu);
 15. Table I's hybrid (configs/popt_bench.py HYBRID_CONFIG: chunked DE,
     asd polish of the top 2 every 8 rounds) for 8 rounds through
     ``explore_then_polish``, whose stage 2 polishes the incumbent: ms/gen,
     ms and bench_eval launches per polish event, n_evals against the
     reference's accounting;
 16. the multi-job service through ``OptimizationService.handle`` (one
     worker thread, checkpoints under build/service) at Table I's width:
     A, 8 fused DE jobs of 6 rounds, in turns with their 8 standalone
     ``minimize`` runs
     (jobs/s), then profiled as a bucket of 8 and of 1 (ms per round,
     launches per round, the device's idle share); B, 4 fused PSO jobs; C,
     2 hybrid jobs (HYBRID_CONFIG's chunked DE, polished every 2 rounds,
     2 rounds) and
     ``explore_then_polish_many``; D, 2 fused DE jobs warm-started from A's
     incumbents; every job bit-identical to its standalone run; E, bucket A
     killed at round 5 and finished by a fresh scheduler's ``resume``, bit
     for bit, and a job cancelled after a round with its partial result;
     F, ``launch.federate`` with 2 workers on the card, uninterrupted and
     with a worker SIGKILLed in leg 1: the same values, both workers on
     cuda;
 17. heterogeneous portfolio islands and async islands at Table I's width:
     A, 8 islands of de, pso, sa and ga (two each, cycled, every policy
     fused, the incumbent shared) for 50 generations, one launch of each
     fused kernel per generation (one per group of islands), rows adopted
     per round, profiled (the grouping's gathers and scatters counted),
     then in turns with phase 5's run; B, the homogeneous portfolio
     ("de",) on phase 5's run, bit-identical to it; C, phase 5's run async
     at staleness 0, bit-identical to the barrier run, then a straggler
     (island 0 every 4th tick, staleness up to 4) for 10 ticks in turns
     with the barrier run, and its recorded schedule replayed bit for bit;
     D, benchmarks/portfolio.py's default cell (9 seeds through
     ``minimize_many``), a seeded async DE run and an async mixed
     portfolio on the card against the CPU, and the cell's single
     algorithms for the benchmark's claim (logged); E, a portfolio bucket
     and an async bucket of 3 jobs each through the service, every job
     bit-identical to its standalone run, and a request for more ranks than
     the host can place ending in error;
 18. islands over ranks (``core/mesh.py``: one process per rank, spawned
     by ``mesh.spawn``; nccl when the machine has a GPU per rank, gloo
     with every rank on cuda:0 otherwise, each line naming its route and
     its ranks' devices): A, phase 5's run on a 1-rank nccl mesh,
     bit-identical to the unsharded run, in turns with it (ms/gen), whose
     all-gathers and all-reduces go through NCCL (counted; the ring's hop
     is the identity on one rank, so NCCL's send/recv does not run); B, the
     same run over 2 and 4 ranks, bit-identical (ms/gen, each rank's
     kernel launches and, by torch.profiler, all its device launches per
     generation, the bytes each rank sends per round); C, the
     steady-state starvation GA of phase 8 over 4 ranks (the all-gather
     path), phase 17's mixed portfolio and straggler over 2, and 3 jobs of
     phase 5's run through ``minimize_many`` over 2, each bit-identical to
     its unsharded run (30, 30, 30 and 20 generations); D, a ``devices:
     2`` request through the scheduler ending done with the value of the
     same request at ``devices: 1``, and one the host cannot place ending
     in error (A also runs C's 3 jobs through ``minimize_many`` with the
     jobs split over the 1-rank group, ``mesh=``, their rows all-gathered
     on the rank's device, bit-identical to the unsharded run); E, ``distributed_map_reduce`` (sum, min, max of an
     elementwise square) over 2 ranks against the CPU: min and max exact,
     sum within rows x 2^-24 x sum|x^2|. The ranks record their own
     launches and launch shapes, which come back to the phase;
 19. granite-3-8b, gemma-7b, gemma2-9b and zamba2-7b at full width and a
     quarter of their depth (``PHASE19_DEPTH``), bf16, random weights
     (each drawn once on the card, the last arch's freed first; the peak
     memory reset per arch): ``serve`` at batch 4 x 2048 with 16 decode
     steps for granite and gemma-7b; gemma2 ``serve`` at 1 x 6144 (past
     its 4096 window) and a prefill at 2 x 4096; zamba2 prefill at 2 x
     2048 (24 ssd_scan and 4 flash launches) and ``serve`` at batch 2
     with a 64-token prompt stepped token by token;
 20. the four archs of 19 at full width, 2 layers (zamba2 6: one shared
     application), float32 and bfloat16, on the card against the CPU as
     in phase 12 (prefill 2 x 128, zamba2 2 x 512; serve with 8 greedy
     steps teacher-forced from a 128-token prompt, zamba2 a 16-token one);
 21. MoE serving and the stub frontends at full width, bf16, random
     weights (each arch's drawn once on the card, the last arch's freed
     first, the peak memory reset per arch): qwen2-moe-a2.7b at full
     depth with bfloat16 parameters, ``serve`` at 4 x 2048 with 16 decode
     steps and a prefill at 4 x 2048; llama4-scout-17b-a16e at 8 of its 48
     layers, bfloat16 parameters, ``serve`` at 4 x 2048 with 16 decode
     steps; internvl2-2b, a prefill of 256 patch embeddings (width 1024)
     before 2048 tokens at batch 4, and ``serve`` at 4 x 2048;
     musicgen-medium, a prefill of 4 x 2048 frame embeddings (width 1536),
     then ``launch.steps``' cache-filling prefill and 16 decode steps on
     frames (``serve`` refuses the audio frontend). The MoE archs' warm-up
     counts the (token, k) pairs their capacity drops at prefill and at
     decode;
 22. the four archs of 21 at full width, 2 layers (llama4-scout 1),
     float32 and bfloat16 (the MoE archs with bfloat16 parameters), on the
     card against the CPU as in phase 20 (prefill 2 x 256, internvl2
     behind 256 patches; serve with 8 greedy steps teacher-forced, musicgen
     8 steps on frames); the card replays the CPU's routing and its own
     must agree wherever the router's K-th and (K+1)-th experts are clear
     of each other (``RoutingReplay``);
 23. training on the card through ``launch.train.train``: llama3.2-1b,
     then mamba2-370m, at full width and depth, bf16 on float32 masters,
     8 x 512 tokens a step from the synthetic stream, 6 steps: every
     step's loss and grad norm finite, every parameter leaf's gradient not
     all zero after step 1 (its first moment), each kernel launched its
     ``train_cases`` count per step (the forward twice a layer under
     remat, the backward once); ms/step, tokens/s, peak memory and the
     device's idle share over the last 2 steps, profiled;
 24. the same two archs at full width, 2 layers, float32 and bf16, one
     train step on the card against the CPU on the same weights and batch
     (llama 1 x 64 tokens, mamba2 1 x 256): the loss, every gradient leaf
     and the params after one Adam update within ``TRAIN_TOL``; then, on
     mamba2 in bf16, the resume drill: 4 steps checkpointed every 2,
     resumed to 6 by a fresh call, bit-identical to 6 steps in one call;
 25. bfloat16 population storage and the geometry tuner (first process):
     A, the five population kernels in float32 and bfloat16 storage
     (``KernelConfig(dtype=...)``, csrc/<name>_bf16.cu) against their plain
     versions at every shape this phase launches them at (Table I's, 8
     islands', the 8,000-row polish batch; recorded as phase 1's checks);
     B, Table I's fused DE with bfloat16 storage set only on
     ``ExecutorConfig.kernel``, then in turns with the float32 route
     (ms/gen), and 2 islands of 64 x 200 card vs CPU; C, the tuner
     (``kernels.autotune``): a second build is a cache hit, and at each
     of those shapes in both storage types the seconds of ``choose``, the
     model's pick, the measured pick (``measure=True``) and
     ``launch_geometry``'s pick (pso_step's old 256 threads) timed in
     turns.

flash_attention and ssd_scan take two routes by the input's type: bfloat16
runs the tensor-core kernels (``csrc/*_tc.cu``), float32 the CUDA-core
kernels. After the phases, the kernel timings put the CUDA-core design
(through its C entry at bf16) beside each tensor-core kernel, time both at
every case the model phases launch them at, and count the tensor-core
instructions in the tensor-core kernels' SASS (``cuobjdump``). The four
kernels on csrc/eval_row.cuh are timed at every shape the main path gives
them (bench_eval at Table I's population and the chunked path's 100 x
1000 and phase 15's polish batches; de_step also at phase 5's 8 x 800 x
1000; ga_step at GA's 200-row
wave, 8 islands of it and the 8-island steady state; eval_select at SA's
800 x 1000), each with its bound, the launch geometry its wrapper chose
and, for ga_step and eval_select, the share of rows taken or accepted; the compiler's registers, shared memory and spills
for their libraries are printed. All five population kernels are also
timed with bfloat16 storage at their first two shapes (bound at 2 bytes
an element). The main-path runs of GA and SA also
report the share of rows their fused kernel took or accepted.

Phases 3-5, 7, 8, 10, 11, 13, 15-19, 21 and 23 are the main path: each run resets
the kernels' launch counters, drives its entry point
(``IslandOptimizer.minimize``, ``explore_then_polish``, ``serve``, a prefill
step, ``launch.steps``, ``OptimizationService.handle``, ``launch.train.train``)
and reads the counters right after. Each engine configuration is then profiled over a few rounds of a
further run, init excluded, and each serve run over a few further decode
steps, for the device's busy time and idle share.
Every launch records its kernel and input shape; the run fails if a phase
launched a kernel at a shape phase 1 did not check, or if a run marked to
adopt migrants never did.

Phases 6, 10-15 and 19-24 run in a second process of this script, started
after the build, beside the first process's phases 1-5, 7-9 and 16-18
(``SECOND_PROCESS_PHASES``); both drive the one card, so each phase's
seconds and host-clock readings are taken beside the other process's
work. The second process's lines are relayed through the first; when it
ends, its launches, errors and launch shapes join the first's record. The
kernel timings run after both, alone on the card.

Before the last line it prints the card's name and power limit and one JSON
line describing every kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Data-sheet rates of the H100 SXM (NVIDIA H100 data sheet): memory bytes/s,
# dense float32 FLOP/s outside the tensor cores and dense bf16 FLOP/s on the
# tensor cores.
CARD_RATES = {"NVIDIA H100 80GB HBM3": {"bytes": 3.35e12, "float32": 67e12,
                                        "bfloat16": 989e12}}

# The main path's sizes: Table I's population and dimension.
POP, DIM, SYNC_EVERY = 800, 1000, 10


@dataclasses.dataclass(frozen=True)
class Run:
    """One engine configuration a phase drives: ``ALGORITHMS[algo]`` on
    ``fn`` (shifted Rosenbrock of ``dim``, or a benchmark function by name)
    for ``gens`` generations on the ``cuda`` backend, with ring migration
    between islands unless ``migration`` says otherwise."""

    label: str
    algo: str
    gens: int
    params: dict = dataclasses.field(default_factory=dict)
    fn: str = "shifted_rosenbrock"
    seed: int = 0
    n_islands: int = 1
    pop: int = POP
    dim: int = DIM
    migration: str | None = None
    sync_every: int = SYNC_EVERY
    profile: bool = True
    adopts: bool = False     # migrants must be adopted in at least one round
    polish: dict = dataclasses.field(default_factory=dict)  # IslandConfig.polish*
    # A portfolio run names one policy per island (cycled) and keeps each
    # policy's params under its name in ``params``; ``algo`` is then unused.
    portfolio: tuple = ()
    share: bool = False      # IslandConfig.share_incumbent
    sync: dict = dataclasses.field(default_factory=dict)  # sync_policy, max_staleness
    # AsyncSchedule of an async run: {"seed": s} or {"cadences": (...)}.
    schedule: dict = dataclasses.field(default_factory=dict)
    jobs: int = 1            # jobs of a bucket, for the shapes it launches
    storage: str = "float32"  # KernelConfig.dtype, threaded from ExecutorConfig.kernel


# Table I's DE parameters (benchmarks/table1_de_scaling.py).
DE_TABLE1 = {"w": 0.5, "px": 0.2}
# FA in a box 200 wide: Fig. 4's gamma = 200 (the paper's 50 fireflies in
# small boxes) makes every attraction exp(-gamma r^2) underflow at these
# distances (r^2 near D w^2 / 6), leaving a random walk whose incumbent may
# never move. gamma = 1e-7 puts gamma r^2 near 1; beta0 = 1e-3 keeps the sum
# over hundreds of brighter fireflies a step toward their centroid; alpha0
# = 1e-3 keeps the walk's step alpha / sqrt(gamma) at about 3 per lane.
FA_WIDE = {"gamma": 1e-7, "beta0": 1e-3, "alpha0": 1e-3}
# BH in the same box: the default kick of a quarter of the box (50 per lane)
# and probes of a twentieth leave every walker far uphill, so nothing is
# ever accepted; a kick and first probe of 1e-3 of the box (0.2 per lane)
# descend.
BH_WIDE = {"perturb_frac": 1e-3, "ls_frac": 1e-3}
# GA aging in the DGA runs: Gaussian age limits, mean 6 and sd 2 generations.
AGING = {"age_mean": 6.0, "age_sd": 2.0}
# A steady-state DGA: one offspring per island and generation and short,
# widely spread lives, so each island holds a few live members and their
# counts differ enough (a ratio of 2.5) for starvation migration to fire.
# At the default pop / 4 offspring the live counts of the islands stay
# within a few percent of each other and starvation never fires.
STARVING = {"n_offspring": 1, "age_mean": 2.0, "age_sd": 6.0}

# The main path: phases 3-5, 7 and 8, each run once through _drive.
MAIN_RUNS = {
    3: (Run("Table I fused", "de", 200, {**DE_TABLE1, "fused": True}),),
    4: (Run("Table I sync", "de", 20, {**DE_TABLE1, "barrier_mode": "sync"},
            profile=False),
        # Not profiled: torch.profiler over the chunked path's 14,500
        # device launches a generation took about 90 s of the run.
        Run("Table I chunked", "de", 50,
            {**DE_TABLE1, "barrier_mode": "chunked"}, profile=False)),
    5: (Run("8 islands fused ring", "de", 100, {**DE_TABLE1, "fused": True},
            seed=1, n_islands=8),),
    # PSO, GA and SA at Table I's objective and width; then the paper's
    # Fig. 4 settings (benchmarks/fig4_pairwise.py) on rastrigin-1000.
    7: tuple(Run(f"{a} {'fused' if fz else 'unfused'} {POP} x {DIM}", a, 100,
                 {"fused": fz}) for a in ("pso", "ga", "sa") for fz in (True, False))
       + (Run(f"Fig. 4 ga pop 100 rastrigin-{DIM}", "ga", 30,
              {"pc": 0.7, "pm": 0.1}, fn="rastrigin", seed=1, pop=100, profile=False),
          Run(f"Fig. 4 sa pop 100 rastrigin-{DIM}", "sa", 30,
              {"schedule": "linear", "T0": 1000.0, "n_gens_hint": 1000 * DIM // 100},
              fn="rastrigin", seed=1, pop=100, profile=False),
          Run(f"Fig. 4 pso pop 10 rastrigin-{DIM}", "pso", 30,
              {"w": 0.6, "fp": 1.0, "fg": 1.0}, fn="rastrigin", seed=1, pop=10,
              profile=False)),
    # DGA: 8 GA islands with aging and starvation migration (the default
    # offspring wave, then the steady-state form, which starves); 8 PSO
    # islands with ring migration. Adoption runs on the card in both.
    8: (Run("8 islands ga fused starvation", "ga", 50, {**AGING, "fused": True},
            seed=2, n_islands=8, migration="starvation"),
        Run("8 islands ga fused starvation, steady state", "ga", 50,
            {**STARVING, "fused": True}, seed=2, n_islands=8,
            migration="starvation", profile=False, adopts=True),
        Run("8 islands pso fused ring", "pso", 50, {"fused": True}, seed=2,
            n_islands=8, adopts=True)),
    # The remaining engines at Table I's objective and width; then 8 EA
    # islands with ring migration, which must adopt migrants.
    13: (Run(f"ea {POP} x {DIM}", "ea", 30),
         Run(f"fa {POP} x {DIM}", "fa", 20, FA_WIDE),
         Run(f"bh {POP} x {DIM}", "bh", 20, BH_WIDE),
         Run(f"mc {POP} x {DIM}", "mc", 30),
         Run("8 islands ea ring", "ea", 30, seed=3, n_islands=8, adopts=True)),
}

# The polish defaults of optim.descent.PolishConfig that set batch shapes.
N_LADDER = 8
# Table I's hybrid (configs/popt_bench.py HYBRID_CONFIG, checked against the
# port's copy in phase 15): chunked DE with asd polish of the top 2 every 8
# rounds, 2 steps; 8 rounds, so one polish event fires. Then
# explore_then_polish's stage 2 (its default, 12 asd steps) on the incumbent.
HYBRID_POLISH = {"polish": "asd", "polish_every": 8, "polish_topk": 2, "polish_steps": 2}
HYBRID_RUN = Run("Table I hybrid", "de", 80, {**DE_TABLE1, "barrier_mode": "chunked"},
                 profile=False, polish=HYBRID_POLISH)
STAGE2_STEPS = 12

# Small runs on the card against the same runs on the CPU: DE (phase 6;
# pop 60 makes chunks of 7 rows, so the ninth chunk is clamped onto the
# eighth) and PSO, GA (steady-state aging, starvation) and SA (phase 9).
CARD_VS_CPU_RUNS = {
    6: tuple(Run(f"de ring {mode}", "de", 40, {**DE_TABLE1, **extra}, seed=11,
                 n_islands=4, pop=60, dim=100)
             for mode, extra in (("fused", {"fused": True}),
                                 ("sync", {"barrier_mode": "sync"}),
                                 ("chunked", {"barrier_mode": "chunked"}))),
    9: tuple(Run(f"{a} {mig} {'fused' if fz else 'unfused'}", a, 40,
                 {**extra, "fused": fz}, seed=11, n_islands=4, pop=64, dim=100,
                 migration=mig, sync_every=sync, adopts=a != "sa")
             for a, mig, extra, sync in (("pso", "ring", {}, SYNC_EVERY),
                                         ("ga", "starvation", STARVING, 2),
                                         ("sa", "ring", {}, SYNC_EVERY))
             for fz in (True, False)),
    # Phase 14: EA, FA, BH and MC; DE with each polish method, polishing the
    # top 2 of each island every 2 rounds, 2 steps.
    14: tuple(Run(f"{a} ring", a, 40, FA_WIDE if a == "fa" else {}, seed=11,
                  n_islands=4, pop=64, dim=100, adopts=True)
              for a in ("ea", "fa", "bh", "mc"))
        + tuple(Run(f"de ring, {m} polish", "de", 40, {**DE_TABLE1}, seed=11,
                    n_islands=4, pop=64, dim=100,
                    polish={"polish": m, "polish_every": 2, "polish_topk": 2,
                            "polish_steps": 2})
                for m in ("asd", "fcg", "avd", "bfgs")),
}

FUSED_KERNEL = {"de": "de_step", "pso": "pso_step", "ga": "ga_step",
                "sa": "eval_select"}

# Phase 16: the multi-job service at Table I's width (shifted Rosenbrock-1000,
# pop 800, 1 island, sync_every 10, the pallas backend), as OptRequest dicts.
# A: fused DE, 6 rounds (800 + 6 x 10 x 800 evaluations); B: fused PSO, 10
# rounds; C: HYBRID_CONFIG's chunked DE with its polish, which fires every 2
# rounds here (HYBRID_CONFIG: 8), 2 rounds and so one polish event (800 + 2
# x 10 x 800 + 2 x 2 x 4,008). A's and C's depth is cut (from 10 and 8
# rounds) to keep the script inside its time limit; every check stays.
SERVICE_POLISH = {**HYBRID_POLISH, "polish_every": 2}
SERVICE_BASE = {"fn": "shifted_rosenbrock", "dim": DIM, "pop": POP, "n_islands": 1,
                "sync_every": SYNC_EVERY, "backend": "pallas"}
SERVICE_BUCKETS = {
    "A": {**SERVICE_BASE, "algo": "de", "params": {**DE_TABLE1, "fused": True},
          "max_evals": 48_800},
    "B": {**SERVICE_BASE, "algo": "pso", "params": {"fused": True}, "max_evals": 80_800},
    "C": {**SERVICE_BASE, "algo": "de", "params": {**DE_TABLE1, "barrier_mode": "chunked"},
          **SERVICE_POLISH, "max_evals": 32_832},
}
SERVICE_JOBS = {"A": 8, "B": 4, "C": 2, "D": 2}
# The federation of phase 16: two workers on the card, two legs of
# FederationConfig's unfused DE (sync_every 5) at the same width, 50
# generations a leg: short for the script's time, which the workers'
# start-up dominates.
FED_EVALS = 40_800
FED_SYNC = 5
# A bucket of J one-island jobs launches what J islands do: the buckets of
# phase 16 (the killed and cancelled runs repeat A) and the federation's
# jobs, as runs of the tables above, for phase 1's shape list.
SERVICE_RUNS = (
    Run("16 A", "de", 60, SERVICE_BUCKETS["A"]["params"], n_islands=SERVICE_JOBS["A"]),
    Run("16 A, one job", "de", 60, SERVICE_BUCKETS["A"]["params"]),
    Run("16 B", "pso", 100, SERVICE_BUCKETS["B"]["params"], n_islands=SERVICE_JOBS["B"]),
    Run("16 C", "de", 20, SERVICE_BUCKETS["C"]["params"], n_islands=SERVICE_JOBS["C"],
        polish=SERVICE_POLISH),
    Run("16 D", "de", 60, SERVICE_BUCKETS["A"]["params"], n_islands=SERVICE_JOBS["D"]),
    Run("16 F", "de", (FED_EVALS - POP) // POP, DE_TABLE1, sync_every=FED_SYNC),
)


# Phase 17: heterogeneous portfolio islands and async islands at Table I's
# width (shifted Rosenbrock-1000, pop 800, sync_every 10, ring).
# A: 8 islands, de, pso, sa, ga cycled (two islands each), every policy
# fused, the incumbent shared; in turns with phase 5's DE run. B: the
# homogeneous portfolio ("de",) on phase 5's run, which must equal it bit
# for bit. C: phase 5's run async at staleness 0 (bit-identical to the
# barrier run), then the straggler shape of benchmarks/distributed.py
# (island 0 on cadence 4, the rest every tick, staleness up to 4) for 10
# ticks, in turns with the barrier run, and its recorded schedule replayed.
PORTFOLIO = ("de", "pso", "sa", "ga")
PORTFOLIO_PARAMS = {"de": {**DE_TABLE1, "fused": True}, "pso": {"fused": True},
                    "sa": {"fused": True}, "ga": {"fused": True}}
DE8 = MAIN_RUNS[5][0]
ASYNC = {"sync_policy": "async"}
MIXED_RUN = Run("8 islands mixed portfolio", "portfolio", 50, PORTFOLIO_PARAMS, seed=1,
                n_islands=8, portfolio=PORTFOLIO, share=True, adopts=True)
HOMOGENEOUS_RUN = dataclasses.replace(
    DE8, label="8 islands homogeneous de portfolio", algo="portfolio",
    params={"de": DE8.params}, portfolio=("de",), profile=False)
ASYNC0_RUN = dataclasses.replace(DE8, label="8 islands async, staleness 0",
                                 sync={**ASYNC, "max_staleness": 0}, profile=False)
STRAGGLER_RUN = dataclasses.replace(
    DE8, label="8 islands async straggler", sync={**ASYNC, "max_staleness": 4},
    schedule={"cadences": (4, 1, 1, 1, 1, 1, 1, 1)}, profile=False)
# D, card against CPU: benchmarks/portfolio.py's default cell (rastrigin-12,
# pop 32, 6 islands of de, pso, sa, sync_every 5, ring, shared incumbent,
# 24,000 evaluations, SA by _sa_params with T0 5.0 and step_frac 0.02; 9
# seeds through minimize_many, unfused), and phase 6's small fused DE and a
# fused mixed portfolio, async under a seeded random schedule.
PORTFOLIO_CELL = {"fn": "rastrigin", "dim": 12, "pop": 32, "n_islands": 6,
                  "sync_every": 5, "budget": 24_000, "seeds": 9,
                  "portfolio": ("de", "pso", "sa"), "sa_t0": 5.0, "sa_step_frac": 0.02}
CELL_RUNS = tuple(
    Run(f"17 D cell {a or 'portfolio'}", a or "portfolio", 0, fn="rastrigin",
        pop=PORTFOLIO_CELL["pop"], dim=PORTFOLIO_CELL["dim"],
        n_islands=PORTFOLIO_CELL["n_islands"], sync_every=PORTFOLIO_CELL["sync_every"],
        portfolio=() if a else PORTFOLIO_CELL["portfolio"], jobs=PORTFOLIO_CELL["seeds"])
    for a in (None, *PORTFOLIO_CELL["portfolio"]))
ASYNC_CARD_VS_CPU = (
    Run("de async, seeded schedule", "de", 40, {**DE_TABLE1, "fused": True}, seed=11,
        n_islands=4, pop=60, dim=100, sync={**ASYNC, "max_staleness": 2},
        schedule={"seed": 0}),
    Run("mixed portfolio async, seeded schedule", "portfolio", 40, PORTFOLIO_PARAMS,
        seed=11, n_islands=8, pop=64, dim=100, portfolio=PORTFOLIO, share=True,
        sync={**ASYNC, "max_staleness": 2}, schedule={"seed": 0}),
)
# E, the service: a portfolio bucket (3 jobs of A's configuration cut to 2
# rounds: 6,400 + 2 x 10 x 5,200 evaluations) and an async bucket (3 jobs of
# phase 5's, 2 rounds); every job equal to its standalone minimize.
SERVICE17 = {
    "portfolio": {**SERVICE_BASE, "n_islands": 8, "portfolio": list(PORTFOLIO),
                  "params": PORTFOLIO_PARAMS, "share_incumbent": True,
                  "max_evals": 8 * POP + 2 * SYNC_EVERY * 2 * (3 * POP + POP // 4)},
    "async": {**SERVICE_BASE, "n_islands": 8, "algo": "de",
              "params": {**DE_TABLE1, "fused": True}, **ASYNC, "max_staleness": 2,
              "max_evals": 8 * POP + 2 * SYNC_EVERY * 8 * POP},
}
SERVICE17_JOBS = 3
PORTFOLIO_RUNS = {17: (
    MIXED_RUN, HOMOGENEOUS_RUN, ASYNC0_RUN, STRAGGLER_RUN, *CELL_RUNS, *ASYNC_CARD_VS_CPU,
    dataclasses.replace(MIXED_RUN, label="17 E portfolio", jobs=SERVICE17_JOBS),
    dataclasses.replace(DE8, label="17 E async", sync={**ASYNC, "max_staleness": 2},
                        jobs=SERVICE17_JOBS))}


# Phase 18: islands over ranks (core/mesh.py), each rank a process. A: phase
# 5's run on a 1-rank nccl mesh, in turns with the unsharded run; B: the same
# run over 2 and 4 ranks; C: the steady-state GA of phase 8 (starvation: the
# all-gather path) over 4 ranks, phase 17's mixed portfolio and straggler
# over 2, and 3 jobs of phase 5's run through minimize_many over 2; each
# bit-identical to its unsharded run. C runs at MESH_GENS generations.
MESH_GENS = 30
GA_STEADY = dataclasses.replace(MAIN_RUNS[8][1], gens=MESH_GENS, profile=False)
MIXED18 = dataclasses.replace(MIXED_RUN, gens=MESH_GENS, profile=False)
STRAGGLER18 = dataclasses.replace(STRAGGLER_RUN, gens=MESH_GENS)
MANY18 = dataclasses.replace(DE8, label="3 jobs of phase 5's run", gens=20, profile=False,
                             jobs=3)
# B's runs of DE8 also count every device launch per generation on each
# rank (torch.profiler, about 20 s a spawn); A's need not.
DE8_A = dataclasses.replace(DE8, profile=False)
MESH_RUNS = {1: (DE8_A,), 2: (DE8, MIXED18, STRAGGLER18, MANY18), 4: (DE8, GA_STEADY)}
# A rank holds n_islands / ranks islands of every job: the shapes it
# launches are those of a run with that many islands (phase 1's list).
MESH_SHAPE_RUNS = tuple(dataclasses.replace(r, n_islands=r.n_islands // n)
                        for n, runs in MESH_RUNS.items() for r in runs)
# D: one devices: 2 request (8 fused DE islands, 2 rounds) through the
# scheduler beside the same request at devices: 1, and one the host cannot
# place; E: distributed_map_reduce of an elementwise square over 2 ranks.
SERVICE18 = {**SERVICE_BASE, "n_islands": 8, "algo": "de",
             "params": {**DE_TABLE1, "fused": True},
             "max_evals": 8 * POP + 2 * SYNC_EVERY * 8 * POP}
MAP_REDUCE_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class ModelRun:
    """One drive of the model serving path: ``entry`` "prefill" is
    ``make_prefill_step`` on a (batch, seq) prompt; "serve" is
    ``launch.serve.serve``, which fills the cache with a seq-token prompt
    and decodes ``decode_steps`` tokens greedily; "steps" is
    ``launch.steps``' cache-filling prefill of ``seq`` frame embeddings and
    ``decode_steps`` decode steps on further frames (the audio frontend,
    which ``serve`` refuses). Weights come from ``init_params(PRNGKey(0))``,
    at full width, with ``n_layers`` layers (0: the config's full depth),
    ``param_dtype`` parameters and ``compute_dtype`` activations. The audio
    frontend's prompt is ``seq`` frame embeddings; ``embeds`` puts that
    many patch embeddings in front of a VLM's ``seq`` tokens."""

    label: str
    arch: str
    entry: str
    batch: int
    seq: int
    decode_steps: int = 0
    n_layers: int = 0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    embeds: int = 0


# The kernels of each architecture's prefill; the cache-filling prefill of a
# recurrent arch steps through the prompt token by token and launches no
# ssd_scan (zamba2's shared attention launches flash once per application
# at its first token).
MODEL_KERNEL = {"llama3.2-1b": ("flash_attention",), "mamba2-370m": ("ssd_scan",),
                "granite-3-8b": ("flash_attention",), "gemma-7b": ("flash_attention",),
                "gemma2-9b": ("flash_attention",),
                "zamba2-7b": ("ssd_scan", "flash_attention"),
                "qwen2-moe-a2.7b": ("flash_attention",),
                "llama4-scout-17b-a16e": ("flash_attention",),
                "internvl2-2b": ("flash_attention",), "musicgen-medium": ("flash_attention",)}
MOE_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")

# The model serving path at full width, bf16: phases 10-11 at full depth;
# phase 19 at a quarter of it (granite-3-8b 10 of 40 layers, gemma-7b 7 of
# 28, gemma2-9b 12 of 42, 6 local and 6 global, zamba2-7b 24 of 81 with 4
# shared-attention applications), which makes room in the script's time
# for phases 21-22 (each layer of an arch runs the same code at the same
# shapes). gemma2-9b's 6144-token prompt is longer than its 4096 window,
# so its local layers mask differently from its global ones.
PHASE19_DEPTH = {"granite-3-8b": 10, "gemma-7b": 7, "gemma2-9b": 12, "zamba2-7b": 24}
MODEL_RUNS = {
    10: (ModelRun("llama3.2-1b serve", "llama3.2-1b", "serve", 4, 2048, 32),
         ModelRun("llama3.2-1b prefill", "llama3.2-1b", "prefill", 1, 4096)),
    11: (ModelRun("mamba2-370m prefill", "mamba2-370m", "prefill", 4, 2048),
         ModelRun("mamba2-370m serve", "mamba2-370m", "serve", 4, 64, 32)),
    19: tuple(ModelRun(f"{arch} {entry}", arch, entry, batch, seq, steps,
                       n_layers=PHASE19_DEPTH[arch])
              for arch, entry, batch, seq, steps in (
                  ("granite-3-8b", "serve", 4, 2048, 16), ("gemma-7b", "serve", 4, 2048, 16),
                  ("gemma2-9b", "serve", 1, 6144, 16), ("gemma2-9b", "prefill", 2, 4096, 0),
                  ("zamba2-7b", "prefill", 2, 2048, 0), ("zamba2-7b", "serve", 2, 64, 16))),
    # MoE serving with bfloat16 parameters (qwen2-moe's 14.3 G in float32
    # and their bf16 copy would not fit the card; llama4-scout's 48
    # layers are 216 GB in bf16, so 8 of them at full width), and the two
    # stub frontends at full size: internvl2's 256 patch embeddings (width
    # 1024) in front of 2048 tokens, musicgen's 2048 frame embeddings
    # (width 1536) through launch.steps.
    21: (ModelRun("qwen2-moe-a2.7b serve", "qwen2-moe-a2.7b", "serve", 4, 2048, 16,
                  param_dtype="bfloat16"),
         ModelRun("qwen2-moe-a2.7b prefill", "qwen2-moe-a2.7b", "prefill", 4, 2048,
                  param_dtype="bfloat16"),
         ModelRun("llama4-scout-17b-a16e serve, 8 layers", "llama4-scout-17b-a16e", "serve",
                  4, 2048, 16, n_layers=8, param_dtype="bfloat16"),
         ModelRun("internvl2-2b prefill, 256 patches", "internvl2-2b", "prefill", 4, 2048,
                  embeds=256),
         ModelRun("internvl2-2b serve", "internvl2-2b", "serve", 4, 2048, 16),
         ModelRun("musicgen-medium prefill", "musicgen-medium", "prefill", 4, 2048),
         ModelRun("musicgen-medium steps", "musicgen-medium", "steps", 4, 2048, 16)),
}
# Full width, 2 layers, float32 and bfloat16: the card with its kernels
# against the plain path on the CPU, on the same weights (phase 12).
# Mamba2's prefill spans two 256-token chunks.
CARD_VS_CPU_MODEL_RUNS = {
    12: (ModelRun("llama3.2-1b prefill, 2 layers, f32", "llama3.2-1b", "prefill", 2, 256,
                  n_layers=2, compute_dtype="float32"),
         ModelRun("llama3.2-1b serve, 2 layers, f32", "llama3.2-1b", "serve", 2, 256, 8,
                  n_layers=2, compute_dtype="float32"),
         ModelRun("mamba2-370m prefill, 2 layers, f32", "mamba2-370m", "prefill", 2, 512,
                  n_layers=2, compute_dtype="float32"),
         ModelRun("mamba2-370m serve, 2 layers, f32", "mamba2-370m", "serve", 2, 64, 8,
                  n_layers=2, compute_dtype="float32"),
         ModelRun("llama3.2-1b prefill, 2 layers, bf16", "llama3.2-1b", "prefill", 2, 256,
                  n_layers=2),
         ModelRun("llama3.2-1b serve, 2 layers, bf16", "llama3.2-1b", "serve", 2, 256, 8,
                  n_layers=2),
         ModelRun("mamba2-370m prefill, 2 layers, bf16", "mamba2-370m", "prefill", 2, 512,
                  n_layers=2),
         ModelRun("mamba2-370m serve, 2 layers, bf16", "mamba2-370m", "serve", 2, 64, 8,
                  n_layers=2)),
    # The four archs of phase 19 at full width: 2 layers (gemma2-9b: one
    # local, one global), 6 for zamba2-7b (one shared attention
    # application), in float32 and bfloat16, one arch at a time (its weights
    # drawn once on the card and copied to the CPU). The attention archs'
    # prompts are 128 tokens (256 until the training phases needed the
    # script's time: the CPU's bf16 products bound the phase; phase 1
    # still checks flash at the 256-token shapes, PHASE20_FLASH_SEQ); zamba2's
    # prefill spans two 256-token chunks; its serve prompt is stepped
    # through token by token, 16 tokens (every token runs the same
    # launches, and the CPU steps each through all 6 layers at full width).
    20: tuple(ModelRun(f"{arch} {entry}, {n} layers, {label}", arch, entry, 2,
                       (512 if arch == "zamba2-7b" else 128) if entry == "prefill"
                       else (16 if arch == "zamba2-7b" else 128),
                       0 if entry == "prefill" else 8, n_layers=n, compute_dtype=dtype)
              for arch, n in (("granite-3-8b", 2), ("gemma-7b", 2), ("gemma2-9b", 2),
                              ("zamba2-7b", 6))
              for dtype, label in (("float32", "f32"), ("bfloat16", "bf16"))
              for entry in ("prefill", "serve")),
    # The four archs of phase 21 at full width, 2 layers (llama4-scout 1:
    # 4.3 G parameters, its CPU copy 17 GB in float32), in float32 and in
    # bfloat16 (the MoE archs with bfloat16 parameters, as phase 21 runs
    # them): prefill 2 x 256 (internvl2 behind 256 patches), serve with 8
    # greedy steps teacher-forced (musicgen: launch.steps on frames).
    22: tuple(ModelRun(f"{arch} {entry}, {n} layers, {label}", arch,
                       "steps" if entry == "serve" and arch == "musicgen-medium" else entry,
                       2, 256, 0 if entry == "prefill" else 8, n_layers=n,
                       compute_dtype=dtype,
                       param_dtype=dtype if arch in MOE_ARCHS else "float32",
                       embeds=256 if arch == "internvl2-2b" and entry == "prefill" else 0)
              for arch, n in (("qwen2-moe-a2.7b", 2), ("llama4-scout-17b-a16e", 1),
                              ("internvl2-2b", 2), ("musicgen-medium", 2))
              for dtype, label in (("float32", "f32"), ("bfloat16", "bf16"))
              for entry in ("prefill", "serve")),
}


def _chunks(pop: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of chunked DE's 8 chunks: the last chunk is
    clamped onto the one before when the size does not divide pop."""
    csz = max(1, pop // 8)
    return csz, -(-pop // csz)


def _eval_calls(algo: str, pop: int, params: dict) -> tuple[int, int]:
    """(rows per evaluator call, calls per generation) of one island: GA's
    offspring wave, chunked DE's chunks, EA's lambda offspring, BH's kick and
    its n_ls probes; one call of the population otherwise."""
    if algo == "ga":
        return params.get("n_offspring") or max(1, pop // 4), 1
    if algo == "de" and params.get("barrier_mode") == "chunked":
        return _chunks(pop)
    if algo == "ea":
        return params.get("lam") or pop, 1
    if algo == "bh":
        return pop, 1 + params.get("n_ls", 5)
    return pop, 1


def _evals_per_gen(algo: str, pop: int, params: dict) -> int:
    """Evaluations one generation charges (the engine's evals_per_gen)."""
    rows, calls = _eval_calls(algo, pop, params)
    return rows * calls


def _polish_batches(r: Run, points: int, steps: int) -> list[tuple[int, int]]:
    """(rows, D) of each evaluator call of one polish of ``points`` points:
    per step, a gradient's 4·D probes each and a ladder of N_LADDER steps
    each, or AVD's ±ladder on every coordinate (optim.descent.make_polish)."""
    D = r.dim
    if r.polish["polish"] == "avd":
        return [(points * D * 2 * N_LADDER, D)] * steps
    return [(points * 4 * D, D), (points * N_LADDER, D)] * steps


def _polish_events(r: Run, gens: int) -> int:
    if not r.polish:
        return 0
    return gens // r.sync_every // r.polish["polish_every"]


def _event_batches(r: Run) -> list[tuple[int, int]]:
    """The evaluator calls of one in-run polish event: every island's top-k
    in one batch."""
    k = min(r.polish["polish_topk"], r.pop)
    return _polish_batches(r, r.n_islands * k, r.polish["polish_steps"])


def _polish_per_point(r: Run, steps: int) -> int:
    """Evaluations one polished point costs (polish_evals_per_point)."""
    D = r.dim
    if r.polish["polish"] == "avd":
        return steps * 2 * D * N_LADDER
    return steps * (4 * D + N_LADDER)


def _groups(r: Run) -> list[tuple[str, dict, int]]:
    """(policy, its params, islands) of each group of islands one call
    steps: the run's one policy over all its islands, or each distinct
    policy of a portfolio (islands cycled as ``portfolio.expand`` cycles
    them, a group per policy in order of first appearance); every island of
    every job of a bucket."""
    if not r.portfolio:
        return [(r.algo, r.params, r.n_islands * r.jobs)]
    names = [r.portfolio[i % len(r.portfolio)] for i in range(r.n_islands)]
    return [(a, r.params.get(a, {}), names.count(a) * r.jobs) for a in dict.fromkeys(names)]


def launch_shapes(r: Run) -> dict[str, set[tuple[int, ...]]]:
    """The shapes run ``r`` launches each kernel at, for each group of
    islands (see _groups): bench_eval on the flattened ``(islands * rows,
    D)`` batch the executor evaluates (init; unfused, every generation's
    batch or chunk; every polish batch); a fused kernel on the
    island-stacked ``(I, rows, D)`` state, also for one island."""
    P, D = r.pop, r.dim
    out = {"bench_eval": set()}
    for algo, params, n in _groups(r):
        out["bench_eval"].add((n * P, D))
        if params.get("fused"):
            out.setdefault(FUSED_KERNEL[algo], set()).add(
                (n, _evals_per_gen(algo, P, params), D))
        else:
            out["bench_eval"].add((n * _eval_calls(algo, P, params)[0], D))
    if r.polish:
        out["bench_eval"].update(_event_batches(r))
    if r is HYBRID_RUN:
        out["bench_eval"].update(_polish_batches(r, 1, STAGE2_STEPS))
    return out


def _all_runs():
    for table in (MAIN_RUNS, CARD_VS_CPU_RUNS, {15: (HYBRID_RUN,), 16: SERVICE_RUNS},
                  PORTFOLIO_RUNS, {18: MESH_SHAPE_RUNS}):
        for runs in table.values():
            yield from runs


def service_eval_shapes() -> set[tuple[int, int]]:
    """bench_eval's shapes in phase 16 beyond its runs' own: bucket D's warm
    rows (A's incumbents) and the federation's one routed row, and stage 2
    of explore_then_polish_many on bucket C's incumbents."""
    c_run = SERVICE_RUNS[3]
    return ({(SERVICE_JOBS["A"], DIM), (1, DIM)}
            | set(_polish_batches(c_run, SERVICE_JOBS["C"], STAGE2_STEPS)))


def _derived(kernels) -> tuple[tuple[int, ...], ...]:
    return tuple(sorted({s for r in _all_runs() for k, shapes in launch_shapes(r).items()
                         if k in kernels for s in shapes}))


# Shapes phase 1 checks each kernel at against its plain version: every
# shape a run of the tables above launches it at, plus Table I's rows as a
# plain (P, D) tensor and odd sizes. The fused-generation kernels share one
# list (GA's 200-row wave at pop 800 among them, and DE_EXTRA_SHAPES), and
# a row view at a storage offset is added at (800, 1000), unaligned views
# at (800, 1000) and (200, 1000).
EVAL_SHAPES = tuple(sorted(set(_derived({"bench_eval"})) | service_eval_shapes()
                           | {(130, 1000), (37, 100), (5, 1), (128_000, 100)}))
DE_SHAPES = _derived({"de_step"})
# Rows past eval_row.cuh's staging cap (4096 lanes of 16-byte slots, 1024
# of scalar ones), which de_step, ga_step and eval_select walk in two
# passes, and D = 1001.
DE_EXTRA_SHAPES = ((16, 4100), (16, 1027), (100, 1001))
FUSED_SHAPES = tuple(sorted(set(_derived({"eval_select", "pso_step", "ga_step"}))
                            | {(800, 1000), (200, 1000), (130, 1000), (37, 100),
                               (5, 1), (8, 800, 1000), *DE_EXTRA_SHAPES}))

PALLAS_SITES = {
    "bench_eval": "src/repro/kernels/bench_eval.py:136",
    "de_step": "src/repro/kernels/de_step.py:85",
    "eval_select": "src/repro/kernels/eval_select.py:86",
    "pso_step": "src/repro/kernels/pso_step.py:98",
    "ga_step": "src/repro/kernels/ga_step.py:98",
    "flash_attention": "src/repro/kernels/flash_attention.py:99",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:72",
}
# The port's two backward kernels (no TPU kernel: the JAX package has no
# backward kernel) and the forward kernel whose gradient each computes.
GRADIENT_OF = {"flash_attention_bwd": "flash_attention", "ssd_scan_bwd": "ssd_scan"}
KERNELS = (*PALLAS_SITES, *GRADIENT_OF)
POP_KERNELS = KERNELS[:5]      # the population kernels of phases 1-9
# The kernels whose bfloat16 route runs on the tensor cores: the library it
# builds, and the tensor-core instructions that library's SASS must hold
# (the flash kernels wgmma, HGMMA; the SSD kernels HGMMA or HMMA).
TC_LIBRARY = {"flash_attention": "flash_attention_tc", "ssd_scan": "ssd_scan_tc",
              "flash_attention_bwd": "flash_attention_bwd_tc",
              "ssd_scan_bwd": "ssd_scan_bwd_tc"}
TC_OPCODES = {"flash_attention": ("HGMMA",), "ssd_scan": ("HGMMA", "HMMA"),
              "flash_attention_bwd": ("HGMMA",), "ssd_scan_bwd": ("HGMMA", "HMMA")}


class PhaseFailed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


_LOG_LOCK = threading.Lock()


def log(msg: str) -> None:
    """One whole line to stdout (the second process's lines are relayed
    through here by a thread, so the lock keeps lines whole)."""
    with _LOG_LOCK:
        sys.stdout.write(msg + "\n")
        sys.stdout.flush()


def card_rates(name: str) -> dict[str, float]:
    if name not in CARD_RATES:
        raise PhaseFailed(f"no data-sheet rates for card {name!r}")
    return CARD_RATES[name]


def time_ms(fn, reps: int = 50, warmup: int = 3, spin: int = 200_000_000) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back runs, by CUDA
    events. A spin kernel of ``spin`` cycles (the default about 0.1 s)
    first holds the card while the host enqueues the runs, so the events
    time the device work and not the host's launch rate (a ctypes launch
    costs the host tens of microseconds)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_rounds(c: "Ctx", make_opt, f, seed: int, timed: int = 2,
                   profiled: int = 1) -> dict:
    """Device time by kernel and the device's idle share over the rounds of
    one run, init excluded. ``make_opt(gens, round_callback)`` builds the
    engine; its host-stepped driver synchronises once per round before the
    callback. Round 0 (which holds init) is skipped, the next ``timed``
    rounds are timed on the host clock, and the ``profiled`` rounds after
    them run under torch.profiler. The idle share compares the profiled
    rounds' device time per generation with the timed rounds' wall time per
    generation: the profiler slows the host, so its own wall is not used."""
    torch = c.torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def at_round_end(r, best_arg, best_val):
        if r == 0:
            marks["timed"] = time.perf_counter()
        elif r == timed:
            marks["profiled"] = time.perf_counter()
            prof.start()
        elif r == timed + profiled:
            prof.stop()
            marks["end"] = time.perf_counter()

    opt = make_opt((1 + timed + profiled) * SYNC_EVERY, at_round_end)
    every = opt.cfg.sync_every
    res = opt.minimize(f, c.rt.prng.PRNGKey(seed))
    require(res.n_gens == (1 + timed + profiled) * every,
            f"profiled run made {res.n_gens} generations")
    # key_averages() aggregates every recorded event: once, for both uses.
    averages = prof.key_averages()
    rows = []
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    gens = profiled * every
    busy_ms = sum(r[0] for r in rows) / 1e3 / gens
    wall_ms = (marks["profiled"] - marks["timed"]) * 1e3 / (timed * every)
    ours = {name: sum(t for t, k, _ in rows if f"{name}_" in k) / 1e3 / gens
            for name in KERNELS}
    # The row gathers and scatters of a portfolio's grouping (one device
    # launch each), counted as the host issued them.
    grouping = sum(e.count for e in averages
                   if e.key in ("aten::index_select", "aten::index_copy_")) / gens
    launches = sum(r[2] for r in rows) / gens
    return {"timed_gens": timed * every, "profiled_gens": gens,
            "wall_ms_per_gen": wall_ms,
            "profiled_wall_ms_per_gen": (marks["end"] - marks["profiled"]) * 1e3 / gens,
            "device_busy_ms_per_gen": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else None,
            "device_launches_per_gen": launches,
            "gather_scatter_launches_per_gen": grouping,
            "gather_scatter_share": grouping / launches if launches else None,
            "port_kernels_device_ms_per_gen": ours,
            "top": [{"name": k[:90], "device_ms": t / 1e3, "count": n}
                    for t, k, n in rows[:4]]}


class Ctx:
    """What the phases share: modules, device, and the per-kernel record.
    ``max_abs_err`` is the fitness error for bench_eval and the population
    (or slot-row) error for the generation kernels, whose fitness error is
    kept relative."""

    def __init__(self, torch, rt, dev: str = "cuda"):
        self.torch = torch
        self.rt = rt
        self.dev = torch.device(dev)
        self.kern = {k: {"launches": 0, "max_abs_err": 0.0, "max_rel_err": 0.0}
                     for k in KERNELS}
        self.phase = None     # the phase running now
        self.shapes = {}      # phase -> {(kernel, shape of its first input)}
        self.decided = {}     # kernel -> its take/accept outputs since reset

    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def err(self, name: str, got, want, absolute: bool = True) -> float:
        """Record |got - want|, relative to |want| + 1 (and absolute)."""
        d = (got.double() - want.double()).abs()
        if d.numel() == 0:
            return 0.0
        rel = float((d / (want.double().abs() + 1.0)).max())
        k = self.kern[name]
        if absolute:
            k["max_abs_err"] = max(k["max_abs_err"], float(d.max()))
        k["max_rel_err"] = max(k["max_rel_err"], rel)
        return rel

    def reset(self) -> None:
        self.decided = {}
        for k in KERNELS:
            getattr(self.rt, k).LAUNCHES = 0
        for k in POP_KERNELS:
            getattr(self.rt, k).BF16_LAUNCHES = 0
        for k in TC_LIBRARY:
            getattr(self.rt, k).TC_LAUNCHES = 0

    def counts(self) -> dict[str, int]:
        return {k: getattr(self.rt, k).LAUNCHES for k in KERNELS}

    def add_launches(self, counts: dict[str, int]) -> None:
        for k, v in counts.items():
            self.kern[k]["launches"] += v


# The launch argument holding each deciding kernel's take/accept output.
DECISION_ARG = {"ga_step": 11, "eval_select": 7}


def record_launch_shapes(c: Ctx) -> None:
    """Wrap the kernels' shared launch step so that every launch records
    its kernel and the shape and type of its first input under the running
    phase, and keeps the take/accept output of ga_step and eval_select
    (read after the run, so the run waits for nothing)."""
    b = c.rt._build
    launch = b.launch

    def recording(name, device, *args):
        first = args[0]
        c.shapes.setdefault(c.phase, set()).add(
            (name, tuple(first.shape), str(first.dtype).replace("torch.", "")))
        if name in DECISION_ARG:
            c.decided.setdefault(name, []).append(args[DECISION_ARG[name]])
        return launch(name, device, *args)

    b.launch = recording


def _uniform(torch, gen, shape, lo, hi, dev):
    return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev)


def port_modules() -> types.SimpleNamespace:
    """The port's modules the phases use, imported from ``src/``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.configs import popt_bench
    from repro_torch.core import (ALGORITHMS, AbandonRun, AsyncSchedule, ExecutorConfig,
                                  IslandConfig, IslandOptimizer, OptRequest,
                                  ShapeBucketScheduler, de, executor, explore_then_polish,
                                  explore_then_polish_many, mesh, migration)
    from repro_torch.launch.opt_serve import OptimizationService
    from repro_torch.optim import descent
    from repro_torch.functions import benchmarks as bm
    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, autotune, bench_eval, de_step, eval_select,
                                     flash_attention, flash_attention_bwd, ga_step,
                                     pso_step, ssd_scan, ssd_scan_bwd)
    from repro_torch import data
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import layers, transformer
    from repro_torch.optim import adam
    return types.SimpleNamespace(
        prng=prng, de=de, bm=bm, bench_eval=bench_eval, de_step=de_step,
        autotune=autotune, KernelConfig=autotune.KernelConfig,
        eval_select=eval_select, pso_step=pso_step, ga_step=ga_step,
        flash_attention=flash_attention, ssd_scan=ssd_scan,
        flash_attention_bwd=flash_attention_bwd, ssd_scan_bwd=ssd_scan_bwd,
        train=train, data=data, adam=adam,
        ALGORITHMS=ALGORITHMS, migration=migration, mesh=mesh, executor=executor,
        OptRequest=OptRequest,
        _build=_build, ExecutorConfig=ExecutorConfig, IslandConfig=IslandConfig,
        AsyncSchedule=AsyncSchedule,
        IslandOptimizer=IslandOptimizer, get_config=get_config, serve=serve,
        steps=steps, T=transformer, layers=layers, popt_bench=popt_bench, descent=descent,
        explore_then_polish=explore_then_polish,
        explore_then_polish_many=explore_then_polish_many, AbandonRun=AbandonRun,
        ShapeBucketScheduler=ShapeBucketScheduler, OptimizationService=OptimizationService)


def _check_eval(c: Ctx, pop, fn: str, shift, bias: float, label: str) -> None:
    """One bench_eval launch against the plain version on the same input."""
    be = c.rt.bench_eval
    got = be.bench_eval(pop, fn, shift, bias)
    want = be.bench_eval_ref(pop, fn, shift, bias)
    c.sync()
    rel = c.err("bench_eval", got, want)
    tol = 1e-4 if fn == "michalewicz" else 1e-5
    require(rel < tol, f"bench_eval {fn} {label} rel err {rel:.3g}")


def _eval_inputs(c: Ctx, gen, shape, lo, hi):
    """(label, tensor) pairs for one shape; at Table I's shape also rows
    100:200 of it, a view with a storage offset as the chunked path passes,
    and the same values one float past an aligned start (scalar loads)."""
    pop = _uniform(c.torch, gen, shape, lo, hi, c.dev)
    out = [(str(tuple(shape)), pop)]
    if tuple(shape) == (POP, DIM):
        view = pop[100:200]
        require(view.storage_offset() > 0, "row slice has no storage offset")
        out.append((f"rows 100:200 of {tuple(shape)}", view))
        shifted = _unaligned(c, pop)
        require(c.dev.type != "cuda" or not c.rt.bench_eval.tuned_geometry(
            "bench_eval", None, *shape, "sphere", shifted).vec,
            "a view one float past an aligned start took 16-byte loads")
        out.append((f"unaligned view of {tuple(shape)}", shifted))
    return out


def phase_kernels(c: Ctx) -> None:
    torch, rt = c.torch, c.rt
    be, ds, bm = rt.bench_eval, rt.de_step, rt.bm
    gen = torch.Generator().manual_seed(0)
    for fn in be.EVAL_TAGS:
        f = bm.FUNCTIONS.get(fn, bm.FUNCTIONS["rosenbrock"])
        lo, hi = max(f.lo, -5.0), min(f.hi, 5.0)
        for shape in EVAL_SHAPES:
            for label, pop in _eval_inputs(c, gen, shape, lo, hi):
                _check_eval(c, pop, fn, None, 0.0, label)
    shift = bm.shift_vector(DIM, device=c.dev)
    for shape in ((POP, DIM), (8 * POP, DIM)):
        for label, pop in _eval_inputs(c, gen, shape, -100.0, 100.0):
            _check_eval(c, pop, "shifted_rosenbrock", shift, 390.0, label)
    for shape in DE_EXTRA_SHAPES:
        for label, pop in _eval_inputs(c, gen, shape, -5.0, 5.0):
            _check_eval(c, pop, "rosenbrock", None, 0.0, label)
    log(f"phase 1: bench_eval 10 tags x {len(EVAL_SHAPES)} shapes + a row view and an "
        f"unaligned view, shifted at 800 and 6400 rows + both views, rosenbrock at "
        f"{DE_EXTRA_SHAPES}: max rel err {c.kern['bench_eval']['max_rel_err']:.3g}")

    cases = (("shifted_rosenbrock", (800, 1000)), ("rastrigin", (99, 333)),
             *(("shifted_rosenbrock", shape) for shape in DE_SHAPES + DE_EXTRA_SHAPES))
    for fn, shape in cases:
        *lead, D = shape
        P = lead[-1]
        shift = bm.shift_vector(D, device=c.dev) if fn == "shifted_rosenbrock" else None
        bias = 390.0 if shift is not None else 0.0
        lo, hi = (-100.0, 100.0) if shift is not None else (-5.12, 5.12)
        pop = _uniform(torch, gen, shape, lo, hi, c.dev)
        fit = be.bench_eval_ref(pop, fn, shift, bias)
        u = torch.rand(shape, generator=gen).to(c.dev)
        idx = ((torch.arange(P) + 1 + torch.randint(0, P - 1, (3, *lead), generator=gen))
               % P).to(c.dev)
        jr = torch.randint(0, D, tuple(lead), generator=gen).to(c.dev)
        args = (pop, fit, idx, u, jr, fn, shift, bias, 0.5, 0.2, lo, hi)
        npop, nfit = ds.de_step(*args)
        rpop, rfit = ds.de_step_ref(*args)
        trial = ds.trial_ref(pop, idx, u, jr, 0.5, 0.2, lo, hi)
        tfit = be.bench_eval_ref(trial, fn, shift, bias)
        c.sync()
        tol_f = 1e-5 * (fit.abs() + 1.0)
        clear = (tfit - fit).abs() > tol_f
        took_k = nfit != fit
        took_r = tfit <= fit
        agree = took_k == took_r
        require(bool(agree[clear].all()),
                f"de_step {shape}: selection differs on "
                f"{int((~agree & clear).sum())} clear rows")
        n_close = int((~agree).sum())
        pe = float((npop - rpop).abs()[agree].max())
        c.kern["de_step"]["max_abs_err"] = max(c.kern["de_step"]["max_abs_err"], pe)
        rel = c.err("de_step", nfit[agree], rfit[agree], absolute=False)
        require(pe < 1e-5, f"de_step {shape}: population abs err {pe:.3g}")
        require(rel < 1e-5, f"de_step {shape}: fitness rel err {rel:.3g}")
        log(f"phase 1: de_step {fn} {shape}: accepted {int(took_k.sum())}/"
            f"{took_k.numel()}, pop abs err {pe:.3g}, fit rel err {rel:.3g}, "
            f"near-tie rows deciding differently {n_close}")
    check_fused_kernels(c)
    check_nan_lanes(c)
    check_model_kernels(c)
    check_grad_kernels(c)


def _same(torch, a, b) -> bool:
    """Equal, NaN where NaN."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def check_nan_lanes(c: Ctx) -> None:
    """de_step and pso_step on a NaN lane at Table I's shape, against their
    plain versions (which clip as jnp.clip does): a DE trial row holding the
    NaN never wins and keeps its parent, no finite parent turns NaN; a NaN
    PSO velocity stays NaN with its position and fitness, and its personal
    best stays."""
    torch, rt = c.torch, c.rt
    be, ds, ps = rt.bench_eval, rt.de_step, rt.pso_step
    gen = torch.Generator().manual_seed(9)
    P, D, row, lane = POP, DIM, 5, 17
    shift = rt.bm.shift_vector(D, device=c.dev)
    pop = _uniform(torch, gen, (P, D), -100.0, 100.0, c.dev)
    pop[row, lane] = torch.nan
    u = torch.rand((P, D), generator=gen).to(c.dev)
    u[:, lane] = 0.0                      # every row crosses over at the NaN lane
    idx = ((torch.arange(P) + 1 + torch.randint(0, P - 1, (3, P), generator=gen)) % P)
    idx[1, :64] = row                     # 64 rows draw the NaN row as a donor
    idx[1, row] = row + 1
    idx = idx.to(c.dev)
    jr = torch.randint(0, D, (P,), generator=gen).to(c.dev)
    fit = be.bench_eval_ref(pop, "shifted_rosenbrock", shift, 390.0)
    fit = fit * (0.5 + torch.rand(P, generator=gen)).to(c.dev)
    args = (pop, fit, idx, u, jr, "shifted_rosenbrock", shift, 390.0, 0.5, 0.2, -100.0, 100.0)
    npop, nfit = ds.de_step(*args)
    rpop, rfit = ds.de_step_ref(*args)
    nan_trial = torch.isnan(ds.trial_ref(pop, idx, u, jr)).any(dim=-1)
    c.sync()
    require(int(nan_trial.sum()) >= 64 and _same(torch, npop[nan_trial], pop[nan_trial])
            and _same(torch, nfit[nan_trial], fit[nan_trial])
            and not bool(torch.isnan(nfit[~torch.isnan(fit)]).any()),
            "de_step: a NaN trial won, or a finite parent turned NaN")
    require(_same(torch, npop, rpop), "de_step NaN lane: population differs from plain")
    ok = ~torch.isnan(rfit)
    rel = c.err("de_step", nfit[ok], rfit[ok], absolute=False)
    require(_same(torch, torch.isnan(nfit), ~ok) and rel < 1e-5,
            f"de_step NaN lane: fitness rel err {rel:.3g}")
    x, pb = (_uniform(torch, gen, (P, D), -100.0, 100.0, c.dev) for _ in range(2))
    v = _uniform(torch, gen, (P, D), -20.0, 20.0, c.dev)
    v[row, lane] = torch.nan
    r1, r2 = (torch.rand((P, D), generator=gen).to(c.dev) for _ in range(2))
    pbf = be.bench_eval_ref(pb, "shifted_rosenbrock", shift, 390.0)
    g = pb[int(pbf.argmin())].contiguous()
    pargs = (x, v, pb, pbf, r1, r2, g, "shifted_rosenbrock", shift, 390.0, 0.6, 1.0, 1.0,
             40.0, -100.0, 100.0)
    got, want = ps.pso_step(*pargs), ps.pso_step_ref(*pargs)
    c.sync()
    require(all(_same(torch, got[k], want[k]) for k in (0, 1, 3)),
            "pso_step NaN lane: positions, velocities or pbest differ from plain")
    require(bool(torch.isnan(got[1][row, lane]) and torch.isnan(got[2][row]))
            and int(torch.isnan(got[2]).sum()) == 1 and float(got[4][row]) == float(pbf[row]),
            "pso_step: a NaN velocity lane did not stay NaN, or replaced a personal best")
    ok = ~torch.isnan(want[2])
    rel = c.err("pso_step", got[2][ok], want[2][ok], absolute=False)
    require(rel < FUSED_TOL, f"pso_step NaN lane: fitness rel err {rel:.3g}")
    log(f"phase 1: NaN lane at {(P, D)}: de_step kept the parent of all "
        f"{int(nan_trial.sum())} NaN trials, pso_step kept the NaN velocity, both as plain")


# Bound of tests/test_kernels.py for the fused-generation kernels:
# max |a - b| / (|b| + 1), and the margin a decision must clear to count.
FUSED_TOL = 1e-4


def _clear(torch, cand, comp):
    """Rows whose candidate value is clear of its comparand by FUSED_TOL
    (an infinite comparand is always clear)."""
    d = (cand.double() - comp.double()).abs()
    return (d > FUSED_TOL * (comp.double().abs() + 1.0)) | ~torch.isfinite(comp)


def _decide(c: Ctx, name: str, label: str, got, want, clear) -> int:
    """Decisions identical on clear rows; returns the near-tie rows that
    decided differently."""
    agree = got == want
    require(bool(agree[clear].all()),
            f"{name} {label}: decisions differ on {int((~agree & clear).sum())} clear rows")
    return int((~agree).sum())


def _fused_case(c: Ctx, gen, fn: str, shape):
    """Inputs on the card for one tag and shape: (shift, bias, lo, hi, U)
    where U(*shape, lo=, hi=) draws uniforms in the box."""
    torch, bm = c.torch, c.rt.bm
    D = shape[-1]
    if fn == "shifted_rosenbrock":
        shift, bias, lo, hi = bm.shift_vector(D, device=c.dev), 390.0, -100.0, 100.0
    else:
        f = bm.FUNCTIONS[fn]
        shift, bias, lo, hi = None, 0.0, max(f.lo, -5.0), min(f.hi, 5.0)

    def U(*sh, lo=lo, hi=hi):
        return torch.rand(sh, generator=gen, device=c.dev) * (hi - lo) + lo

    return shift, bias, lo, hi, U


def _unaligned(c: Ctx, a):
    """A copy of ``a`` one float past an aligned start (every row pointer
    4-byte aligned only)."""
    flat = c.torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = flat[1:].view(a.shape)
    view.copy_(a)
    return view


def _views(c: Ctx, shape, arrays, name: str):
    """(label, arrays) to check for kernel ``name``: the arrays; at Table
    I's shape also rows 100:300 of each (at pop 800), views with a storage
    offset; and at Table I's shape and GA's 200-row wave, the row arrays as
    unaligned views (scalar slots in the kernels on eval_row.cuh)."""
    out = [(str(tuple(shape)), arrays)]
    if tuple(shape) == (POP, DIM):
        rows = slice(POP // 8, 3 * POP // 8)
        view = [a[rows] if a.dim() and a.shape[0] == POP else a for a in arrays]
        require(view[0].storage_offset() > 0, "row slice has no storage offset")
        out.append((f"rows {rows.start}:{rows.stop} of {tuple(shape)}", view))
    if tuple(shape) in ((POP, DIM), (POP // 4, DIM)):
        moved = [_unaligned(c, a) if tuple(a.shape) == tuple(shape) else a for a in arrays]
        require(c.dev.type != "cuda" or name == "pso_step" or not c.rt.bench_eval.tuned_geometry(
            name, None, *shape, "sphere", moved[0]).vec, f"{name}: an unaligned view took 16-byte loads")
        out.append((f"unaligned views of {tuple(shape)}", moved))
    return out


def check_fused_kernels(c: Ctx) -> None:
    """eval_select, pso_step and ga_step against their plain versions on
    the card: every tag at FUSED_SHAPES, plus a row view and unaligned
    views. Decisions must be identical on clear rows; positions,
    velocities and placed children carry no evaluation and must be
    bit-exact."""
    torch, rt = c.torch, c.rt
    be, es, ps, gs = rt.bench_eval, rt.eval_select, rt.pso_step, rt.ga_step
    gen = torch.Generator(device=c.dev).manual_seed(5)
    near = {k: 0 for k in ("eval_select", "pso_step", "ga_step")}
    for fn in be.EVAL_TAGS:
        for shape in FUSED_SHAPES:
            shift, bias, lo, hi, U = _fused_case(c, gen, fn, shape)
            lead = shape[:-1]
            # eval_select, Metropolis thresholds; one u = 0 (threshold +inf)
            pop, trial = U(*shape), U(*shape)
            fit = be.bench_eval_ref(pop, fn, shift, bias)
            dF = be.bench_eval_ref(trial, fn, shift, bias) - fit
            u = torch.rand(lead, generator=gen, device=c.dev)
            u.view(-1)[0] = 0.0
            th = -(0.5 * dF.abs().median()) * torch.log(u)
            for label, (a, b, d, t, fa) in _views(c, shape, (pop, trial, dF, th, fit), "eval_select"):
                got = es.eval_select(a, fa, b, t, fn, shift, bias)
                want = es.eval_select_ref(a, fa, b, t, fn, shift, bias)
                c.sync()
                clear = (_clear(torch, d + fa, fa)
                         & (_clear(torch, d, t) | ~torch.isfinite(t)))
                near["eval_select"] += _decide(c, "eval_select", f"{fn} {label}",
                                               got[2], want[2], clear)
                same = got[2] == want[2]
                require(label.startswith("rows") or bool(got[2].view(-1)[0]),
                        f"eval_select {fn} {label}: u = 0 did not accept")
                pe = float((got[0] - want[0]).abs()[same].max()) if same.any() else 0.0
                rel = c.err("eval_select", got[1][same], want[1][same], absolute=False)
                c.kern["eval_select"]["max_abs_err"] = max(c.kern["eval_select"]["max_abs_err"], pe)
                require(pe == 0.0 and rel < FUSED_TOL,
                        f"eval_select {fn} {label}: pop err {pe:.3g}, fit rel err {rel:.3g}")
            # pso_step
            x, pb = U(*shape), U(*shape)
            v = U(*shape, lo=-0.1 * (hi - lo), hi=0.1 * (hi - lo))
            r1 = torch.rand(shape, generator=gen, device=c.dev)
            r2 = torch.rand(shape, generator=gen, device=c.dev)
            pbf = be.bench_eval_ref(pb, fn, shift, bias)
            g = torch.gather(pb, -2, pbf.argmin(-1)[..., None, None].expand(
                *lead[:-1], 1, shape[-1])).squeeze(-2).contiguous()
            kw = dict(w=0.6, fp=1.0, fg=1.0, vmax=0.2 * (hi - lo), lo=lo, hi=hi)
            for label, (a, vv, p_, f_, q1, q2) in _views(c, shape, (x, v, pb, pbf, r1, r2), "pso_step"):
                args = (a, vv, p_, f_, q1, q2, g, fn, shift, bias)
                got = ps.pso_step(*args, **kw)
                want = ps.pso_step_ref(*args, **kw)
                c.sync()
                require(bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
                        f"pso_step {fn} {label}: positions or velocities differ")
                rel = c.err("pso_step", got[2], want[2], absolute=False)
                c.kern["pso_step"]["max_abs_err"] = max(
                    c.kern["pso_step"]["max_abs_err"], float((got[0] - want[0]).abs().max()))
                near["pso_step"] += _decide(c, "pso_step", f"{fn} {label}", got[4] != f_,
                                            want[4] != f_, _clear(torch, want[2], f_))
                require(rel < FUSED_TOL, f"pso_step {fn} {label}: fit rel err {rel:.3g}")
            # ga_step, two dead slots per island
            p1, p2, slot = U(*shape), U(*shape), U(*shape)
            slot_f = be.bench_eval_ref(slot, fn, shift, bias)
            slot_f[..., :2] = torch.inf
            cut = torch.randint(1, max(shape[-1], 2), lead, generator=gen, device=c.dev)
            co = torch.rand(lead, generator=gen, device=c.dev)
            um = torch.rand(shape, generator=gen, device=c.dev)
            nz = torch.randn(shape, generator=gen, device=c.dev)
            kw = dict(pc=0.7, pm=0.1, sigma_m=0.1 * (hi - lo), lo=lo, hi=hi)
            for label, arrs in _views(c, shape, (p1, p2, slot, slot_f, cut, co, um, nz), "ga_step"):
                got = gs.ga_step(*arrs, fn, shift, bias, **kw)
                want = gs.ga_step_ref(*arrs, fn, shift, bias, **kw)
                child = gs.crossover(arrs[0], arrs[1], arrs[4], arrs[5], kw["pc"])
                child = torch.clamp(child + torch.where(arrs[6] < kw["pm"], kw["sigma_m"] * arrs[7], 0.0),
                                    lo, hi)
                cfit = be.bench_eval_ref(child, fn, shift, bias)
                c.sync()
                near["ga_step"] += _decide(c, "ga_step", f"{fn} {label}", got[2], want[2],
                                           _clear(torch, cfit, arrs[3]))
                same = got[2] == want[2]
                pe = float((got[0] - want[0]).abs()[same].max()) if same.any() else 0.0
                c.kern["ga_step"]["max_abs_err"] = max(c.kern["ga_step"]["max_abs_err"], pe)
                rel = c.err("ga_step", got[1][same], want[1][same], absolute=False)
                require(pe == 0.0 and rel < FUSED_TOL,
                        f"ga_step {fn} {label}: slot err {pe:.3g}, fit rel err {rel:.3g}")
                require(label.startswith("rows") or bool(got[2][..., :2].all()),
                        f"ga_step {fn} {label}: dead slot not taken")
    for k, n in near.items():
        log(f"phase 1: {k} 10 tags x {len(FUSED_SHAPES)} shapes + a row view and unaligned "
            f"views: max rel err "
            f"{c.kern[k]['max_rel_err']:.3g}, max abs err {c.kern[k]['max_abs_err']:.3g}, "
            f"near-tie rows deciding differently {n}")


def phase_prng(c: Ctx) -> None:
    torch, prng = c.torch, c.rt.prng
    for seed in (0, 2008):
        k_cpu = prng.split(prng.PRNGKey(seed), 8)
        k_gpu = k_cpu.to(c.dev)
        pairs = (
            (prng.uniform(k_cpu[0], (800, 1000), -100.0, 100.0),
             prng.uniform(k_gpu[0], (800, 1000), -100.0, 100.0)),
            (prng.uniform(k_cpu, (64, 100)), prng.uniform(k_gpu, (64, 100))),
            (prng.randint(k_cpu, (800,), 0, 799), prng.randint(k_gpu, (800,), 0, 799)),
            (prng.split(k_cpu, 3), prng.split(k_gpu, 3)),
            (prng.fold_in(k_cpu, 5), prng.fold_in(k_gpu, 5)),
        )
        for a, b in pairs:
            b = b.cpu()
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            require(bool(torch.equal(a, b)), f"prng draws differ (seed {seed})")
    log("phase 2: uniform/randint/split/fold_in bitwise equal on cuda and cpu")
    # normal and categorical take erf_inv's log1p and the gumbel's log in
    # float64, rounded once: equal on both devices unless the two float64
    # libraries straddle a float32 rounding boundary (about 1 value in 1e8).
    n_vals = n_diff = max_ulp = 0
    n_cat = cat_diff = 0
    for seed in (0, 2008):
        k_cpu = prng.split(prng.PRNGKey(seed), 8)
        k_gpu = k_cpu.to(c.dev)
        x = (prng.normal(k_cpu[0], (800, 1000)), prng.normal(k_gpu[0], (800, 1000)).cpu())
        y = (prng.normal(k_cpu[:4], (200, 1000), 20.0, 3.0),
             prng.normal(k_gpu[:4], (200, 1000), 20.0, 3.0).cpu())
        for a, b in (x, y):
            d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
            n_vals += a.numel()
            n_diff += int((d > 0).sum())
            max_ulp = max(max_ulp, int(d.max()))
        logits = torch.log(torch.rand((8, 800), generator=torch.Generator().manual_seed(seed)))
        a = prng.categorical(k_cpu, logits, (2, 200))
        b = prng.categorical(k_gpu, logits.to(c.dev), (2, 200)).cpu()
        n_cat += a.numel()
        cat_diff += int((a != b).sum())
    log(f"phase 2: normal card vs cpu: {n_diff} of {n_vals} values differ, largest "
        f"distance {max_ulp} ulp; categorical: {cat_diff} of {n_cat} samples differ")
    require(max_ulp <= 1 and n_diff <= n_vals // 1_000_000 and cat_diff <= n_cat // 10_000,
            "normal or categorical draws differ between card and cpu beyond "
            "float64 last-bit rounding")


def _drive(c: Ctx, r: Run, f):
    """Warm up with a one-round run of ``r``'s engine, then reset the
    counters, drive the full run and read the counters right after."""
    prng = c.rt.prng
    _algo_opt(c, r, gens=r.sync_every).minimize(f, prng.PRNGKey(r.seed))
    c.sync()
    c.reset()
    t0 = time.perf_counter()
    res = _algo_opt(c, r).minimize(f, prng.PRNGKey(r.seed))
    c.sync()
    wall = time.perf_counter() - t0
    counts = c.counts()
    c.add_launches(counts)
    return res, wall, counts


def _objective(c: Ctx, r: Run):
    bm = c.rt.bm
    if r.fn == "shifted_rosenbrock":
        return bm.make_shifted_rosenbrock(r.dim)
    return bm.FUNCTIONS[r.fn]


def _algo_opt(c: Ctx, r: Run, gens: int | None = None, round_callback=None,
              device=None, mesh_cfg=None, mesh=None):
    """The engine for run ``r`` (``gens`` generations if given) on the
    ``cuda`` backend, over the island mesh ``mesh_cfg`` if given, or with
    ``minimize_many``'s jobs split over the placed ``mesh``."""
    rt = c.rt
    gens = r.gens if gens is None else gens
    polish = (_polish_events(r, gens) * r.n_islands * min(r.polish["polish_topk"], r.pop)
              * _polish_per_point(r, r.polish["polish_steps"]) if r.polish else 0)
    cfg = rt.IslandConfig(
        n_islands=r.n_islands, pop=r.pop, dim=r.dim, sync_every=r.sync_every,
        migration=r.migration or ("ring" if r.n_islands > 1 else "none"),
        max_evals=sum(n * (r.pop + _evals_per_gen(a, r.pop, p) * gens)
                      for a, p, n in _groups(r)) + polish,
        portfolio=r.portfolio, share_incumbent=r.share, **r.sync, **r.polish)
    if "cadences" in r.schedule:
        schedule = rt.AsyncSchedule.from_cadences(r.schedule["cadences"], gens // r.sync_every)
    else:
        schedule = rt.AsyncSchedule(**r.schedule) if r.schedule else None
    params = ({k: dict(v) for k, v in r.params.items()} if r.portfolio else dict(r.params))
    return rt.IslandOptimizer(None if r.portfolio else rt.ALGORITHMS[r.algo], cfg,
                              params=params,
                              exec_cfg=rt.ExecutorConfig(backend="cuda",
                                                         kernel=rt.KernelConfig(dtype=r.storage)),
                              round_callback=round_callback, schedule=schedule,
                              device=c.dev if device is None else device,
                              mesh_cfg=mesh_cfg, mesh=mesh)


def _init_best(c: Ctx, opt, f, seed: int) -> float:
    """Best fitness of the initial population ``opt.minimize(f,
    PRNGKey(seed))`` starts from (the same init key), evaluated with the
    plain objective, not with the kernel under test."""
    prng = c.rt.prng
    ik = prng.split(prng.PRNGKey(seed, c.dev))[1]
    pop = opt._init_state(opt._build(f), ik[None])["pop"]
    return float(f.fn(pop.reshape(-1, pop.shape[-1])).min())


def _want_counts(r: Run, gens: int) -> dict:
    """Launches one run must make, per group of islands (a portfolio
    steps each policy's islands as one group): the fused kernel once per
    generation (all the group's islands in one launch) and bench_eval twice
    at init; unfused, the
    executor's two bench_eval launches per evaluator call (chunked DE calls
    once per chunk, the last chunk clamped onto the one before; BH once for
    the kick and once per probe); two per evaluator call of each polish
    event."""
    want = {k: 0 for k in KERNELS}
    for algo, params, _ in _groups(r):     # a portfolio: each group's own
        want["bench_eval"] += 2
        if params.get("fused"):
            want[FUSED_KERNEL[algo]] += gens
        else:
            want["bench_eval"] += 2 * _eval_calls(algo, r.pop, params)[1] * gens
    if r.polish:
        want["bench_eval"] += 2 * len(_event_batches(r)) * _polish_events(r, gens)
    return want


def _count_adoptions(c: Ctx):
    """Wrap the engine's migration to record, per migration round, how
    many rows adopted a migrant: rows whose position or fitness migration
    changed, the mask ``portfolio.adopt_native`` takes (device tensors, read
    at the end). Policies without per-individual state (ea, fa, bh, mc)
    adopt with no re-initialisation, so the migration is where to count."""
    mig = sys.modules["repro_torch.core.migration"]
    orig = mig.migrate
    seen = []

    def counting(policy, pop, fit, k=2, alive=None, group=None):
        new_pop, new_fit = orig(policy, pop, fit, k, alive, group)
        seen.append((c.torch.any(new_pop != pop, dim=-1) | (new_fit != fit)).sum())
        return new_pop, new_fit

    mig.migrate = counting
    return seen, lambda: setattr(mig, "migrate", orig)


def _adoptions(c: Ctx, r: Run, seen: list, rounds: int) -> list[int]:
    """Rows adopted in each of the last ``rounds`` migration rounds; with
    ``r.adopts``, at least one round must have adopted a migrant."""
    per_round = [int(n) for n in c.torch.stack(seen[-rounds:]).cpu()] if seen else []
    require(not r.adopts or any(per_round),
            f"{r.label}: no migration round adopted a migrant")
    return per_round


def _run_main(c: Ctx, phase: int, r: Run) -> dict:
    """Drive one main-path run, hold its launches to _want_counts, its best
    below the initial best and its history non-increasing; record migrant
    adoption per round; profile a further run."""
    f = _objective(c, r)
    seen, restore = _count_adoptions(c)
    try:
        res, wall, counts = _drive(c, r, f)
    finally:
        restore()
    init_best = _init_best(c, _algo_opt(c, r), f, r.seed)
    g = res.n_gens
    want = _want_counts(r, g)
    require(counts == want, f"{r.label}: launches {counts}, expected {want}")
    require(math.isfinite(res.value) and res.value < init_best,
            f"{r.label}: best {res.value} not below initial best {init_best}")
    require(bool((res.history[1:] <= res.history[:-1]).all()),
            f"{r.label}: the incumbent history rose")
    init = 2 * len(_groups(r))             # bench_eval's launches at init
    per_gen = {k: (n - (init if k == "bench_eval" else 0)) / g
               for k, n in counts.items() if n}
    out = {"gens": g, "ms_per_gen": wall / g * 1e3, "best": res.value,
           "init_best": init_best, "launches_per_gen": per_gen, "launches": counts}
    if c.decided:
        # Rows ga_step took or eval_select accepted, over the run.
        out["decided_share"] = {k: float(c.torch.cat([t.reshape(-1) for t in v]).float().mean())
                                for k, v in c.decided.items()}
    if r.n_islands > 1:
        rounds = g // r.sync_every
        out["adopted_rows_per_round"] = _adoptions(c, r, seen, rounds)
    log(f"phase {phase}: {r.label}: {json.dumps(out)}")
    if r.profile:
        prof = profile_rounds(c, lambda gens_, cb: _algo_opt(
            c, r, gens_, round_callback=cb), f, r.seed)
        log(f"phase {phase}: {r.label} profile, init excluded: {json.dumps(prof)}")
        out["profile"] = prof
    return out


def main_path_phases() -> dict[str, set[int]]:
    """The main-path phases whose runs launch each kernel."""
    out = {k: set() for k in KERNELS}
    for phase, runs in MAIN_RUNS.items():
        for r in runs:
            for k in launch_shapes(r):
                out[k].add(phase)
    for phase, runs in MODEL_RUNS.items():
        for r in runs:
            for k in MODEL_KERNEL[r.arch]:
                out[k].add(phase)
    for phase, runs in TRAIN_RUNS.items():
        for r in runs:
            for k in MODEL_KERNEL[r.arch]:
                out[k].add(phase)
                out[f"{k}_bwd"].add(phase)
    out["bench_eval"].add(15)
    for k in ("bench_eval", "de_step", "pso_step"):
        out[k].add(16)
    for k in POP_KERNELS:
        out[k].add(17)
        out[k].add(18)
    return out


def run_main_phase(phase: int):
    def run(c: Ctx) -> dict:
        return {r.label: _run_main(c, phase, r) for r in MAIN_RUNS[phase]}
    return run


def phase_hybrid(c: Ctx) -> dict:
    """Table I's hybrid: ``explore_then_polish`` on HYBRID_RUN's engine,
    host-stepped so each round's end is timed (the host-stepped loop
    synchronises there): its in-run polish event at round 8, then stage 2 on the
    incumbent. Holds the launches to _want_counts plus stage 2's, n_evals to
    the reference's accounting, the history non-increasing and the result
    no worse than the run's incumbent."""
    rt, r = c.rt, HYBRID_RUN
    hc = rt.popt_bench.HYBRID_CONFIG
    require((hc.pop, hc.dim, hc.w, hc.px, hc.barrier_mode, hc.function)
            == (r.pop, r.dim, DE_TABLE1["w"], DE_TABLE1["px"], "chunked", r.fn)
            and {k: getattr(hc, k) for k in HYBRID_POLISH} == HYBRID_POLISH,
            "HYBRID_RUN is not configs.popt_bench.HYBRID_CONFIG")
    f = _objective(c, r)
    pcfg = rt.descent.PolishConfig(steps=STAGE2_STEPS)
    # Warm up every launch shape: one round with a polish event, and stage 2.
    warm = dataclasses.replace(r, polish={**r.polish, "polish_every": 1})
    rt.explore_then_polish(_algo_opt(c, warm, gens=r.sync_every), f,
                           rt.prng.PRNGKey(r.seed), pcfg)
    c.sync()
    c.reset()
    marks = []

    def at_round_end(rnd, best_arg, best_val):
        marks.append((time.perf_counter(), c.rt.bench_eval.LAUNCHES))

    opt = _algo_opt(c, r, round_callback=at_round_end)
    events = []
    polish_of = opt._polish

    def timed_polish(f_):
        """The engine's polish pass, timed between two synchronisations."""
        pass_fn, per_point = polish_of(f_)

        def timed(state):
            c.sync()
            t, n = time.perf_counter(), c.rt.bench_eval.LAUNCHES
            state = pass_fn(state)
            c.sync()
            events.append((time.perf_counter() - t, c.rt.bench_eval.LAUNCHES - n))
            return state

        return timed, per_point

    opt._polish = timed_polish
    t0 = time.perf_counter()
    res = rt.explore_then_polish(opt, f, rt.prng.PRNGKey(r.seed), pcfg)
    c.sync()
    t_end = time.perf_counter()
    counts = c.counts()
    c.add_launches(counts)
    gens, every = r.gens, r.polish["polish_every"]
    n_events = _polish_events(r, gens)
    stage2 = 2 * len(_polish_batches(r, 1, STAGE2_STEPS))
    want = _want_counts(r, gens)
    want["bench_eval"] += stage2
    require(counts == want, f"{r.label}: launches {counts}, expected {want}")
    k = min(r.polish["polish_topk"], r.pop)
    n_evals = (r.pop + gens * _evals_per_gen(r.algo, r.pop, r.params)
               + n_events * k * _polish_per_point(r, r.polish["polish_steps"])
               + _polish_per_point(r, STAGE2_STEPS))
    require(n_events >= 1 and res.n_evals == n_evals,
            f"{r.label}: n_evals {res.n_evals}, the reference's accounting {n_evals}")
    hist = res.history       # stage 1's, carried into the result
    require(math.isfinite(res.value) and res.value <= float(hist[-1])
            and bool((hist[1:] <= hist[:-1]).all()),
            f"{r.label}: result {res.value} or history {hist.tolist()} out of order")
    # Rounds 1..7 (round 0 holds init), the polish event timed alone.
    ts = [t0] + [m[0] for m in marks]
    plain_s = sum(ts[i + 1] - ts[i] for i in range(1, len(marks)) if (i + 1) % every)
    require(len(events) == n_events, f"{r.label}: {len(events)} polish events ran")
    out = {"gens": res.n_gens, "n_evals": res.n_evals, "polish_events": n_events,
           "ms_per_gen": plain_s * 1e3 / ((len(marks) - 1 - n_events) * r.sync_every),
           "ms_per_polish_event": sum(t for t, _ in events) / n_events * 1e3,
           "bench_eval_launches_per_polish_event": events[0][1] if events else None,
           "stage2_ms": (t_end - ts[-1]) * 1e3,
           "stage2_bench_eval_launches": counts["bench_eval"] - marks[-1][1],
           "best_before_polish": float(hist[every - 2]), "best_after_polish": float(hist[every - 1]),
           "best_stage1": float(hist[-1]), "best": res.value, "launches": counts}
    require(out["bench_eval_launches_per_polish_event"] == 2 * len(_event_batches(r))
            and out["stage2_bench_eval_launches"] == stage2,
            f"{r.label}: polish launches {out}")
    log(f"phase 15: {r.label} + explore_then_polish: {json.dumps(out)}")
    return out


# -- phase 16: the multi-job service ------------------------------------------------

SERVICE_DIR = ROOT / "build" / "service"


class RoundClock:
    """A scheduler ``fault_hook``: stamps each round's end (the scheduler has
    just read the round's values back, so the card has finished it) with
    the host clock and the kernels' launch counters, and runs torch.profiler
    over round ``profiled`` when given (in the thread that runs the bucket:
    profiled buckets run inline, in the main thread). A round is timed from
    the previous hook's return to this hook's call, so the profiler's start
    and stop stay out of every round's time."""

    def __init__(self, c: Ctx, profiled: int | None = None):
        self.c, self.profiled, self.marks, self.prof = c, profiled, [], None
        self.left = {}        # round -> host clock as its hook returned

    def __call__(self, key, r: int) -> None:
        self.marks.append((r, time.perf_counter(), self.c.counts()))
        if r == (self.profiled or 0) - 1:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        elif r == self.profiled:
            self.prof.stop()
        self.left[r] = time.perf_counter()

    def summary(self) -> dict:
        """ms per round over rounds 2.. (round 1 holds init; the profiled
        round is left out), kernel launches per round, and for the profiled
        round the device's busy ms, launches and idle share."""
        gaps = [t - self.left[r - 1] for r, t, _ in self.marks
                if r - 1 in self.left and r != self.profiled]
        (r0, _, n0), (r1, _, n1) = self.marks[0], self.marks[-1]
        out = {"rounds": r1, "ms_per_round": sum(gaps) / len(gaps) * 1e3,
               "kernel_launches_per_round": {k: (n1[k] - n0[k]) / (r1 - r0)
                                             for k in n1 if n1[k] - n0[k]}}
        if self.prof is not None:
            torch = self.c.torch
            rows = [(e.device_time_total, e.count) for e in self.prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(r[0] for r in rows) / 1e3
            out.update(device_busy_ms_per_round=busy,
                       device_launches_per_round=sum(r[1] for r in rows),
                       device_idle_share=1.0 - busy / out["ms_per_round"])
        return out


def _service(c: Ctx, name: str, workers: int = 1, **kw):
    """An in-process service on the card with one worker thread (none: the
    bucket runs inside ``flush``, in this thread) and its checkpoints under
    build/service/<name>; buckets run when flushed."""
    return c.rt.OptimizationService(
        workers=workers, max_batch=64, flush_ms=1e9, device=c.dev,
        checkpoint_dir=str(SERVICE_DIR / name), **kw)


def _submit(svc, req: dict, seeds, **extra) -> list[str]:
    ids = []
    for s in seeds:
        reply = svc.handle({"op": "submit", "request": {**req, **extra, "seed": s}})
        require(reply.get("status") == "queued", f"submit refused: {reply}")
        ids.append(reply["id"])
    return ids


def _flush_and_collect(svc, ids: list[str], clock: RoundClock | None = None):
    """Flush the queued bucket, wait for it, and fetch every job through
    the ``result`` op (checked against the job's record). Returns the
    results and the host-clock seconds from flush to the last job done."""
    svc.scheduler.fault_hook = clock
    t0 = time.perf_counter()
    reply = svc.handle({"op": "flush"})
    require(reply == {"flushed": len(ids)}, f"flush: {reply}")
    require(svc.scheduler.drain(timeout=900), "the bucket did not finish")
    wall = time.perf_counter() - t0
    svc.scheduler.fault_hook = None
    out = []
    for jid in ids:
        resp = svc.scheduler.poll(jid)
        require(resp.status == "done", f"job {jid}: {resp.status} {resp.error}")
        reply = svc.handle({"op": "result", "id": jid})
        res = resp.result
        require(reply["status"] == "done" and reply["value"] == res.value
                and reply["n_evals"] == res.n_evals and len(reply["arg"]) == DIM,
                f"job {jid}: result reply {reply.get('status')} differs from its record")
        out.append(res)
    return out, wall


def _standalone(c: Ctx, req: dict, seeds, warm=None) -> tuple[list, float]:
    """Each seed's ``IslandOptimizer.minimize`` with the request's
    configuration on the card, one after another; and their seconds."""
    rt = c.rt
    portfolio = tuple(req.get("portfolio", ()))
    extra = {k: req[k] for k in (*HYBRID_POLISH, "n_islands", "share_incumbent",
                                 "sync_policy", "max_staleness") if k in req}
    cfg = rt.IslandConfig(pop=req["pop"], dim=req["dim"], sync_every=req["sync_every"],
                          max_evals=req["max_evals"], portfolio=portfolio, **extra)
    opt = rt.IslandOptimizer(None if portfolio else rt.ALGORITHMS[req["algo"]], cfg,
                             params=dict(req["params"]),
                             exec_cfg=rt.ExecutorConfig(backend="cuda"), device=c.dev)
    f = rt.bm.make_shifted_rosenbrock(req["dim"])
    t0 = time.perf_counter()
    out = [opt.minimize(f, rt.prng.PRNGKey(s), warm=warm) for s in seeds]
    c.sync()
    return out, time.perf_counter() - t0


def _same_runs(label: str, got, want) -> None:
    """A job's result bit-identical to its standalone run."""
    import numpy as np
    require(len(got) == len(want), f"{label}: {len(got)} results against {len(want)}")
    for g, w in zip(got, want):
        require(g.value == w.value and g.n_evals == w.n_evals and g.n_gens == w.n_gens
                and np.array_equal(g.arg, w.arg) and np.array_equal(g.history, w.history),
                f"{label}: job {g.value} {g.n_evals} differs from its standalone run "
                f"{w.value} {w.n_evals}")


def _bucket_a(c: Ctx, svc, inline) -> tuple[list, dict]:
    """Bucket A in turns with its eight standalone runs (standalone, bucket,
    bucket, standalone), then profiled inline: J = 8 and one job alone."""
    req, seeds = SERVICE_BUCKETS["A"], range(SERVICE_JOBS["A"])
    seq1, t_seq1 = _standalone(c, req, seeds)
    got1, t_b1 = _flush_and_collect(svc, _submit(svc, req, seeds))
    clock = RoundClock(c)
    got2, t_b2 = _flush_and_collect(svc, _submit(svc, req, seeds), clock)
    seq2, t_seq2 = _standalone(c, req, seeds)
    for label, got in (("A bucket 1", got1), ("A bucket 2", got2),
                       ("A standalone 2", seq2)):
        _same_runs(label, got, seq1)
    prof8 = RoundClock(c, profiled=3)
    got3, _ = _flush_and_collect(inline, _submit(inline, req, seeds), prof8)
    _same_runs("A bucket profiled", got3, seq1)
    prof1 = RoundClock(c, profiled=3)
    one, _ = _flush_and_collect(inline, _submit(inline, req, [0]), prof1)
    _same_runs("A one job", one, seq1[:1])
    n = len(seq1)
    out = {"jobs": n, "seconds_standalone": [t_seq1, t_seq2],
           "seconds_bucket": [t_b1, t_b2],
           "jobs_per_s_standalone": 2 * n / (t_seq1 + t_seq2),
           "jobs_per_s_bucket": 2 * n / (t_b1 + t_b2),
           "bucket": clock.summary(), "bucket_profiled": prof8.summary(),
           "one_job_profiled": prof1.summary(),
           "best": [r.value for r in seq1]}
    k8, k1 = (p["kernel_launches_per_round"] for p in (out["bucket"], out["one_job_profiled"]))
    require(k8 == k1 == {"de_step": SYNC_EVERY},
            f"A: kernel launches per round {k8} (J = {n}), {k1} (one job)")
    return seq1, out


def phase_service(c: Ctx) -> dict:
    """The multi-job service on the card (see the module docstring, phase
    16): buckets A-D through ``OptimizationService.handle`` against their
    standalone runs, bucket A killed and resumed, a cancelled job, and a
    two-worker federation with a worker SIGKILLed."""
    import shutil

    import numpy as np
    rt = c.rt
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    svc, inline = _service(c, "buckets"), _service(c, "profiled", workers=0)
    # Warm-up: one round of bucket A's shape.
    _flush_and_collect(svc, _submit(svc, {**SERVICE_BUCKETS["A"], "max_evals": 8_800},
                                    range(SERVICE_JOBS["A"])))
    c.sync()
    c.reset()
    out = {}
    a_res, out["A"] = _bucket_a(c, svc, inline)
    log(f"phase 16: A, {SERVICE_JOBS['A']} fused DE jobs: {json.dumps(out['A'])}")

    req, seeds = SERVICE_BUCKETS["B"], range(SERVICE_JOBS["B"])
    seq, t_seq = _standalone(c, req, seeds)
    got, t_b = _flush_and_collect(svc, _submit(svc, req, seeds))
    _same_runs("B", got, seq)
    prof = RoundClock(c, profiled=3)
    _flush_and_collect(inline, _submit(inline, req, seeds), prof)
    out["B"] = {"jobs": len(seq), "seconds_standalone": t_seq, "seconds_bucket": t_b,
                "bucket_profiled": prof.summary(), "best": [r.value for r in seq]}
    require(out["B"]["bucket_profiled"]["kernel_launches_per_round"] == {"pso_step": SYNC_EVERY},
            f"B: launches per round {out['B']['bucket_profiled']}")
    log(f"phase 16: B, {len(seq)} fused PSO jobs: {json.dumps(out['B'])}")

    req, seeds = SERVICE_BUCKETS["C"], range(SERVICE_JOBS["C"])
    seq, t_seq = _standalone(c, req, seeds)
    clock = RoundClock(c)
    got, t_b = _flush_and_collect(svc, _submit(svc, req, seeds), clock)
    _same_runs("C", got, seq)
    every = SERVICE_POLISH["polish_every"]
    rounds = got[0].n_gens // SYNC_EVERY
    rule = (POP + rounds * SYNC_EVERY * POP
            + rounds // every * SERVICE_POLISH["polish_topk"]
            * _polish_per_point(SERVICE_RUNS[3], SERVICE_POLISH["polish_steps"]))
    require(rounds // every >= 1 and all(r.n_evals == rule == req["max_evals"] for r in got),
            f"C: n_evals {[r.n_evals for r in got]}, the reference's rule {rule}")
    opt = rt.IslandOptimizer(
        rt.ALGORITHMS["de"], rt.IslandConfig(
            pop=POP, dim=DIM, sync_every=SYNC_EVERY, max_evals=req["max_evals"],
            **SERVICE_POLISH), params=dict(req["params"]),
        exec_cfg=rt.ExecutorConfig(backend="cuda"), device=c.dev)
    pcfg = rt.descent.PolishConfig(steps=STAGE2_STEPS)
    t0 = time.perf_counter()
    etp = rt.explore_then_polish_many(
        opt, rt.bm.make_shifted_rosenbrock(DIM),
        c.torch.stack([rt.prng.PRNGKey(s) for s in seeds]), pcfg)
    t_etp = time.perf_counter() - t0
    for e, g in zip(etp, got):
        require(np.array_equal(e.history, g.history) and e.value <= g.value
                and e.n_evals == g.n_evals + _polish_per_point(SERVICE_RUNS[3], STAGE2_STEPS),
                f"C: explore_then_polish_many {e.value} {e.n_evals} against the bucket "
                f"{g.value} {g.n_evals}")
    out["C"] = {"jobs": len(seq), "n_evals": rule, "seconds_standalone": t_seq,
                "seconds_bucket": t_b, "bucket": clock.summary(),
                "best": [r.value for r in got], "explore_then_polish_many": {
                    "seconds": t_etp, "best": [e.value for e in etp],
                    "n_evals": [e.n_evals for e in etp]}}
    log(f"phase 16: C, {len(seq)} hybrid jobs: {json.dumps(out['C'])}")

    warm = [[float(v) for v in r.arg] for r in a_res]
    req, seeds = SERVICE_BUCKETS["A"], range(100, 100 + SERVICE_JOBS["D"])
    seq, _ = _standalone(c, req, seeds, warm=np.asarray(warm, np.float32))
    got, t_b = _flush_and_collect(svc, _submit(svc, req, seeds, warm=warm))
    _same_runs("D", got, seq)
    best_warm = min(r.value for r in a_res)
    require(all(r.value <= best_warm for r in got),
            f"D: {[r.value for r in got]} worse than the best warm row {best_warm}")
    out["D"] = {"jobs": len(got), "warm_rows": len(warm), "best_warm": best_warm,
                "best": [r.value for r in got], "seconds_bucket": t_b}
    log(f"phase 16: D, {len(got)} warm-started fused DE jobs: {json.dumps(out['D'])}")

    out["E"] = _kill_resume_cancel(c, a_res)
    log(f"phase 16: E, bucket A killed at round 5 and resumed; a cancelled job: "
        f"{json.dumps(out['E'])}")
    out["F"] = _federation(c, svc, a_res[0])
    log(f"phase 16: F, federation of two workers on the card: {json.dumps(out['F'])}")
    svc.scheduler.close()

    counts = c.counts()
    c.add_launches(counts)
    require(all(counts[k] for k in ("bench_eval", "de_step", "pso_step")),
            f"phase 16 launches {counts}")
    log(f"phase 16: launches {json.dumps(counts)}")
    return out


def _kill_resume_cancel(c: Ctx, a_res: list) -> dict:
    """Bucket A on a worker that abandons it at round 5 with snapshots
    every 2 rounds; a fresh scheduler's ``resume`` finishes it. Then one
    job of A cancelled after its first round."""
    import threading
    rt = c.rt
    fired = threading.Event()

    def abandon(key, r):
        if r == 5:
            fired.set()
            raise rt.AbandonRun("killed at round 5")

    svc = _service(c, "killed", checkpoint_every=2)
    svc.scheduler.fault_hook = abandon
    ids = _submit(svc, SERVICE_BUCKETS["A"], range(SERVICE_JOBS["A"]))
    svc.handle({"op": "flush"})
    require(fired.wait(900), "E: the killing hook never fired")
    root = SERVICE_DIR / "killed"
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:   # the round-4 snapshot is written on a thread
        runs = [d for d in root.iterdir() if d.name.startswith("run_")]
        if runs and (runs[0] / "step_00000004" / "manifest.json").exists():
            break
        time.sleep(0.05)
    svc.scheduler.close()
    sched = rt.ShapeBucketScheduler(device=c.dev)
    t0 = time.perf_counter()
    summary = sched.resume(str(root))
    t_resume = time.perf_counter() - t0
    require(summary["failed"] == [] and len(summary["resumed"]) == 1
            and summary["resumed"][0]["round"] == 4 and summary["resumed"][0]["jobs"] == ids,
            f"E: resume summary {summary}")
    _same_runs("E resumed", [sched.result(j).result for j in ids], a_res)
    require(not [d for d in root.iterdir() if d.name.startswith("run_")],
            "E: the finished run left its snapshots")

    svc = _service(c, "cancelled")
    jid = _submit(svc, SERVICE_BUCKETS["A"], [0])[0]
    svc.handle({"op": "flush"})
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        p = svc.handle({"op": "poll", "id": jid})
        require(p["status"] != "done", "E: the job finished before it was cancelled")
        if p["status"] == "running" and p.get("round", 0) >= 1:
            break
        time.sleep(0.002)
    reply = svc.handle({"op": "cancel", "id": jid})
    require(svc.scheduler.drain(timeout=300), "E: the cancelled job did not stop")
    resp = svc.scheduler.poll(jid)
    res = resp.result
    require(reply["status"] in ("cancelling", "cancelled") and resp.status == "cancelled"
            and res is not None and len(res.history) == resp.round >= 1
            and res.n_evals == POP + resp.round * SYNC_EVERY * POP
            and res.value == float(res.history[-1]),
            f"E: cancel {reply}, {resp.status} at round {resp.round}")
    svc.scheduler.close()
    return {"resumed_from_round": 4, "seconds_resume": t_resume,
            "cancelled_at_round": resp.round, "cancelled_value": res.value}


def _federation(c: Ctx, svc, best) -> dict:
    """Two ``repro_torch.launch.federate`` runs of two workers on the card
    (subprocesses; their launches lie outside the recorder), uninterrupted
    and with worker 1 SIGKILLed in leg 1: the same incumbent, leg by leg.
    A leg-1 job of the federation runs in process first, so every shape
    the workers launch was launched (and checked) here too."""
    from repro_torch.launch import federate as fed

    def cfg(name):
        return fed.FederationConfig(
            fn="shifted_rosenbrock", dim=DIM, legs=2, evals_per_leg=FED_EVALS,
            pop=POP, n_islands=1, sync_every=FED_SYNC,
            workers=(fed.WorkerSpec(backend="pallas"),) * 2,
            checkpoint_root=str(SERVICE_DIR / name), device=str(c.dev))

    req = cfg("probe").request_dict(1, 0, [[float(v) for v in best.arg]])
    _flush_and_collect(svc, [svc.handle({"op": "submit", "request": req})["id"]])
    seen = {(k, s) for k, s, _ in c.shapes.get(c.phase, set())}
    need = {("bench_eval", (POP, DIM)), ("bench_eval", (1, DIM))}
    require(need <= seen, f"F: the federation's shapes {need - seen} were not launched here")
    t0 = time.perf_counter()
    ref = fed.federate(cfg("fed_ref"))
    t_ref = time.perf_counter() - t0
    coord = fed.FederationCoordinator(cfg("fed_kill"))

    def kill(leg):
        if leg == 1:
            coord.workers[1].kill()

    coord.fault_hook = kill
    t0 = time.perf_counter()
    coord.start()
    try:
        res = coord.run()
    finally:
        coord.close()
    t_kill = time.perf_counter() - t0
    devices = ref.devices + res.devices
    require(all(d is not None and d.startswith(c.dev.type) for d in devices),
            f"F: the workers' banners name {devices}")
    require(res.revived >= 1 and res.value == ref.value and res.arg == ref.arg
            and [[r["value"] for r in leg] for leg in res.legs]
            == [[r["value"] for r in leg] for leg in ref.legs],
            f"F: killed run {res.value} (revived {res.revived}) against {ref.value}")
    return {"devices": devices, "value": ref.value, "revived": res.revived,
            "resubmitted": res.resubmitted, "seconds_uninterrupted": t_ref,
            "seconds_killed": t_kill,
            "leg_values": [[r["value"] for r in leg] for leg in ref.legs]}


def _card_values(c: Ctx):
    """Make the engine's evaluators take each CPU batch to the card, run
    the bench_eval kernel there and bring the fitness back: a CPU run then
    sees the card run's objective values for the same rows (the kernel's
    result for a row does not depend on its batch). Returns the undo."""
    isl = sys.modules["repro_torch.core.islands"]
    orig = isl.make_batch_evaluator

    def maker(f, cfg, group=None):
        ev = orig(f, cfg, group)
        return lambda x: ev(x.to(c.dev)).cpu()

    isl.make_batch_evaluator = maker
    return lambda: setattr(isl, "make_batch_evaluator", orig)


def _history_diff(a, b) -> float:
    import numpy as np
    return float(np.max(np.abs(a.history - b.history) / np.abs(b.history)))


def _card_vs_cpu(c: Ctx, phase: int, r: Run) -> None:
    """Run ``r`` on the card and on the CPU from the same seed: the
    incumbent histories within rtol 1e-4, the same accounting and the same
    migrant adoptions per round, and the card run's launches as
    _want_counts says.

    A gradient polish (asd, fcg, bfgs) takes Richardson differences at
    h = 1e-4, which amplify an ulp of the objective by about f / (2h |g|):
    the CPU's plain objective and the card's kernel sum in other orders, so
    there the two runs part by more than 1e-4 after the first polish event
    (the run prints by how much). For a polish run the CPU is run a second
    time on the card's objective values (``_card_values``) and that run is
    held to rtol 1e-4: it checks every other step of the card's path."""
    f = _objective(c, r)
    sides = [(c.dev, False), ("cpu", False)] + ([("cpu", True)] if r.polish else [])
    res, adopted = {}, {}
    for dev, card_values in sides:
        opt = _algo_opt(c, r, device=dev)
        seen, restore = _count_adoptions(c)
        undo = _card_values(c) if card_values else (lambda: None)
        c.reset()
        try:
            res[dev, card_values] = opt.minimize(f, c.rt.prng.PRNGKey(r.seed))
        finally:
            restore()
            undo()
        if dev == c.dev:
            counts = c.counts()
        adopted[dev, card_values] = _adoptions(c, r, seen, r.gens // r.sync_every)
    a, b = res[c.dev, False], res[sides[-1]]
    rel = _history_diff(a, b)
    want = _want_counts(r, r.gens)
    require(rel < 1e-4, f"card vs cpu {r.label}: history rel diff {rel:.3g}")
    require(all(x.n_evals == a.n_evals and x.n_gens == r.gens for x in res.values()),
            f"card vs cpu {r.label}: accounting differs")
    require(adopted[c.dev, False] == adopted[sides[-1]],
            f"card vs cpu {r.label}: adoptions per round differ: "
            f"{adopted[c.dev, False]} vs {adopted[sides[-1]]}")
    require(counts == want, f"card vs cpu {r.label}: launches {counts}, expected {want}")
    extra = (f" (on the card's values; on the CPU's own {_history_diff(a, res['cpu', False]):.3g})"
             if r.polish else "")
    log(f"phase {phase}: card vs cpu {r.label} {r.params} {r.polish}: history rel diff "
        f"{rel:.3g}{extra}, n_gens {a.n_gens}, n_evals {a.n_evals}, adopted rows per round "
        f"{adopted[c.dev, False]}, card launches { {k: v for k, v in counts.items() if v} }")


def card_vs_cpu_phase(phase: int):
    def run(c: Ctx) -> None:
        for r in CARD_VS_CPU_RUNS[phase]:
            _card_vs_cpu(c, phase, r)
    return run


# -- heterogeneous portfolios and async islands (phase 17) ------------------------

def _in_turns(c: Ctx, runs) -> tuple[dict[str, list[float]], dict[str, list]]:
    """Each run warmed up with one round, then driven in turns (a, b, b,
    a): host-clock ms per generation ending in a synchronise, and the
    results (a run's two results must be equal)."""
    prng = c.rt.prng
    f = _objective(c, runs[0])
    opts = [_algo_opt(c, r) for r in runs]
    for r in runs:
        _algo_opt(c, r, gens=r.sync_every).minimize(f, prng.PRNGKey(r.seed))
    ms, res = {r.label: [] for r in runs}, {r.label: [] for r in runs}
    for i in [*range(len(runs)), *reversed(range(len(runs)))]:
        c.sync()
        t0 = time.perf_counter()
        out = opts[i].minimize(f, prng.PRNGKey(runs[i].seed))
        c.sync()
        ms[runs[i].label].append((time.perf_counter() - t0) * 1e3 / out.n_gens)
        res[runs[i].label].append((out, opts[i]))
    for label, pair in res.items():
        _same_runs(f"{label} in turns", [pair[0][0]], [pair[1][0]])
    return ms, res


def _phase17_mixed(c: Ctx) -> dict:
    """A: the mixed portfolio on the main path (launches, adoption, a
    profile), then 30 generations in turns with phase 5's DE run (which
    phase 5 profiles)."""
    out = _run_main(c, 17, MIXED_RUN)
    per_gen = out["launches_per_gen"]
    require(all(per_gen.get(FUSED_KERNEL[a]) == 1.0 for a in PORTFOLIO),
            f"A: fused launches per generation {per_gen}, expected one per group")
    ms, _ = _in_turns(c, [dataclasses.replace(r, gens=30, profile=False)
                          for r in (MIXED_RUN, DE8)])
    out["ms_per_gen_in_turns"] = ms
    log(f"phase 17: A, mixed portfolio in turns with {DE8.label}: ms/gen {json.dumps(ms)}")
    return out


def _phase17_bits(c: Ctx) -> dict:
    """B and C: the homogeneous portfolio and async at staleness 0 against
    phase 5's barrier run, bit for bit; the straggler in turns with the
    barrier run, its staleness bound and island-rounds; its replay."""
    prng = c.rt.prng
    f = _objective(c, DE8)
    base = _algo_opt(c, DE8).minimize(f, prng.PRNGKey(DE8.seed))
    homog = _algo_opt(c, HOMOGENEOUS_RUN).minimize(f, prng.PRNGKey(DE8.seed))
    _same_runs("B: homogeneous portfolio against the plain engine", [homog], [base])
    opt0 = _algo_opt(c, ASYNC0_RUN)
    async0 = opt0.minimize(f, prng.PRNGKey(DE8.seed))
    _same_runs("C: async at staleness 0 against the barrier engine", [async0], [base])
    require(opt0.last_max_staleness == 0, f"C: staleness {opt0.last_max_staleness}")
    ms, res = _in_turns(c, [DE8, STRAGGLER_RUN])
    straggler, sopt = res[STRAGGLER_RUN.label][0]
    rec = sopt.recorded_schedule
    bound = STRAGGLER_RUN.sync["max_staleness"]
    require(0 <= sopt.last_max_staleness <= bound,
            f"C: straggler staleness {sopt.last_max_staleness} outside 0..{bound}")
    replay = dataclasses.replace(STRAGGLER_RUN, schedule={"step": rec.step, "deliver": rec.deliver})
    again = _algo_opt(c, replay).minimize(f, prng.PRNGKey(DE8.seed))
    _same_runs("C: replay of the recorded schedule", [again], [straggler])
    out = {"homogeneous_value": homog.value, "async0_value": async0.value,
           "straggler": {
               "ms_per_tick_in_turns": [m * DE8.sync_every for m in ms[STRAGGLER_RUN.label]],
               "barrier_ms_per_round_in_turns": [m * DE8.sync_every for m in ms[DE8.label]],
               "ticks": len(rec.step), "island_rounds": int(rec.step.sum()),
               "barrier_island_rounds": len(rec.step) * DE8.n_islands,
               "last_max_staleness": sopt.last_max_staleness,
               "value": straggler.value, "barrier_value": base.value}}
    log(f"phase 17: B, C: homogeneous portfolio and async staleness 0 bit-identical to "
        f"{DE8.label}; straggler: {json.dumps(out['straggler'])}")
    return out


def _cell_opt(c: Ctx, algo: str | None, device):
    """benchmarks/portfolio.py's run_variant for PORTFOLIO_CELL: the mixed
    portfolio (``algo`` None) or one algorithm over the same islands and
    budget, SA tuned by its _sa_params, on the cuda backend."""
    rt, k = c.rt, PORTFOLIO_CELL
    I, P, S = k["n_islands"], k["pop"], k["sync_every"]
    rounds = max(1, (k["budget"] - P * I) // (P * I * S))
    sa = {"T0": k["sa_t0"], "step_frac": k["sa_step_frac"], "n_gens_hint": rounds * S}
    cfg = rt.IslandConfig(n_islands=I, pop=P, dim=k["dim"], sync_every=S, migration="ring",
                          share_incumbent=True, max_evals=k["budget"],
                          portfolio=() if algo else k["portfolio"])
    params = ({"sa": sa} if algo is None else sa if algo == "sa" else {})
    return rt.IslandOptimizer(None if algo is None else rt.ALGORITHMS[algo], cfg,
                              params=params, exec_cfg=rt.ExecutorConfig(backend="cuda"),
                              device=device)


def _phase17_card_vs_cpu(c: Ctx) -> dict:
    """D: the portfolio benchmark's default cell through minimize_many on
    the card and on the CPU (value and history of every seed), its single
    algorithms on the card for the benchmark's claim (logged, not gated);
    then the async runs of ASYNC_CARD_VS_CPU."""
    import statistics

    import numpy as np
    torch, rt, k = c.torch, c.rt, PORTFOLIO_CELL
    f = rt.bm.FUNCTIONS[k["fn"]]
    keys = torch.stack([rt.prng.PRNGKey(s) for s in range(k["seeds"])])
    c.reset()
    card = _cell_opt(c, None, c.dev).minimize_many(f, keys)
    counts = c.counts()
    cpu = _cell_opt(c, None, "cpu").minimize_many(f, keys)
    undo = _card_values(c)
    try:
        cpu_cv = _cell_opt(c, None, "cpu").minimize_many(f, keys)
    finally:
        undo()
    # Rastrigin-12 runs end near 0.01, where the objective's float32 sum
    # cancels: the kernel and the CPU sum in other orders and part by a few
    # ulps of the sum's 120 (the kernel bound allows 1e-5 of |b| + 1,
    # tests/test_kernels.py). So, as phase 14 does for the polish, the CPU
    # also runs on the card's objective values (_card_values), and that run
    # is held to rtol 1e-4; against the CPU's own values the gate is the
    # kernel bound's form at 1e-4, with the plain relative and the absolute
    # differences printed beside it.
    def diffs(xs, ys):
        return [(np.abs(np.append(a.history, a.value) - np.append(b.history, b.value)),
                 np.abs(np.append(b.history, b.value))) for a, b in zip(xs, ys)]

    rel_cv = max(float(np.max(d / h)) for d, h in diffs(card, cpu_cv))
    rel1 = max(float(np.max(d / (h + 1.0))) for d, h in diffs(card, cpu))
    rel = max(float(np.max(d / h)) for d, h in diffs(card, cpu))
    absd = max(float(np.max(d)) for d, _ in diffs(card, cpu))
    require(rel_cv < 1e-4 and rel1 < 1e-4
            and all(a.n_evals == b.n_evals == e.n_evals for a, b, e in zip(card, cpu, cpu_cv)),
            f"D: portfolio cell card vs cpu: on the card's values rel {rel_cv:.3g}; on its own "
            f"|a-b|/(|b|+1) {rel1:.3g}, relative {rel:.3g}, absolute {absd:.3g}")
    want = _want_counts(dataclasses.replace(CELL_RUNS[0], jobs=1), card[0].n_gens)
    require(counts == want, f"D: portfolio cell launches {counts}, expected {want}")
    medians = {a: statistics.median(r.value for r in _cell_opt(c, a, c.dev).minimize_many(f, keys))
               for a in k["portfolio"]}
    port = statistics.median(r.value for r in card)
    out = {"cell": {"history_rel_diff_on_card_values": rel_cv,
                    "history_diff_over_abs_plus_1": rel1, "history_rel_diff": rel,
                    "history_abs_diff": absd, "n_evals": card[0].n_evals,
                    "portfolio_median": port, "single_medians": medians,
                    "beats_worst_single": port < max(medians.values()),
                    "beats_best_single": port < min(medians.values()),
                    "values": [r.value for r in card], "launches": counts}}
    log(f"phase 17: D, benchmarks/portfolio.py's cell card vs cpu: {json.dumps(out['cell'])}")
    for r in ASYNC_CARD_VS_CPU:
        _card_vs_cpu(c, 17, r)
    return out


def _phase17_service(c: Ctx) -> dict:
    """E: a portfolio bucket (resident, as the reference runs it) and an
    async bucket (stepped) through OptimizationService.handle, every job
    bit-identical to its standalone minimize; a request for more ranks
    than the host can place ends in error."""
    import shutil
    shutil.rmtree(SERVICE_DIR / "phase17", ignore_errors=True)
    svc = _service(c, "phase17")
    out = {}
    seeds = range(SERVICE17_JOBS)
    for name, req in SERVICE17.items():
        want, t_seq = _standalone(c, req, seeds)
        got, t_b = _flush_and_collect(svc, _submit(svc, req, seeds))
        _same_runs(f"E: {name} bucket", got, want)
        out[name] = {"jobs": len(got), "seconds_standalone": t_seq, "seconds_bucket": t_b,
                     "n_evals": got[0].n_evals, "best": [r.value for r in got]}
    (jid,) = _submit(svc, {**SERVICE17["async"], "devices": 4096}, [0])
    svc.handle({"op": "flush"})
    require(svc.scheduler.drain(timeout=300), "E: the devices: 4096 bucket did not finish")
    resp = svc.scheduler.poll(jid)
    require(resp.status == "error" and "devices" in (resp.error or ""),
            f"E: devices: 4096 ended {resp.status} {resp.error}")
    out["devices_4096"] = resp.error
    svc.scheduler.close()
    log(f"phase 17: E, the service: {json.dumps(out)}")
    return out


def phase_portfolio_async(c: Ctx) -> dict:
    """Phase 17 (see the module docstring): A-E. The launch counters are
    read around each main-path drive (A) and across the phase."""
    out = {"A": _phase17_mixed(c)}
    c.reset()
    out.update(_phase17_bits(c))
    out["D"] = _phase17_card_vs_cpu(c)
    c.reset()
    out["E"] = _phase17_service(c)
    counts = c.counts()
    c.add_launches(counts)
    require(counts["de_step"] and counts["pso_step"] and counts["eval_select"]
            and counts["ga_step"], f"E: launches {counts}")
    return out


# -- islands over ranks (phase 18) ----------------------------------------------------

def _square(x):
    """The map of phase 18 E: elementwise, so the card and the CPU give
    the same bits before the reduction."""
    return x * x


def _tally_bytes(mesh) -> dict:
    """Wrap the mesh's collectives to count, per kind, the bytes this rank
    sends in them (a ring hop sends its tensor once; an all-gather and an
    all-reduce contribute the rank's tensor)."""
    moved = {}
    for name in ("ring_shift", "all_gather_rows", "all_reduce"):
        orig = getattr(mesh, name)

        def counting(x, *a, _orig=orig, _name=name, **kw):
            moved[_name] = moved.get(_name, 0) + x.numel() * x.element_size()
            return _orig(x, *a, **kw)

        setattr(mesh, name, counting)
    return moved


def _tally_issued(dist) -> dict:
    """Wrap the ``torch.distributed`` calls the mesh's collectives make, to
    count those that reach the process group's backend."""
    issued = {}
    for name in ("batch_isend_irecv", "all_gather", "all_reduce"):
        orig = getattr(dist, name)

        def counting(*a, _orig=orig, _name=name, **kw):
            issued[_name] = issued.get(_name, 0) + 1
            return _orig(*a, **kw)

        setattr(dist, name, counting)
    return issued


def _mesh_call(c: Ctx, r: Run, mesh_cfg, gens: int | None = None):
    """``minimize`` of run ``r`` (``minimize_many`` of its ``jobs`` seeds
    r.seed, r.seed + 1, ...) over ``mesh_cfg``, or unsharded for None."""
    prng = c.rt.prng
    opt = _algo_opt(c, dataclasses.replace(r, jobs=1), gens=gens, mesh_cfg=mesh_cfg)
    f = _objective(c, r)
    if r.jobs > 1:
        keys = c.torch.stack([prng.PRNGKey(r.seed + j) for j in range(r.jobs)])
        return opt.minimize_many(f, keys.to(c.dev))
    return [opt.minimize(f, prng.PRNGKey(r.seed))]


def _device_launches_per_gen(c: Ctx, r: Run, mesh_cfg) -> float:
    """Device launches (every kernel and copy, by ``torch.profiler``) per
    generation of run ``r`` over ``mesh_cfg`` on this process: a 2-round
    run less a 1-round run (init and the run's end cancel), per
    generation. Device activity only: recording the host's operators too
    costs about 40 s for these runs. None off the card."""
    torch = c.torch
    if c.dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for rounds in (1, 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _mesh_call(c, r, mesh_cfg, gens=rounds * r.sync_every)
            c.sync()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return (counts[1] - counts[0]) / r.sync_every


def _mesh_rank(runs, xs, device: str, jobs: Run | None = None) -> dict:
    """A spawned rank of phase 18: each run warmed up with one round, then
    driven in place over the group (launch counters reset just before,
    read just after; bytes this rank sent in collectives); optionally
    distributed_map_reduce of _square over ``xs``, and ``minimize_many`` of
    run ``jobs`` with its jobs split over the group (``mesh=``). The rank runs on its
    own GPU on the nccl route, on ``device`` on gloo. Every rank's counts,
    bytes and launch shapes are gathered to rank 0, which returns them
    with its results."""
    t_in = time.perf_counter()
    import torch
    import torch.distributed as dist
    rt = port_modules()
    size, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    c = Ctx(torch, rt, f"cuda:{rank}" if backend == "nccl" else device)
    record_launch_shapes(c)
    c.phase = 18
    moved, issued = _tally_bytes(rt.mesh), _tally_issued(dist)
    cfg = rt.mesh.MeshConfig(devices=size, backend=backend)
    out = []
    for r in runs:
        t_run = time.perf_counter()
        _mesh_call(c, r, cfg, gens=r.sync_every)
        c.sync()
        c.reset()
        moved.clear()
        issued.clear()
        t0 = time.perf_counter()
        res = _mesh_call(c, r, cfg)
        c.sync()
        wall = time.perf_counter() - t0
        out.append({"label": r.label, "results": res, "wall_s": wall,
                    "ms_per_gen": wall / res[0].n_gens * 1e3,
                    "counts": c.counts(), "bytes": dict(moved), "issued": dict(issued)})
        if r.profile:
            t_prof = time.perf_counter()
            out[-1]["device_launches_per_gen"] = _device_launches_per_gen(c, r, cfg)
            out[-1]["profile_s"] = time.perf_counter() - t_prof
        out[-1]["run_s"] = time.perf_counter() - t_run
    mr = None
    if xs is not None:
        m = cfg.build(c.dev)
        mr = {op: rt.executor.distributed_map_reduce(m, m.axis, _square, op, xs.to(c.dev)).cpu()
              for op in ("sum", "min", "max")}
    over_jobs = None
    if jobs is not None:
        opt = _algo_opt(c, dataclasses.replace(jobs, jobs=1), mesh=cfg.build(c.dev))
        keys = torch.stack([rt.prng.PRNGKey(jobs.seed + j) for j in range(jobs.jobs)])
        issued.clear()
        over_jobs = {"results": opt.minimize_many(_objective(c, jobs), keys.to(c.dev)),
                     "issued": dict(issued)}
    mine = {"runs": [{k: v.get(k) for k in ("counts", "bytes", "ms_per_gen", "run_s",
                                            "profile_s", "device_launches_per_gen")}
                     for v in out],
            "shapes": c.shapes.get(18, set()), "device": str(c.dev)}
    every = [None] * size
    dist.all_gather_object(every, mine)
    return {"runs": out, "ranks": every, "map_reduce": mr, "jobs_over_mesh": over_jobs,
            "backend": backend, "rank_s": time.perf_counter() - t_in}


def _spawn_ranks(c: Ctx, n: int, runs, backend: str, xs=None, jobs=None) -> dict:
    """``_mesh_rank`` on ``n`` spawned ranks: its result, the launch shapes
    of every rank filed under phase 18, the launches added to the kernel
    table, and the spawn's own seconds: its wall less rank 0's time in
    ``_mesh_rank`` (process start, imports, joining the group, returning)."""
    t0 = time.perf_counter()
    out = c.rt.mesh.spawn(n, _mesh_rank, runs, xs, c.dev.type, jobs, backend=backend,
                          timeout=600)
    out["spawn_s"] = time.perf_counter() - t0 - out["rank_s"]
    for rank in out["ranks"]:
        c.shapes.setdefault(18, set()).update(rank["shapes"])
        for run in rank["runs"]:
            c.add_launches(run["counts"])
    return out


def _mesh_line(n: int, out: dict, i: int, r: Run) -> dict:
    """What phase 18 prints of run ``i`` of a spawn: route, ranks' devices,
    ms/gen, each rank's launches per generation and bytes sent per round."""
    gens = out["runs"][i]["results"][0].n_gens
    rounds = gens // r.sync_every
    return {"ranks": n, "backend": out["backend"],
            "rank_devices": [k["device"] for k in out["ranks"]],
            "ms_per_gen": out["runs"][i]["ms_per_gen"], "gens": gens,
            "launches_per_gen_per_rank": [
                {k: v / gens for k, v in k_["runs"][i]["counts"].items() if v}
                for k_ in out["ranks"]],
            "bytes_sent_per_round_per_rank": [
                {k: v / rounds for k, v in k_["runs"][i]["bytes"].items()}
                for k_ in out["ranks"]],
            "device_launches_per_gen_per_rank": [k_["runs"][i]["device_launches_per_gen"]
                                                 for k_ in out["ranks"]],
            "rank_seconds_run_and_profile": [(k_["runs"][i]["run_s"], k_["runs"][i]["profile_s"])
                                             for k_ in out["ranks"]],
            "value": out["runs"][i]["results"][0].value}


def phase_mesh(c: Ctx) -> dict:
    """Phase 18 (see the module docstring): A-E. Every sharded run is held
    bit for bit to its unsharded run; each printed line names its route
    and its ranks' devices; the last line gives the seconds of each part."""
    torch, rt = c.torch, c.rt
    parts, t_last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        parts[name] = now - t_last[0]
        t_last[0] = now

    def timed_unsharded(r):
        c.sync()
        t0 = time.perf_counter()
        res = _mesh_call(c, r, None)
        c.sync()
        return res, (time.perf_counter() - t0) * 1e3 / res[0].n_gens

    # A: the degenerate mesh in turns with the unsharded run.
    _mesh_call(c, DE8, None, gens=DE8.sync_every)
    base, ms_a1 = timed_unsharded(DE8)
    one = _spawn_ranks(c, 1, MESH_RUNS[1] * 2, rt.mesh.default_backend(c.dev, 1),
                       jobs=MANY18)
    again, ms_a2 = timed_unsharded(DE8)
    _same_runs("18 A: unsharded run repeated", again, base)
    for run in one["runs"]:
        _same_runs("18 A: 1-rank mesh against the unsharded run", run["results"], base)
        # The run's incumbents are all-gathered and its history all-reduced
        # through the group; the ring's hop to oneself is the identity.
        require(run["issued"].get("all_gather", 0) > 0 and run["issued"].get("all_reduce", 0) > 0
                and "batch_isend_irecv" not in run["issued"],
                f"18 A: collectives issued on the 1-rank group {run['issued']}")
    # The jobs of MANY18 split over the 1-rank group (mesh=): their rows
    # all-gathered through the group on the rank's device.
    jobs = one["jobs_over_mesh"]
    _same_runs("18 A: 3 jobs over a 1-rank mesh= against the unsharded minimize_many",
               jobs["results"], _mesh_call(c, MANY18, None))
    require(jobs["issued"].get("all_gather", 0) > 0,
            f"18 A: the jobs' gather was not issued on the group {jobs['issued']}")
    out = {"A": {"backend": one["backend"], "rank_devices": [k["device"] for k in one["ranks"]],
                 "jobs_over_mesh_calls": jobs["issued"],
                 "ms_per_gen_in_turns": {"unsharded": [ms_a1, ms_a2],
                                         "1 rank": [r["ms_per_gen"] for r in one["runs"]]},
                 f"{one['backend']}_calls_per_run": one["runs"][0]["issued"],
                 "ring_hop": "identity on one rank: no send/recv issued",
                 "spawn_s": one["spawn_s"]}}
    log(f"phase 18: A, {DE8.label} on a 1-rank {one['backend']} mesh, bit-identical, in turns: "
        f"{json.dumps(out['A'])}")
    lap("A")

    # B and C: 2 ranks (B; C's portfolio, straggler and jobs; E's map/reduce)
    # and 4 ranks (B; C's starvation GA).
    xs = torch.rand((MAP_REDUCE_ROWS, DIM), generator=torch.Generator().manual_seed(18)) * 4 - 2
    spawns = {}
    for n in (2, 4):
        spawns[n] = _spawn_ranks(c, n, MESH_RUNS[n], rt.mesh.default_backend(c.dev, n),
                                 xs if n == 2 else None)
        lap(f"{n} ranks")
    for n, sp in spawns.items():
        for i, r in enumerate(MESH_RUNS[n]):
            want = base if r is DE8 else _mesh_call(c, r, None)
            _same_runs(f"18 {r.label} over {n} ranks against the unsharded run",
                       sp["runs"][i]["results"], want)
            key = "B" if r is DE8 else "C"
            line = _mesh_line(n, sp, i, r)
            out.setdefault(key, {})[f"{r.label}, {n} ranks"] = line
            log(f"phase 18: {key}, {r.label} over {n} ranks, bit-identical: {json.dumps(line)}")
        out.setdefault("spawn_s", {})[n] = sp["spawn_s"]
    log(f"phase 18: spawn seconds outside the ranks' work: {json.dumps(out['spawn_s'])}")
    lap("unsharded references")

    # D: the service.
    route2 = rt.mesh.MeshConfig(devices=2).build(c.dev).backend   # the route D's request takes
    sched = rt.ShapeBucketScheduler(device=c.dev)
    spawn_timeout, rt.mesh.SPAWN_TIMEOUT = rt.mesh.SPAWN_TIMEOUT, 300.0  # D's deadline
    req = {**SERVICE18, "seed": 3}
    two = sched.submit(rt.OptRequest.from_dict({**req, "devices": 2}))
    one_ = sched.submit(rt.OptRequest.from_dict(req))
    many = 2 * rt.mesh.GLOO_MAX_RANKS
    bad = sched.submit(rt.OptRequest.from_dict({**req, "n_islands": many, "devices": many}))
    t0 = time.perf_counter()
    try:
        sched.flush()
    finally:
        rt.mesh.SPAWN_TIMEOUT = spawn_timeout
    wall = time.perf_counter() - t0
    r2, r1, rb = sched.poll(two), sched.poll(one_), sched.poll(bad)
    require(r2.status == "done" and r1.status == "done",
            f"18 D: devices 2 {r2.status} {r2.error}, devices 1 {r1.status} {r1.error}")
    _same_runs("18 D: the devices: 2 request against devices: 1", [r2.result], [r1.result])
    require(rb.status == "error" and "devices" in (rb.error or ""),
            f"18 D: the unplaceable request ended {rb.status} {rb.error}")
    out["D"] = {"backend": route2, "value": r2.result.value, "seconds": wall,
                "unplaceable": rb.error}
    log(f"phase 18: D, a devices: 2 request through the scheduler ({route2}) done, equal to "
        f"devices: 1; an unplaceable one in error: {json.dumps(out['D'])}")
    lap("D")

    # E: distributed_map_reduce against the CPU. min and max exact; sum within
    # float32 rounding of the reduction order, |err| <= rows * 2^-24 * sum|x^2|.
    sq = (xs * xs).double()
    mr = spawns[2]["map_reduce"]
    bound = MAP_REDUCE_ROWS * 2.0 ** -24 * sq.abs().sum(0)
    err = (mr["sum"].double() - sq.sum(0)).abs()
    require(torch.equal(mr["min"], (xs * xs).amin(0)) and torch.equal(mr["max"], (xs * xs).amax(0)),
            "18 E: min or max differs from the CPU's")
    require(bool((err <= bound).all()), f"18 E: sum error {float(err.max()):.3g} over the bound")
    out["E"] = {"backend": spawns[2]["backend"], "rows": MAP_REDUCE_ROWS, "dim": DIM,
                "sum_max_abs_err": float(err.max()), "sum_err_over_bound": float((err / bound).max()),
                "min_max_exact": True}
    log(f"phase 18: E, distributed_map_reduce over 2 ranks against the CPU: {json.dumps(out['E'])}")
    sched.close()
    lap("E")
    log(f"phase 18: seconds by part: {json.dumps(parts)}")
    return out


# -- the model serving path ------------------------------------------------------

# Bounds of tests/test_kernels.py: flash attention absolute, the SSD scan
# relative to the reference's largest |y|.
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
# bfloat16 flash is also held row by row to a share of the plain row's rms.
# A row that sees n keys of normal scores has |out| about sqrt(e / n), 0.02
# at n = 6144, so the absolute 2e-2 is about as large as what it compares
# there and passes a fault that moves such rows by 0.01. Both outputs round
# once to 8 significant bits and may differ by one unit in the last place:
# 2^-7 of an element, and an element reaches about 4.5 times its row's rms
# (the largest of 256 normals), 0.035 of the rms. The bound is 2^-4 of the row's rms; a tile
# fault moves a late row's largest column by several tenths of its rms
# (_flash_faults checks that the bound rejects two planted faults).
FLASH_ROW_TOL = 2.0 ** -4
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# tests/test_kernels.py's own cases: flash (BH, S, T, hd) causal in both
# types, its masks (window, softcap, causal) at (2, 192, 192, 64) float32;
# ssd (BH, S, P, N, chunk) in both types, B/C per scan row. Head dims past
# 128 (the kernels' 256-column instances) with and without gemma2's mask.
FLASH_SUITE = ((2, 128, 128, 64), (2, 256, 256, 64), (2, 128, 256, 128), (2, 100, 200, 64))
FLASH_MASKS = ((64, 0.0, True), (0, 50.0, True), (0, 0.0, False), (32, 30.0, True))
FLASH_WIDE = (((2, 200, 256), 300, (0, 0.0, True)), ((2, 200, 256), 200, (64, 50.0, True)),
              ((3, 130, 200), 130, (0, 0.0, False)))
SSD_SUITE = ((3, 128, 32, 16, 32), (3, 256, 64, 64, 64), (3, 256, 64, 128, 128))
# Logits of the card within this share of the CPU's largest |logit|. In
# bfloat16: a value keeps 8 significant bits, so one rounding moves it by up
# to 2^-9 (2e-3) of itself; the card and the CPU round at different points
# (cuBLAS and the CPU sum in other orders, the tensor-core kernels round P,
# C B^T o L and the state, the plain versions do not), and a 2-layer model
# has about ten roundings in series from the embedding to the logits (per
# layer two norms, the attention or SSD block, its output projection, the
# MLP's products; then the final norm and the head): 2e-2.
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def model_cfg(rt, r: ModelRun):
    over = {"compute_dtype": r.compute_dtype, "param_dtype": r.param_dtype}
    if r.n_layers:
        over["n_layers"] = r.n_layers
    return dataclasses.replace(rt.get_config(r.arch), **over)


def model_cases(rt, r: ModelRun) -> dict[str, list[tuple[tuple, int]]]:
    """The kernel launches run ``r`` makes per prefill: ``{kernel: [(case,
    launches), ...]}``. A flash case is ((BH, S, hd), T, dtype, (window,
    softcap, causal)); an ssd case ((BH, S, P), N, H, chunk, dtype), B/C
    shared by the H heads of a row. gemma2's local (even) and global (odd)
    layers are two flash cases; the hybrid launches flash once per shared
    application, in serve at its first prompt token (position 0, S = 1). A
    VLM's patch embeddings lengthen its prefill; "steps" runs its
    cache-filling prefill once, as serve does."""
    cfg = model_cfg(rt, r)
    dt = r.compute_dtype

    def flash(S, n, window):
        return (((r.batch * cfg.n_heads, S, cfg.hd), S, dt, (window, cfg.attn_softcap, True)), n)

    window = max(cfg.window, 0)
    out = {}
    if cfg.block_pattern == "attn":
        n_local = (cfg.n_layers + 1) // 2 if cfg.local_global_pattern else cfg.n_layers
        S = r.seq + r.embeds
        out["flash_attention"] = [flash(S, n_local, window),
                                  flash(S, cfg.n_layers - n_local, 0)]
    else:
        if r.entry == "prefill":
            out["ssd_scan"] = [(((r.batch * cfg.ssm_heads, r.seq, cfg.ssm_head_dim),
                                 cfg.ssm_state, cfg.ssm_heads, min(cfg.ssm_chunk, r.seq), dt),
                                cfg.n_layers)]
        if cfg.block_pattern == "ssm+shared_attn":
            out["flash_attention"] = [flash(r.seq if r.entry == "prefill" else 1,
                                            cfg.n_layers // cfg.shared_attn_every, window)]
    return {k: [(case, n) for case, n in v if n] for k, v in out.items()}


# Phase 20's attention archs ran 256-token prompts until PR 23 cut them to
# 128 for time; phase 1 holds flash at those runs' cases at this length too
# (granite's hd 128, gemma-7b's hd 256, gemma2's local and global layers),
# so the kernel check keeps every shape it had.
PHASE20_FLASH_SEQ = 256


def _model_runs():
    for table in (MODEL_RUNS, CARD_VS_CPU_MODEL_RUNS):
        for runs in table.values():
            yield from runs


def _row_err(got, want) -> float:
    """Largest over rows (last axis) of max |got - want| over the rms of
    want's row."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt()
    return float(((g - w).abs().amax(-1) / (rms + 1e-6)).max())


def _flash_faults(c: Ctx, q, k, v, kw: dict, want) -> dict[str, tuple[float, float]]:
    """What a faulty kernel would return, which the row bound must reject:
    the kernel on keys and values whose next-to-last whole 64-key tile
    repeats the tile before it (a kernel that reuses a tile; only the last
    rows, which see the most keys, see it), and on a case longer than
    its window, the kernel with window 0 (a local layer run as a global
    one). Self-attention cases (S = T) of 256 keys or more take the first,
    cases longer than their window the second. {fault: (row error, abs
    error)} against the true plain output."""
    fa = c.rt.flash_attention
    S, T = q.shape[1], k.shape[1]
    faulty = {}
    if S == T >= 256:
        t0 = T // 64 * 64 - 128
        k2, v2 = k.clone(), v.clone()
        k2[:, t0:t0 + 64], v2[:, t0:t0 + 64] = k[:, t0 - 64:t0], v[:, t0 - 64:t0]
        faulty["tile reused"] = fa.flash_attention(q, k2, v2, **kw)
    if kw["window"] and S > kw["window"]:
        faulty["window 0"] = fa.flash_attention(q, k, v, **{**kw, "window": 0})
    out = {}
    for name, got in faulty.items():
        out[name] = (_row_err(got, want), float((got.float() - want.float()).abs().max()))
        require(out[name][0] >= FLASH_ROW_TOL,
                f"flash_attention {tuple(q.shape)} {kw}: the row bound passes a planted "
                f"fault ({name}): row err {out[name][0]:.3g}")
    return out


def _flash_check(c: Ctx, gen, shape, T, dtype, mask=(0, 0.0, True)) -> float:
    torch, fa = c.torch, c.rt.flash_attention
    BH, S, hd = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(sh, generator=gen, device=c.dev).to(dt)
               for sh in ((BH, S, hd), (BH, T, hd), (BH, T, hd)))
    window, softcap, causal = mask
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    c.sync()
    c.err("flash_attention", got.float(), want.float())
    err = float((got.float() - want.float()).abs().max())
    require(got.dtype == dt and err < FLASH_TOL[dtype],
            f"flash_attention {shape} T {T} {dtype} mask {mask}: abs err {err:.3g}")
    if dtype == "bfloat16":
        row = _row_err(got, want)
        require(row < FLASH_ROW_TOL, f"flash_attention {shape} T {T} {dtype} mask {mask}: "
                f"row err {row:.3g} of the row's rms")
        kf = c.kern["flash_attention"]
        kf["max_row_err"] = max(kf.get("max_row_err", 0.0), row)
        for name, (f_row, f_abs) in _flash_faults(c, q, k, v, kw, want).items():
            low = kf.setdefault("planted_faults", {}).setdefault(
                name, {"cases": 0, "min_row_err": math.inf, "min_abs_err": math.inf,
                       "under_abs_bound": 0})
            low["cases"] += 1
            low["min_row_err"] = min(low["min_row_err"], f_row)
            low["min_abs_err"] = min(low["min_abs_err"], f_abs)
            low["under_abs_bound"] += f_abs < FLASH_TOL[dtype]
    return err


def _ssd_inputs(c: Ctx, gen, shape, N, H, dtype):
    """x, B, C normal; dt = softplus(normal); A = -exp(normal), as in
    tests/test_kernels.py; B/C (BH / H, S, N)."""
    torch = c.torch
    BH, S, P = shape
    dt_ = getattr(torch, dtype)
    x = torch.randn((BH, S, P), generator=gen, device=c.dev).to(dt_)
    b, cc = (torch.randn((BH // H, S, N), generator=gen, device=c.dev).to(dt_)
             for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((BH, S), generator=gen, device=c.dev))
    A = -torch.exp(torch.randn(BH, generator=gen, device=c.dev))
    return x, dt, A, b, cc


def _ssd_check(c: Ctx, gen, shape, N, H, chunk, dtype) -> float:
    ss = c.rt.ssd_scan
    args = _ssd_inputs(c, gen, shape, N, H, dtype)
    got = ss.ssd_scan(*args, chunk=chunk)
    want = ss.ssd_ref(*args)
    c.sync()
    c.err("ssd_scan", got.float(), want.float())
    rel = float((got.float() - want.float()).abs().max()) / (float(want.float().abs().max()) + 1e-6)
    require(got.dtype == args[0].dtype and rel < SSD_TOL[dtype],
            f"ssd_scan {shape} N {N} H {H} chunk {chunk} {dtype}: err {rel:.3g} of max |y|")
    return rel


def check_model_kernels(c: Ctx) -> None:
    """flash_attention and ssd_scan against their plain versions on the
    card: every case the model and training phases launch (from the run
    tables) and the JAX suite's shapes, types and masks, at its bounds."""
    gen = c.torch.Generator(device=c.dev).manual_seed(11)
    flash, ssd = set(), set()
    for r in _model_runs():
        for k, cases in model_cases(c.rt, r).items():
            (flash if k == "flash_attention" else ssd).update(case for case, _ in cases)
    for r in CARD_VS_CPU_MODEL_RUNS[20]:
        if r.entry == "prefill" and model_cfg(c.rt, r).block_pattern == "attn":
            r = dataclasses.replace(r, seq=PHASE20_FLASH_SEQ)
            flash.update(case for case, _ in model_cases(c.rt, r)["flash_attention"])
    for r in _train_runs():
        cases = train_cases(c.rt, r)
        flash.update(case for case, _ in cases.get("flash_attention", ()))
        ssd.update(case for case, _ in cases.get("ssd_scan", ()))
    worst = {"flash_attention": 0.0, "ssd_scan": 0.0}
    for shape, T, dtype, mask in sorted(flash):
        worst["flash_attention"] = max(worst["flash_attention"],
                                       _flash_check(c, gen, shape, T, dtype, mask))
    for shape, T, mask in FLASH_WIDE:
        for dtype in ("float32", "bfloat16"):
            worst["flash_attention"] = max(worst["flash_attention"],
                                           _flash_check(c, gen, shape, T, dtype, mask))
    for BH, S, T, hd in FLASH_SUITE:
        for dtype in ("float32", "bfloat16"):
            worst["flash_attention"] = max(worst["flash_attention"],
                                           _flash_check(c, gen, (BH, S, hd), T, dtype))
    for mask in FLASH_MASKS:
        for dtype in ("float32", "bfloat16"):
            worst["flash_attention"] = max(worst["flash_attention"],
                                           _flash_check(c, gen, (2, 192, 64), 192, dtype, mask))
    for shape, N, H, chunk, dtype in sorted(ssd):
        worst["ssd_scan"] = max(worst["ssd_scan"], _ssd_check(c, gen, shape, N, H, chunk, dtype))
    for BH, S, P, N, chunk in SSD_SUITE:
        for dtype in ("float32", "bfloat16"):
            worst["ssd_scan"] = max(worst["ssd_scan"],
                                    _ssd_check(c, gen, (BH, S, P), N, 1, chunk, dtype))
    log(f"phase 1: flash_attention at the model cases {sorted(flash)}, the suite's "
        f"{len(FLASH_SUITE)} shapes and {len(FLASH_MASKS)} masks and {len(FLASH_WIDE)} wide "
        f"head dims x 2 types: max abs err "
        f"{worst['flash_attention']:.3g} (bounds {FLASH_TOL}); bf16 max row err "
        f"{c.kern['flash_attention']['max_row_err']:.3g} of the row's rms (bound "
        f"{FLASH_ROW_TOL}); planted faults, each rejected by the row bound: "
        f"{json.dumps(c.kern['flash_attention']['planted_faults'])}")
    log(f"phase 1: ssd_scan at the model cases {sorted(ssd)} and the suite's "
        f"{len(SSD_SUITE)} shapes x 2 types: max err {worst['ssd_scan']:.3g} of max |y| "
        f"(bounds {SSD_TOL})")


class ModelParams:
    """``init_params(PRNGKey(0))`` on the card for one configuration at a
    time (gemma2-9b's float32 weights are 37 GB; the last configuration's
    are dropped first), and its CPU copy. The card's peak memory is reset
    before each init, so a run's peak counts from its weights' draw; the
    init's seconds and peak are logged."""

    def __init__(self):
        self.key, self.card, self.cpu = None, None, None

    def drop(self) -> None:
        """Let go of the weights held (before a phase that draws its own)."""
        self.key, self.card, self.cpu = None, None, None

    def get(self, c: Ctx, cfg, cpu: bool = False):
        key = (cfg.name, cfg.n_layers, cfg.param_dtype)
        if key != self.key:
            self.key, self.card, self.cpu = key, None, None
            torch = c.torch
            if c.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            self.card = c.rt.T.init_params(c.rt.prng.PRNGKey(0, c.dev), cfg)
            c.sync()
            peak = torch.cuda.max_memory_allocated() / 1e9 if c.dev.type == "cuda" else None
            log(f"phase {c.phase}: init_params {cfg.name}, {cfg.n_layers} layers, "
                f"{cfg.param_dtype}: {time.perf_counter() - t0:.1f} s, "
                f"{c.rt.T.param_count(self.card) / 1e9:.3f} G parameters, peak memory "
                f"{peak} GB")
        if cpu and self.cpu is None:
            self.cpu = c.rt.T.tree_map(lambda t: t.cpu(), self.card)
        return self.cpu if cpu else self.card


PARAMS = ModelParams()


def _prompt(c: Ctx, cfg, batch: int, seq: int, device):
    prng = c.rt.prng
    return prng.randint(prng.fold_in(prng.PRNGKey(0, device), 2), (batch, seq), 0, cfg.vocab)


def _frames(c: Ctx, cfg, batch: int, n: int, device):
    """(batch, n, frontend_dim) float32 frame or patch embeddings, normal
    draws of ``prng`` (the same on every device)."""
    prng = c.rt.prng
    return prng.normal(prng.fold_in(prng.PRNGKey(0, device), 3), (batch, n, cfg.frontend_dim))


def _model_inputs(c: Ctx, cfg, r: ModelRun, device) -> dict:
    """Run ``r``'s prompt: ``seq`` frame embeddings for the audio frontend,
    else ``seq`` tokens behind ``r.embeds`` patch embeddings (if any)."""
    if cfg.frontend == "audio_stub":
        return {"embeds": _frames(c, cfg, r.batch, r.seq, device)}
    batch = {"tokens": _prompt(c, cfg, r.batch, r.seq, device)}
    if r.embeds:
        batch["embeds"] = _frames(c, cfg, r.batch, r.embeds, device)
    return batch


def frame_steps(c: Ctx, cfg, params, r: ModelRun, device):
    """The audio frontend through ``launch.steps``: the cache-filling
    prefill of ``r.seq`` frames, then ``r.decode_steps`` decode steps, one
    further frame each. Returns (the logits of the prefill and of each
    step, prefill seconds, decode seconds), each ending in a synchronise."""
    rt = c.rt
    p = rt.steps._cast_params(params, cfg)
    frames = _frames(c, cfg, r.batch, r.seq + r.decode_steps, device)
    state = rt.T.init_decode_state(cfg, r.batch, r.seq + r.decode_steps + 1, device)
    step = rt.steps.make_decode_step(cfg)
    c.sync()
    t0 = time.perf_counter()
    logits, state = rt.steps.make_prefill_decode(cfg)(p, state, {"embeds": frames[:, :r.seq]})
    c.sync()
    t_prefill = time.perf_counter() - t0
    out = [logits]
    t0 = time.perf_counter()
    for i in range(r.decode_steps):
        logits, state = step(p, state, {"embeds": frames[:, r.seq + i:r.seq + i + 1]})
        out.append(logits)
    c.sync()
    return out, t_prefill, time.perf_counter() - t0


def _serve_logits(c: Ctx, cfg, params, r: ModelRun, device, force=None):
    """``launch.serve.serve``'s greedy decode on ``device`` (its prompt,
    cast, cache and token choice), keeping the logits: the cache-filling
    prefill's, then those of each of ``r.decode_steps`` steps, each step
    fed the greedy token of the logits before it, or ``force``'s column
    (teacher forcing). Returns (the logits, the tokens fed (batch, steps))."""
    rt, prng = c.rt, c.rt.prng
    prompt = prng.randint(prng.fold_in(prng.PRNGKey(0, device), 1), (r.batch, r.seq), 0,
                          cfg.vocab)
    p = rt.steps._cast_params(params, cfg)
    state = rt.T.init_decode_state(cfg, r.batch, r.seq + r.decode_steps + 1, device)
    logits, state = rt.steps.make_prefill_decode(cfg)(p, state, {"tokens": prompt})
    out, toks = [logits], []
    step = rt.steps.make_decode_step(cfg)
    for i in range(r.decode_steps):
        tok = (rt.serve._next_token(logits, cfg.vocab, 0.0, None) if force is None
               else force[:, i:i + 1].to(device))
        toks.append(tok)
        logits, state = step(p, state, {"tokens": tok})
        out.append(logits)
    return out, c.torch.cat(toks, dim=1)


def _device_rows(c: Ctx, prof, compare: bool = False):
    """(device µs, name, count) of each kernel and copy on the card in
    ``prof``'s window, largest first, summed from the profiler's raw events
    (``key_averages`` also builds a record of every host event, about 100
    times slower at tens of thousands of launches). With ``compare``, the
    device time and count that ``key_averages`` gives for the same window
    are logged beside these, with each reading's seconds, and must agree
    within 1e-3 (the profiler rounds its averages to nanoseconds)."""
    cuda = c.torch.autograd.DeviceType.CUDA
    t0 = time.perf_counter()
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            t, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (t + e.duration_ns() / 1e3, n + 1)
    out = sorted(((t, k, n) for k, (t, n) in rows.items()), reverse=True)
    if compare:
        raw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        avg = [(e.device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == cuda]
        avg_s = time.perf_counter() - t0
        raw_us, avg_us = sum(r[0] for r in out), sum(a[0] for a in avg)
        raw_n, avg_n = sum(r[2] for r in out), sum(a[1] for a in avg)
        log(f"device time on one profile: raw events {raw_us:.1f} µs in {raw_n} events "
            f"({raw_s:.3f} s), key_averages {avg_us:.1f} µs in {avg_n} events ({avg_s:.3f} s)")
        require(raw_n == avg_n and abs(raw_us - avg_us) <= 1e-3 * avg_us,
                f"raw events {raw_us} µs / {raw_n}, key_averages {avg_us} µs / {avg_n}")
    return out


def profile_decode(c: Ctx, cfg, params, batch: int, prompt_len: int, steps: int = 8,
                   profiled: int = 2) -> dict:
    """Device time and idle share of greedy decode steps after a
    cache-filling prefill: ``steps`` steps timed on the host clock, then
    ``profiled`` more under torch.profiler (its own wall is not used; it
    costs the host about half a millisecond per recorded launch, and every
    decode step launches the same kernels)."""
    torch, rt = c.torch, c.rt
    from torch.profiler import ProfilerActivity, profile
    p = rt.steps._cast_params(params, cfg)
    state = rt.T.init_decode_state(cfg, batch, prompt_len + steps + profiled + 4, c.dev)
    prng = rt.prng
    if cfg.frontend == "audio_stub":
        # Frames in place of tokens: the prompt's, then one frame each step.
        frames = _frames(c, cfg, batch, prompt_len + 1, c.dev)
        first = {"embeds": frames[:, :prompt_len]}
        nxt = lambda logits: {"embeds": frames[:, prompt_len:]}  # noqa: E731
    else:
        first = {"tokens": prng.randint(prng.fold_in(prng.PRNGKey(0, c.dev), 1),
                                        (batch, prompt_len), 0, cfg.vocab)}
        nxt = lambda logits: {  # noqa: E731
            "tokens": torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None]}
    logits, state = rt.steps.make_prefill_decode(cfg)(p, state, first)
    step = rt.steps.make_decode_step(cfg)
    box = [logits, state]

    def run(n):
        for _ in range(n):
            box[0], box[1] = step(p, box[1], nxt(box[0]))

    run(2)
    c.sync()
    t0 = time.perf_counter()
    run(steps)
    c.sync()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(profiled)
        c.sync()
    rows = _device_rows(c, prof)
    busy = sum(r[0] for r in rows) / 1e3 / profiled
    return {"wall_ms_per_token": wall, "device_busy_ms_per_token": busy,
            "device_idle_share": (1.0 - busy / wall) if rows else None,
            "device_launches_per_token": sum(r[2] for r in rows) / profiled,
            "top": [{"name": k[:90], "device_ms": t / 1e3, "count": n}
                    for t, k, n in rows[:4]]}


# The warm-up serve and the decode profile's own cache-filling prefill of
# a recurrent arch take this many prompt tokens: it steps token by token
# (on an H100 80GB HBM3 at 700 W, 6.3 s for mamba2-370m's 64 tokens at
# batch 4, 12.9 s for zamba2-7b's at batch 2), and a short prompt runs the
# same per-token launches. An attention arch's prefill is one launch per
# layer at the prompt's shape, so it keeps the whole prompt.
RECURRENT_WARM_PROMPT = 8


def _warm_prompt(cfg, seq: int) -> int:
    return seq if cfg.block_pattern == "attn" else min(seq, RECURRENT_WARM_PROMPT)


def _want_model_counts(c: Ctx, r: ModelRun) -> dict[str, int]:
    want = {k: sum(n for _, n in cases) for k, cases in model_cases(c.rt, r).items()}
    return {k: want.get(k, 0) for k in KERNELS}


def _check_logits(c: Ctx, cfg, logits, batch: int, label: str) -> None:
    torch = c.torch
    require(tuple(logits.shape) == (batch, cfg.padded_vocab) and logits.dtype == torch.float32,
            f"{label}: logits {tuple(logits.shape)} {logits.dtype}")
    require(bool(torch.isfinite(logits[:, :cfg.vocab]).all()), f"{label}: non-finite logits")
    require(bool((logits[:, cfg.vocab:] <= -1e8).all()), f"{label}: vocab padding not masked")


class DropCount:
    """Wraps ``models.layers.moe_dispatch`` while it is entered: every MoE
    call's (token, k) pairs and, as a device tensor read after the run, how
    many of them its capacity dropped."""

    def __init__(self, c: Ctx):
        self.layers, self.calls = c.rt.layers, []

    def __enter__(self):
        inner = self.inner = self.layers.moe_dispatch

        def counting(params, xt, cfg, cap):
            out = inner(params, xt, cfg, cap)
            dest = out[1]
            self.calls.append((dest.numel(), (dest == cfg.num_experts * cap).sum()))
            return out

        self.layers.moe_dispatch = counting
        return self

    def __exit__(self, *exc):
        self.layers.moe_dispatch = self.inner

    def shares(self, decode_pairs: int) -> dict:
        """The dropped share of pairs at prefill and at decode (calls of
        ``decode_pairs`` pairs: one token a batch row)."""
        out = {}
        for kind, calls in (("prefill", [x for x in self.calls if x[0] != decode_pairs]),
                            ("decode", [x for x in self.calls if x[0] == decode_pairs])):
            if calls:
                out[f"{kind}_drop_share"] = (sum(int(d) for _, d in calls)
                                             / sum(n for n, _ in calls))
        return out


def _model_main(c: Ctx, phase: int, r: ModelRun) -> dict:
    """One warm-up call, then the counters set to 0, the measured call, and
    the counters read; the launches must be the run's kernel once per layer
    per prefill. A serve or steps run is then profiled over further decode
    steps. An MoE arch's warm-up counts the pairs its capacity drops."""
    torch, rt = c.torch, c.rt
    cfg = model_cfg(rt, r)
    params = PARAMS.get(c, cfg)
    drops = DropCount(c)
    if r.entry == "prefill":
        step = rt.steps.make_prefill_step(cfg)
        batch = _model_inputs(c, cfg, r, c.dev)
        with drops:
            step(params, batch)
        c.sync()
        c.reset()
        t0 = time.perf_counter()
        logits = step(params, batch)
        c.sync()
        wall = time.perf_counter() - t0
        counts = c.counts()
        _check_logits(c, cfg, logits, r.batch, r.label)
        out = {"prefill_ms": wall * 1e3,
               "prefill_tok_per_s": r.batch * (r.seq + r.embeds) / wall}
    elif r.entry == "serve":
        with drops:
            rt.serve.serve(cfg, r.batch, _warm_prompt(cfg, r.seq),
                           r.decode_steps if cfg.num_experts else 2, device=c.dev, params=params)
        c.sync()
        c.reset()
        toks, tp, td = rt.serve.serve(cfg, r.batch, r.seq, r.decode_steps, device=c.dev,
                                      params=params)
        counts = c.counts()
        require(tuple(toks.shape) == (r.batch, r.decode_steps)
                and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
                f"{r.label}: tokens {tuple(toks.shape)} out of range")
        out = {"sample_row": toks[0, :8].tolist()}
    else:
        frame_steps(c, cfg, params, dataclasses.replace(r, decode_steps=2), c.dev)
        c.reset()
        logits, tp, td = frame_steps(c, cfg, params, r, c.dev)
        counts = c.counts()
        for lg in logits:
            _check_logits(c, cfg, lg, r.batch, r.label)
        out = {}
    if r.entry != "prefill":
        out.update(prefill_ms=tp * 1e3, prefill_tok_per_s=r.batch * r.seq / tp,
                   decode_ms_per_token=td / r.decode_steps * 1e3,
                   decode_tok_per_s=r.batch * r.decode_steps / td)
    want = _want_model_counts(c, r)
    require(counts == want, f"{r.label}: launches {counts}, expected {want}")
    # bfloat16 runs the tensor-core route of both model kernels, every launch.
    tc = {k: getattr(rt, k).TC_LAUNCHES for k in TC_LIBRARY}
    require(all(tc[k] == (counts[k] if r.compute_dtype == "bfloat16" else 0) for k in tc),
            f"{r.label}: tensor-core launches {tc} of {counts}")
    c.add_launches(counts)
    out["launches_per_prefill"] = {k: v for k, v in counts.items() if v}
    out["tensor_core_launches_per_prefill"] = {k: v for k, v in tc.items() if v}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cfg.num_experts:
        out.update(drops.shares(r.batch * cfg.top_k))
    log(f"phase {phase}: {r.label} (batch {r.batch}, seq {r.seq}, embeds {r.embeds}, layers "
        f"{cfg.n_layers}, {cfg.compute_dtype}, {cfg.param_dtype} parameters): "
        f"{json.dumps(out)}")
    if r.entry != "prefill":
        prof = profile_decode(c, cfg, params, r.batch, _warm_prompt(cfg, r.seq))
        log(f"phase {phase}: {r.label} decode profile: {json.dumps(prof)}")
        out["decode_profile"] = prof
    return out


def _timed(phase: int, r: ModelRun, fn):
    """``fn()``, then a log line of its seconds (an arch's init included in
    its first run)."""
    t0 = time.perf_counter()
    out = fn()
    log(f"phase {phase}: {r.label}: {time.perf_counter() - t0:.1f} s")
    return out


def run_model_phase(phase: int):
    def run(c: Ctx) -> dict:
        return {r.label: _timed(phase, r, lambda: _model_main(c, phase, r))
                for r in MODEL_RUNS[phase]}
    return run


def _logit_err(torch, got, want, vocab: int) -> tuple[float, float]:
    """(max |got - want|, max |want|) over the real vocab."""
    g, w = got[:, :vocab].double().cpu(), want[:, :vocab].double().cpu()
    return float((g - w).abs().max()), float(w.abs().max())


# The router's product rounds differently on the card and on the CPU (in
# bfloat16 by an ulp of its output, 0.0156 at a logit of 2), so a token
# whose K-th and (K+1)-th expert nearly tie can go to another expert on
# each, and from there its hidden state and its batch row's later tokens
# part. The card therefore replays the CPU's experts (``RoutingReplay``),
# which holds every logit to the bound; each card call's own top-k must
# equal the CPU's wherever the CPU's K-th and (K+1)-th log-probabilities
# differ by more than ROUTE_MARGIN, and the others that differ are counted
# as flips.
ROUTE_MARGIN = {"float32": 1e-3, "bfloat16": 0.1}


class RoutingReplay:
    """``models.layers.ROUTING_HOOK`` for a card-vs-CPU check: records the
    CPU's routing call by call, then (after :meth:`replay`) gives each card
    call the CPU's experts and compares the card's own with them."""

    def __init__(self, c: Ctx, cfg, margin: float):
        self.c, self.K, self.margin = c, cfg.top_k, margin
        self.calls, self.i = [], None
        self.tokens = self.near = self.flips = self.clear_flips = 0

    def __enter__(self):
        self.c.rt.layers.ROUTING_HOOK = self
        return self

    def __exit__(self, *exc):
        self.c.rt.layers.ROUTING_HOOK = None

    def replay(self) -> None:
        """Replay the recorded calls from the first, with fresh counts."""
        self.i = 0
        self.tokens = self.near = self.flips = self.clear_flips = 0

    def __call__(self, probs, eidx):
        torch = self.c.torch
        if self.i is None:
            self.calls.append((probs, eidx))
            return eidx
        p_cpu, e_cpu = self.calls[self.i]
        self.i += 1
        same = (torch.sort(eidx.cpu(), -1).values == torch.sort(e_cpu, -1).values).all(-1)
        top = torch.sort(p_cpu, -1, descending=True).values
        clear = (torch.ones_like(same) if self.K >= top.shape[-1] else
                 torch.log(top[..., self.K - 1]) - torch.log(top[..., self.K]) > self.margin)
        self.tokens += same.numel()
        self.near += int((~clear).sum())
        self.flips += int((~same).sum())
        self.clear_flips += int((~same & clear).sum())
        return e_cpu.to(eidx.device)

    def summary(self) -> str:
        require(self.i == len(self.calls), f"the card made {self.i} MoE calls, the CPU "
                f"{len(self.calls)}")
        require(self.clear_flips == 0, f"{self.clear_flips} tokens clear of the routing "
                f"margin {self.margin} went to other experts on the card")
        return (f"routing: {self.flips} of {self.tokens} (token, MoE call) routings differ "
                f"on the card, all among the {self.near} within the margin {self.margin} "
                "(the card replays the CPU's)")


def _replaying(c: Ctx, cfg, r: ModelRun):
    """A RoutingReplay for an MoE arch, else a context that does nothing."""
    if not cfg.num_experts:
        return contextlib.nullcontext()
    return RoutingReplay(c, cfg, ROUTE_MARGIN[r.compute_dtype])


def _model_card_vs_cpu(c: Ctx, phase: int, r: ModelRun) -> None:
    """Run ``r`` on the CPU and on the card on the same weights (an MoE
    arch's card replaying the CPU's routing, ``RoutingReplay``). Prefill:
    last-position logits within MODEL_TOL (of ``r``'s type) of the CPU's
    largest |logit|. Serve: the CPU decodes greedily once through serve's
    own prefill and steps (``_serve_logits``), and its tokens teacher-force
    the card's steps after the card's ``serve``: the logits must agree at
    the prefill and every step within the same bound, their argmax wherever
    the CPU's top-2 gap clears it, and the card's ``serve`` must give the
    CPU's tokens up to the first step where it does not. Steps (the audio
    frontend): the prefill's and every decode step's logits within the
    bound."""
    torch, rt = c.torch, c.rt
    cfg = model_cfg(rt, r)
    p_card = PARAMS.get(c, cfg)
    p_cpu = PARAMS.get(c, cfg, cpu=True)
    tol = MODEL_TOL[r.compute_dtype]
    c.reset()
    routes = []
    if r.entry == "prefill":
        step = rt.steps.make_prefill_step(cfg)
        batch = _model_inputs(c, cfg, r, "cpu")
        with _replaying(c, cfg, r) as replay:
            want = step(p_cpu, batch)
            if replay:
                replay.replay()
            got = step(p_card, {k: v.to(c.dev) for k, v in batch.items()})
            if replay:
                routes.append(replay.summary())
        counts = c.counts()
        err, scale = _logit_err(torch, got, want, cfg.vocab)
        require(err < tol * scale,
                f"card vs cpu {r.label}: logits differ by {err:.3g} (max |logit| {scale:.3g})")
        detail = f"logit err {err:.3g} of max |logit| {scale:.3g} ({err / scale:.3g})"
    elif r.entry == "steps":
        with _replaying(c, cfg, r) as replay:
            want, _, _ = frame_steps(c, cfg, p_cpu, r, "cpu")
            if replay:
                replay.replay()
            got, _, _ = frame_steps(c, cfg, p_card, r, c.dev)
            if replay:
                routes.append(replay.summary())
        counts = c.counts()
        worst = 0.0
        for i, (lg_card, lg_cpu) in enumerate(zip(got, want)):
            err, scale = _logit_err(torch, lg_card, lg_cpu, cfg.vocab)
            worst = max(worst, err / scale)
            require(err < tol * scale,
                    f"card vs cpu {r.label}: step {i} logits differ by {err:.3g} of {scale:.3g}")
        detail = (f"prefill and {r.decode_steps} decode steps on frames: max logit err "
                  f"{worst:.3g} of max |logit|")
    else:
        with _replaying(c, cfg, r) as replay:
            # The CPU decodes greedily through serve's own steps once,
            # keeping every step's logits; its tokens then teacher-force the
            # card's steps after the card's serve.
            want, want_toks = _serve_logits(c, cfg, p_cpu, r, "cpu")
            if replay:
                replay.replay()
            got_toks, _, _ = rt.serve.serve(cfg, r.batch, r.seq, r.decode_steps, device=c.dev,
                                            params=p_card)
            counts = c.counts()
            if replay:
                routes.append(replay.summary())
                replay.replay()
            got, _ = _serve_logits(c, cfg, p_card, r, c.dev, force=want_toks)
            if replay:
                routes.append(replay.summary())
        worst, clear_steps = 0.0, r.decode_steps
        for i, (lg_card, lg_cpu) in enumerate(zip(got, want)):
            err, scale = _logit_err(torch, lg_card, lg_cpu, cfg.vocab)
            worst = max(worst, err / scale)
            require(err < tol * scale,
                    f"card vs cpu {r.label}: step {i} logits differ by {err:.3g} of {scale:.3g}")
            top2 = torch.topk(lg_cpu[:, :cfg.vocab], 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
            same = torch.argmax(lg_card[:, :cfg.vocab].cpu(), -1) == torch.argmax(
                lg_cpu[:, :cfg.vocab], -1)
            require(bool(same[clear].all()), f"card vs cpu {r.label}: step {i} argmax differs "
                    "on a row whose top-2 gap clears the bound")
            if not bool(clear.all()):
                clear_steps = min(clear_steps, i)
        require(torch.equal(got_toks[:, :clear_steps].cpu(), want_toks[:, :clear_steps]),
                f"card vs cpu {r.label}: serve tokens differ within the first {clear_steps} "
                "clear steps")
        detail = (f"prefill and {r.decode_steps} greedy steps teacher-forced: max logit err "
                  f"{worst:.3g} of max |logit|; serve tokens equal: "
                  f"{torch.equal(got_toks.cpu(), want_toks)} "
                  f"(required for the first {clear_steps} steps, whose top-2 gaps clear the bound)")
    detail += "".join(f"; {line}" for line in routes)
    want = _want_model_counts(c, r)
    require(counts == want, f"card vs cpu {r.label}: launches {counts}, expected {want}")
    log(f"phase {phase}: card vs cpu {r.label}: {detail}; card launches "
        f"{ {k: v for k, v in counts.items() if v} }")


def model_card_vs_cpu_phase(phase: int):
    def run(c: Ctx) -> None:
        for r in CARD_VS_CPU_MODEL_RUNS[phase]:
            _timed(phase, r, lambda: _model_card_vs_cpu(c, phase, r))
    return run


# ---------------------------------------------------------------------------
# Training (phases 23-24)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainRun:
    """One drive of the training path for ``arch`` at full width with
    ``n_layers`` layers (0: the config's full depth): ``launch.train.train``
    for ``steps`` steps of ``batch`` x ``seq`` tokens from the synthetic
    stream (phase 23), or one step and the resume drill (phase 24), with
    ``compute_dtype`` activations on float32 masters, remat and CE chunks
    as the config sets them (both on)."""

    label: str
    arch: str
    batch: int
    seq: int
    steps: int = 6
    n_layers: int = 0
    compute_dtype: str = "bfloat16"
    drill: bool = False


# llama3.2-1b and mamba2-370m at their own training shape (seq_len 512,
# global_batch 8, src/repro/models/config.py), full width and depth, bf16
# (phase 23); at 2 layers in float32 and bf16 against the CPU, at 1 x 64
# tokens for llama (the CPU's side runs the 128,256-wide head on every
# position, forward, remat and backward) and 1 x 256 for mamba2 (one
# 256-step chunk) (phase 24), each arch's weights drawn once for both
# types. The resume drill runs mamba2's bf16 case: a checkpoint of its
# params and moments is 0.8 GB (llama's, with its 128,256 x 2048
# embedding, 4.6 GB: its drill spent 37 s writing and reading them on an
# H100 80GB HBM3 host); flash_attention_bwd's bits are held twice over in
# phase 1.
TRAIN_RUNS = {23: (TrainRun("llama3.2-1b train", "llama3.2-1b", 8, 512),
                   TrainRun("mamba2-370m train", "mamba2-370m", 8, 512))}
CARD_VS_CPU_TRAIN_RUNS = {24: tuple(
    TrainRun(f"{arch} train step, 2 layers, {label}", arch, 1, seq, n_layers=2,
             compute_dtype=dtype, drill=arch == "mamba2-370m" and dtype == "bfloat16")
    for arch, seq in (("llama3.2-1b", 64), ("mamba2-370m", 256))
    for dtype, label in (("float32", "f32"), ("bfloat16", "bf16")))}
# Adam of both training phases: the trainer's default schedule, over the run's
# steps.
TRAIN_ADAM = {"lr": 1e-3, "warmup_steps": 10}
# Steps of a phase-23 run under torch.profiler (the last ones; the idle
# share is taken over their own host time), and the unprofiled steps its
# host-clock ms/step is taken over (2..4: step 1 holds the first calls'
# set-up).
TRAIN_PROFILED = 2
# Card against CPU (phase 24), same weights and batch: the loss relative to
# itself, each gradient leaf relative to that leaf's largest |value|. In
# float32 the two sum in other orders (the CPU-vs-JAX tests hold the same
# leaves to 1e-4). In bfloat16 both round activations at each product,
# norm and kernel output, at different points (cuBLAS, the tensor-core
# kernels' bf16 P and SSD intermediates): the forward's logits differ by
# up to 2e-2 of the largest (MODEL_TOL), and a gradient leaf sums such
# products over every token, so 5e-2 of its largest |value|.
TRAIN_TOL = {"float32": {"loss": 1e-5, "grad": 1e-4},
             "bfloat16": {"loss": 1e-2, "grad": 5e-2}}
# A backward kernel against autograd of its plain version on the card, of
# each gradient's largest |value|: float32 sums in another order (and the
# SSD kernel's log-decay gradient is a difference of running sums, which
# cancels); bfloat16 outputs round to 8 significant bits and the kernel's
# D = dO . O reads the forward's bf16 output, as the forward's own bound.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Backward cases beyond the training phases': gemma2's window with its
# attention softcap at head dim 256 (flash: (BH, S, hd), mask), and an odd
# SSD scan (ssd: (BH, S, P), N, H, chunk).
FLASH_GRAD_EXTRA = (((8, 384, 256), (128, 50.0, True)), ((6, 200, 96), (0, 0.0, False)))
SSD_GRAD_EXTRA = (((6, 200, 40), 32, 3, 8),)


def train_cfg(rt, r: TrainRun):
    over = {"compute_dtype": r.compute_dtype, "seq_len": r.seq, "global_batch": r.batch}
    if r.n_layers:
        over["n_layers"] = r.n_layers
    return dataclasses.replace(rt.get_config(r.arch), **over)


def train_cases(rt, r: TrainRun) -> dict[str, list[tuple[tuple, int]]]:
    """The kernel launches one train step of ``r`` makes: ``{kernel:
    [(case, launches)]}`` in ``model_cases``' form. The forward kernel runs
    twice a layer under remat (the forward and the backward's recompute),
    the backward kernel once."""
    cfg = train_cfg(rt, r)
    fwd = 2 if cfg.remat else 1
    if cfg.block_pattern == "attn" and not cfg.local_global_pattern:
        case = ((r.batch * cfg.n_heads, r.seq, cfg.hd), r.seq, r.compute_dtype,
                (max(cfg.window, 0), cfg.attn_softcap, True))
        return {"flash_attention": [(case, fwd * cfg.n_layers)],
                "flash_attention_bwd": [(case, cfg.n_layers)]}
    if cfg.block_pattern == "ssm":
        case = ((r.batch * cfg.ssm_heads, r.seq, cfg.ssm_head_dim), cfg.ssm_state,
                cfg.ssm_heads, min(cfg.ssm_chunk, r.seq), r.compute_dtype)
        return {"ssd_scan": [(case, fwd * cfg.n_layers)], "ssd_scan_bwd": [(case, cfg.n_layers)]}
    raise ValueError(f"no training cases for {r.arch}")


def _train_runs():
    for table in (TRAIN_RUNS, CARD_VS_CPU_TRAIN_RUNS):
        for runs in table.values():
            yield from runs


def _grad_err(c: Ctx, name: str, got, want) -> float:
    """Largest over the gradients of max |got - want| over max |want|,
    recorded for kernel ``name``."""
    worst = 0.0
    k = c.kern[name]
    for g, w in zip(got, want):
        d = float((g.float() - w.float()).abs().max())
        err = d / max(float(w.float().abs().max()), 1e-30)
        worst = max(worst, err)
        k["max_abs_err"] = max(k["max_abs_err"], d)
        k["max_rel_err"] = max(k["max_rel_err"], err)
    return worst


def _flash_grad_check(c: Ctx, gen, shape, dtype: str, mask) -> float:
    """flash_attention's gradient on the card (the forward kernel with its
    row log-sum-exp, then flash_attention_bwd, through autograd) against
    autograd of the plain version, and the same bits from a second
    backward."""
    torch, fa, fb = c.torch, c.rt.flash_attention, c.rt.flash_attention_bwd
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=gen, device=c.dev).to(dt) for _ in range(4))
    window, softcap, causal = mask
    kw = dict(causal=causal, window=window, softcap=softcap)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tc0 = fb.TC_LAUNCHES
    out = fa.flash_attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, do, retain_graph=True)
    again = torch.autograd.grad(out, ins, do)
    want = fb.flash_attention_bwd_ref(q, k, v, do, **kw)
    c.sync()
    route = 2 * int(fb.uses_tensor_cores(dt, shape[-1]))
    require(fb.TC_LAUNCHES - tc0 == route,
            f"flash_attention_bwd {shape} {dtype}: {fb.TC_LAUNCHES - tc0} tensor-core "
            f"launches of 2, expected {route}")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"flash_attention_bwd {shape} {dtype} {mask}: two backwards differ")
    err = _grad_err(c, "flash_attention_bwd", got, want)
    require(all(g.dtype == dt for g in got) and err < GRAD_TOL[dtype],
            f"flash_attention_bwd {shape} {dtype} mask {mask}: err {err:.3g} of max |grad|")
    return err


def _ssd_grad_check(c: Ctx, gen, shape, N: int, H: int, chunk: int, dtype: str) -> float:
    """ssd_scan's gradient on the card (ssd_scan_bwd through autograd)
    against autograd of the plain recurrence, and the same bits from a
    second backward."""
    torch, ss, sb = c.torch, c.rt.ssd_scan, c.rt.ssd_scan_bwd
    args = _ssd_inputs(c, gen, shape, N, H, dtype)
    dy = torch.randn(shape, generator=gen, device=c.dev).to(args[0].dtype)
    ins = [t.clone().requires_grad_(True) for t in args]
    tc0 = sb.TC_LAUNCHES
    y = ss.ssd_scan(*ins, chunk=chunk)
    got = torch.autograd.grad(y, ins, dy, retain_graph=True)
    again = torch.autograd.grad(y, ins, dy)
    want = sb.ssd_scan_bwd_ref(*args, dy)
    c.sync()
    route = 2 * int(dtype == "bfloat16")
    require(sb.TC_LAUNCHES - tc0 == route,
            f"ssd_scan_bwd {shape} {dtype}: {sb.TC_LAUNCHES - tc0} tensor-core launches of "
            f"2, expected {route}")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"ssd_scan_bwd {shape} N {N} H {H} {dtype}: two backwards differ")
    err = _grad_err(c, "ssd_scan_bwd", got, want)
    require(all(g.dtype == t.dtype for g, t in zip(got, args)) and err < GRAD_TOL[dtype],
            f"ssd_scan_bwd {shape} N {N} H {H} {dtype}: err {err:.3g} of max |grad|")
    return err


def check_grad_kernels(c: Ctx) -> None:
    """flash_attention_bwd and ssd_scan_bwd against autograd of their plain
    versions on the card: every case the training phases launch (from the
    run tables), gemma2's window with softcap at head dim 256, a
    non-causal case and an odd SSD scan, each in float32 and bfloat16, and
    each on its route (``TC_LAUNCHES``: bf16 on the tensor cores, flash at
    head dims up to 128)."""
    gen = c.torch.Generator(device=c.dev).manual_seed(13)
    flash, ssd = set(), set()
    for r in _train_runs():
        cases = train_cases(c.rt, r)
        flash.update(case for case, _ in cases.get("flash_attention_bwd", ()))
        ssd.update(case for case, _ in cases.get("ssd_scan_bwd", ()))
    worst = {"flash_attention_bwd": 0.0, "ssd_scan_bwd": 0.0}
    for shape, _, dtype, mask in sorted(flash):
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                           _flash_grad_check(c, gen, shape, dtype, mask))
    for shape, mask in FLASH_GRAD_EXTRA:
        for dtype in ("float32", "bfloat16"):
            worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                               _flash_grad_check(c, gen, shape, dtype, mask))
    for shape, N, H, chunk, dtype in sorted(ssd):
        worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"],
                                    _ssd_grad_check(c, gen, shape, N, H, chunk, dtype))
    for shape, N, H, chunk in SSD_GRAD_EXTRA:
        for dtype in ("float32", "bfloat16"):
            worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"],
                                        _ssd_grad_check(c, gen, shape, N, H, chunk, dtype))
    log(f"phase 1: flash_attention_bwd at the training cases {sorted(flash)} and "
        f"{list(FLASH_GRAD_EXTRA)} x 2 types: max err {worst['flash_attention_bwd']:.3g} of max "
        f"|grad| (bounds {GRAD_TOL}), every case the same bits twice on its route (bf16 at hd "
        f"<= {c.rt.flash_attention_bwd.TC_MAX_HEAD_DIM} on the tensor cores)")
    log(f"phase 1: ssd_scan_bwd at the training cases {sorted(ssd)} and {list(SSD_GRAD_EXTRA)} "
        f"x 2 types: max err {worst['ssd_scan_bwd']:.3g} of max |grad| (bounds {GRAD_TOL}), "
        "every case the same bits twice on its route (bf16 on the tensor cores)")


def _named(tree, pre=""):
    """(path, leaf) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], f"{pre}/{k}")]
    return [(pre, tree)]


class StepWatch:
    """Wraps ``launch.train.make_train_step`` while it is entered: each step
    ``train`` runs is followed by a synchronise and a call of ``after(n,
    params, opt_state, metrics)``, n counting the steps from 1."""

    def __init__(self, c: Ctx, after):
        self.c, self.train, self.after = c, c.rt.train, after

    def __enter__(self):
        inner = self.inner = self.train.make_train_step
        c, after = self.c, self.after

        def watching(cfg, acfg):
            step_fn, n = inner(cfg, acfg), [0]

            def step(params, opt_state, batch):
                out = step_fn(params, opt_state, batch)
                c.sync()
                n[0] += 1
                after(n[0], *out)
                return out
            return step
        self.train.make_train_step = watching
        return self

    def __exit__(self, *exc):
        self.train.make_train_step = self.inner


def _train_main(c: Ctx, phase: int, r: TrainRun) -> dict:
    """``launch.train.train`` on the card for ``r.steps`` steps, the counters
    set to 0 just before and read just after: each kernel's launches must be
    ``train_cases`` per step, every step's loss and grad norm finite, and
    after step 1 every parameter leaf's first moment, 0.1 of its clipped
    gradient, not all zero (a kernel that dropped the gradient leaves the
    weights before it at zero). A step's host time runs from the end of
    the previous step's check to the end of its own synchronise, so the
    checks here fall in no step. Steps 2..4 give ms/step (step 1 holds the
    first calls' set-up); the last TRAIN_PROFILED steps run under
    torch.profiler, and the idle share compares their device busy time
    with their own host time (the profiler's cost to the host included)."""
    torch, rt = c.torch, c.rt
    from torch.profiler import ProfilerActivity, profile
    cfg = train_cfg(rt, r)
    PARAMS.drop()
    if c.dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    acfg = rt.adam.AdamConfig(**TRAIN_ADAM, total_steps=r.steps)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rec = {"ms": [], "loss": [], "grad_norm": []}
    zero = []

    def after(n, params, opt_state, metrics):
        rec["ms"].append((time.perf_counter() - resumed[0]) * 1e3)
        rec["loss"].append(float(metrics["loss"]))
        rec["grad_norm"].append(float(metrics["grad_norm"]))
        if n == 1:
            zero.extend(name for name, m in _named(opt_state.mu) if not bool(m.abs().max() > 0))
        if n == r.steps - TRAIN_PROFILED:
            prof.start()
        elif n == r.steps:
            prof.stop()
        resumed[0] = time.perf_counter()

    c.reset()
    t0 = time.perf_counter()
    resumed = [t0]
    with StepWatch(c, after):
        params, _, losses = rt.train.train(cfg, steps=r.steps, adam_cfg=acfg,
                                           log_every=r.steps, device=c.dev)
    c.sync()
    wall = time.perf_counter() - t0
    counts = c.counts()
    tc = {k: getattr(rt, k).TC_LAUNCHES for k in TC_LIBRARY}
    require(len(rec["loss"]) == len(losses) == r.steps
            and all(map(math.isfinite, rec["loss"] + rec["grad_norm"])),
            f"{r.label}: losses {rec['loss']}, grad norms {rec['grad_norm']}")
    require(not zero, f"{r.label}: after step 1 these leaves had an all-zero gradient: {zero}")
    want = {k: 0 for k in KERNELS}
    for k, cases in train_cases(rt, r).items():
        want[k] = r.steps * sum(n for _, n in cases)
    require(counts == want, f"{r.label}: launches {counts}, expected {want}")
    require(all(tc[k] == (counts[k] if r.compute_dtype == "bfloat16" else 0) for k in tc),
            f"{r.label}: tensor-core launches {tc} of {counts}")
    c.add_launches(counts)
    step_ms = statistics.fmean(rec["ms"][1:r.steps - TRAIN_PROFILED])
    profiled_ms = statistics.fmean(rec["ms"][r.steps - TRAIN_PROFILED:])
    # llama's step (fewer launches than mamba2's) also puts key_averages'
    # sums on record beside the raw events'.
    rows = _device_rows(c, prof, compare=r.arch == "llama3.2-1b")
    busy = sum(x[0] for x in rows) / 1e3 / TRAIN_PROFILED
    out = {"params": rt.T.param_count(params), "leaves": len(_named(params)),
           "seconds_with_init": wall, "ms_per_step": step_ms,
           "tokens_per_s": r.batch * r.seq / step_ms * 1e3,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9 if c.dev.type == "cuda"
                       else None),
           "launches_per_step": {k: v / r.steps for k, v in counts.items() if v},
           "tensor_core_launches_per_step": {k: v / r.steps for k, v in tc.items() if v},
           "profiled_ms_per_step": profiled_ms, "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / profiled_ms,
           "device_launches_per_step": sum(x[2] for x in rows) / TRAIN_PROFILED,
           "top": [{"name": k[:90], "device_ms": t / 1e3 / TRAIN_PROFILED,
                    "count": n // TRAIN_PROFILED} for t, k, n in rows[:6]],
           "losses": rec["loss"], "grad_norms": rec["grad_norm"]}
    log(f"phase {phase}: {r.label} (batch {r.batch} x {r.seq}, {cfg.n_layers} layers, "
        f"{cfg.compute_dtype} on float32 masters, {r.steps} steps): {json.dumps(out)}")
    return out


def run_train_phase(phase: int):
    def run(c: Ctx) -> dict:
        return {r.label: _timed(phase, r, lambda: _train_main(c, phase, r))
                for r in TRAIN_RUNS[phase]}
    return run


def _train_card_vs_cpu(c: Ctx, phase: int, r: TrainRun) -> None:
    """One train step of ``r`` on the card and on the CPU from the same
    weights (``init_params`` on the card, ``PARAMS``) and batch: the loss, every gradient leaf
    (``launch.steps.loss_and_grads``, what ``make_train_step`` runs) within
    TRAIN_TOL, and the params after one Adam update from zero moments.
    Adam's first update moves an element by lr * g s / (|g s| + eps), s
    the clip's scale: about lr times g's sign. Where the CPU's gradient is
    clear of 0 by the leaf's bound (so both signs agree) and |g s| >
    1e-5 (so eps moves the update by under 1e-3 of it), the two must agree
    within 1e-3 lr; elsewhere within 2 lr. The two sides are compared on
    the card. Then, for a run marked ``drill``, the resume drill."""
    torch, rt = c.torch, c.rt
    cfg = train_cfg(rt, r)
    tol = TRAIN_TOL[r.compute_dtype]
    acfg = rt.adam.AdamConfig(**TRAIN_ADAM, total_steps=r.steps)
    params, cpu_params = PARAMS.get(c, cfg), PARAMS.get(c, cfg, cpu=True)
    batch = next(rt.data.SyntheticStream(cfg))
    c.reset()
    res = {}
    for side, p in (("card", params), ("cpu", cpu_params)):
        dev = c.dev if side == "card" else "cpu"
        loss, _, grads = rt.steps.loss_and_grads(p, cfg, rt.data.to_device(batch, dev))
        new, _ = rt.adam.update(grads, rt.adam.init(p), p, acfg)
        res[side] = (float(loss), {k: v.to(c.dev) for k, v in _named(grads)},
                     {k: v.to(c.dev) for k, v in _named(new)})
        if side == "card":
            counts = c.counts()
    want = {k: 0 for k in KERNELS}
    for k, cases in train_cases(rt, r).items():
        want[k] = sum(n for _, n in cases)
    require(counts == want, f"card vs cpu {r.label}: launches {counts}, expected {want}")
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = res["card"], res["cpu"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    require(loss_err < tol["loss"], f"card vs cpu {r.label}: loss {l_card} against {l_cpu}")
    lr0 = float(rt.adam.schedule(torch.zeros((), dtype=torch.int32), acfg))
    gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in g_cpu.values()))
    clip = min(1.0, acfg.grad_clip / (gnorm + 1e-9)) if acfg.grad_clip > 0 else 1.0
    worst_g, worst_p, flips = 0.0, 0.0, 0
    for name, gc in g_cpu.items():
        gk = g_card[name]
        scale = float(gc.abs().max())
        if scale == 0.0:
            require(not bool(gk.abs().max() > 0), f"card vs cpu {r.label}: {name} grad not 0")
            continue
        err = float((gk - gc).abs().max()) / scale
        worst_g = max(worst_g, err)
        require(err < tol["grad"], f"card vs cpu {r.label}: grad {name} err {err:.3g} of its max")
        d = (p_card[name] - p_cpu[name]).abs()
        clear = (gc.abs() > tol["grad"] * scale) & (gc.abs() * clip > 1e-5)
        worst_p = max(worst_p, float(d[clear].max()) / lr0 if bool(clear.any()) else 0.0)
        flips += int((d > 1e-3 * lr0).sum())
        require(float(d.max()) <= 2 * lr0 * (1 + 1e-3) and
                (not bool(clear.any()) or float(d[clear].max()) <= 1e-3 * lr0),
                f"card vs cpu {r.label}: params after one step, {name}: max diff "
                f"{float(d.max()):.3g} (lr {lr0:.3g})")
    log(f"phase {phase}: card vs cpu {r.label}: loss {l_card:.6f} / {l_cpu:.6f} (rel "
        f"{loss_err:.3g}); max grad err {worst_g:.3g} of a leaf's max |grad| (bound "
        f"{tol['grad']}); params after one step within {worst_p:.3g} lr where the grad is "
        f"clear, {flips} elements further (near-zero grads); card launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if r.drill:
        _resume_drill(c, phase, r)


def _resume_drill(c: Ctx, phase: int, r: TrainRun) -> None:
    """4 steps checkpointed every 2 (async), then a fresh ``train`` call
    resuming from the last checkpoint and its data cursor to 6, against 6
    steps in one call: the same losses, params and moments, bit for bit,
    on the card."""
    torch, rt = c.torch, c.rt
    cfg = train_cfg(rt, r)
    acfg = rt.adam.AdamConfig(**TRAIN_ADAM, total_steps=6)
    d = ROOT / "build" / "train_drill" / r.arch
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    kw = dict(adam_cfg=acfg, log_every=100, device=c.dev)
    _, _, first = rt.train.train(cfg, steps=4, ckpt_dir=str(d), ckpt_every=2, resume=False, **kw)
    p, o, rest = rt.train.train(cfg, steps=6, ckpt_dir=str(d), ckpt_every=2, **kw)
    p6, o6, whole = rt.train.train(cfg, steps=6, **kw)
    shutil.rmtree(d, ignore_errors=True)
    require(first + rest == whole, f"resume drill {r.label}: losses {first + rest} against "
            f"{whole}")
    a = _named(p) + _named(o.mu, "/mu") + _named(o.nu, "/nu")
    b = _named(p6) + _named(o6.mu, "/mu") + _named(o6.nu, "/nu")
    differ = [n for (n, x), (_, y) in zip(a, b) if not torch.equal(x, y)]
    require(not differ and torch.equal(o.step, o6.step),
            f"resume drill {r.label}: leaves differ from the uninterrupted run: {differ}")
    log(f"phase {phase}: resume drill {r.label}: 4 steps (checkpoints at 2 and 4), resumed to "
        f"6: losses and all {len(a)} leaves of params, mu and nu bit-identical to 6 steps in "
        f"one call ({time.perf_counter() - t0:.1f} s)")


def train_card_vs_cpu_phase(phase: int):
    def run(c: Ctx) -> None:
        for r in CARD_VS_CPU_TRAIN_RUNS[phase]:
            _timed(phase, r, lambda: _train_card_vs_cpu(c, phase, r))
    return run


# Shapes the kernels on eval_row.cuh are timed at, the first giving the
# kernels line's ms: Table I's population, and the chunked path's 100-row
# chunk for bench_eval, with phase 15's polish batches (the gradient probes
# and ladders of the top 2 and of stage 2's one point), and phase 5's
# 8-island stack for de_step; GA's wave
# of pop / 4 offspring, 8 islands of it (phase 8) and the steady state's
# one offspring on each of 8 islands; SA's population.
EVAL_TIMED = ((POP, DIM), (POP // 8, DIM),
              *sorted(set(_polish_batches(HYBRID_RUN, HYBRID_POLISH["polish_topk"], 1))
                      | set(_polish_batches(HYBRID_RUN, 1, 1)), reverse=True))
# The fused kernels also at phase 17's groups of two islands.
DE_TIMED = ((POP, DIM), (8, POP, DIM), (2, POP, DIM))
GA_TIMED = ((POP // 4, DIM), (8, POP // 4, DIM), (8, 1, DIM), (2, POP // 4, DIM))
ES_TIMED = ((POP, DIM), (2, POP, DIM))
PSO_TIMED = ((POP, DIM), (2, POP, DIM))
# Each population kernel is also timed with bfloat16 storage at the first
# STORAGE_TIMED of its shapes (pso_step at both).
STORAGE_TIMED = 2


def _bound(rates: dict[str, float], nbytes: float, nops: float) -> dict:
    """The least time for ``nbytes`` moved and ``nops`` float32 operations,
    and which of the two sets it."""
    bw, flops = rates["bytes"], rates["float32"]
    return {"bound_ms": max(nbytes / bw, nops / flops) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= nops / flops else "operations"}


def _in_storage(c: Ctx, name: str, args: tuple, dtype: str) -> tuple[tuple, int]:
    """``args`` of population kernel ``name`` with its (P, D) operands and
    shift in storage ``dtype`` (so a timing holds no cast), and the
    storage's bytes an element."""
    st = c.rt.autotune.STORAGE[dtype]
    out = [a.to(st) if i in ROW_OPERANDS[name] or (i == FN_ARG[name] + 1 and a is not None)
           else a for i, a in enumerate(args)]
    return tuple(out), st.itemsize


def _geometry(c: Ctx, name: str, cfg, R: int, D: int, *tensors) -> dict:
    """The geometry the wrapper launches ``name`` at for these tensors."""
    if name == "pso_step":
        return {"threads": c.rt.autotune.resolve(cfg, name, R, D, "shifted_rosenbrock",
                                                 device=c.dev).threads}
    return c.rt.bench_eval.tuned_geometry(name, cfg, R, D, "shifted_rosenbrock",
                                          *tensors)._asdict()


def _time_bench_eval(c: Ctx, rates, gen, shape, dtype: str = "float32") -> dict:
    """bench_eval on shifted Rosenbrock at ``shape`` in storage ``dtype``:
    kernel, plain, bound (the population and shift read once, the fitness
    written once; 12 operations a lane) and the geometry the wrapper chose."""
    be = c.rt.bench_eval
    P, D = shape
    pop = _uniform(c.torch, gen, shape, -100.0, 100.0, c.dev)
    ev, isz = _in_storage(c, "bench_eval", (pop, "shifted_rosenbrock",
                                            c.rt.bm.shift_vector(D, device=c.dev), 390.0), dtype)
    cfg = c.rt.KernelConfig(dtype=dtype)
    return {"shape": list(shape), "storage": dtype,
            "ms": time_ms(lambda: be.bench_eval(*ev, kernel_cfg=cfg)),
            "plain_ms": time_ms(lambda: be.bench_eval_ref(*ev, dtype=dtype)),
            **_bound(rates, isz * (P * D + D) + 4 * P, 12 * P * D),
            "geometry": _geometry(c, "bench_eval", cfg, P, D, ev[0], ev[2])}


def _time_de_step(c: Ctx, rates, gen, shape, dtype: str = "float32") -> dict:
    """de_step on shifted Rosenbrock at ``shape`` (``[I,] P, D``) with Table
    I's w and px: kernel, plain, bound and geometry. Bytes: pop and u read,
    the new population written; fit, idx, jrand, shift read; the new
    fitness written. Operations: the evaluation's 12 a lane, and 4 on each
    lane this run's draws cross over."""
    torch, be, ds = c.torch, c.rt.bench_eval, c.rt.de_step
    *lead, P, D = shape
    R = math.prod(lead) * P
    shift = c.rt.bm.shift_vector(D, device=c.dev)
    pop = _uniform(torch, gen, shape, -100.0, 100.0, c.dev)
    fit = be.bench_eval_ref(pop, "shifted_rosenbrock", shift, 390.0)
    u = torch.rand(shape, generator=gen).to(c.dev)
    idx = ((torch.arange(P) + 1 + torch.randint(0, P - 1, (3, *lead, P), generator=gen))
           % P).to(c.dev)
    jr = torch.randint(0, D, (*lead, P), generator=gen).to(c.dev)
    args, isz = _in_storage(c, "de_step", (pop, fit, idx, u, jr, "shifted_rosenbrock", shift,
                                           390.0, 0.5, 0.2, -100.0, 100.0), dtype)
    cfg = c.rt.KernelConfig(dtype=dtype)
    n_cross = float((args[3] < 0.2).sum()) + R
    return {"shape": list(shape), "storage": dtype,
            "ms": time_ms(lambda: ds.de_step(*args, kernel_cfg=cfg)),
            "plain_ms": time_ms(lambda: ds.de_step_ref(*args, dtype=dtype), reps=10),
            **_bound(rates, isz * (3 * R * D + D) + 8 * 4 * R + 4 * 2 * R,
                     12 * R * D + 4 * n_cross),
            "geometry": _geometry(c, "de_step", cfg, R, D, args[0], args[3], args[6])}


def _time_ga_step(c: Ctx, rates, gen, shape, dtype: str = "float32") -> dict:
    """ga_step on shifted Rosenbrock at ``shape`` (``[I,] N, D``) with GA's
    pc, pm and a sigma of a tenth of the box: kernel, plain, bound, the
    share of rows taken and the geometry. Bound: of each lane the parent
    the child takes, slot, um and noise read, the slots written; slot_f,
    co, cut, shift read; slot_f and take written. Operations: crossover
    select, clip (2) and evaluation (12) a lane; a product and a sum only
    on the lanes this run mutates."""
    torch, be, gs = c.torch, c.rt.bench_eval, c.rt.ga_step
    *lead, N, D = shape
    R = math.prod(lead) * N
    shift = c.rt.bm.shift_vector(D, device=c.dev)
    p1, p2, slot = (_uniform(torch, gen, shape, -100.0, 100.0, c.dev) for _ in range(3))
    slot_f = be.bench_eval_ref(slot, "shifted_rosenbrock", shift, 390.0)
    cut = torch.randint(1, D, (*lead, N), generator=gen).to(c.dev)
    co = torch.rand((*lead, N), generator=gen).to(c.dev)
    um = torch.rand(shape, generator=gen).to(c.dev)
    nz = torch.randn(shape, generator=gen).to(c.dev)
    args, isz = _in_storage(c, "ga_step", (p1, p2, slot, slot_f, cut, co, um, nz,
                                           "shifted_rosenbrock", shift, 390.0, 0.7, 0.1, 20.0,
                                           -100.0, 100.0), dtype)
    cfg = c.rt.KernelConfig(dtype=dtype)
    nbytes = isz * (5 * R * D + D) + 4 * 2 * R + 8 * R + 4 * R + R
    return {"shape": list(shape), "storage": dtype,
            "ms": time_ms(lambda: gs.ga_step(*args, kernel_cfg=cfg)),
            "plain_ms": time_ms(lambda: gs.ga_step_ref(*args, dtype=dtype), reps=10),
            **_bound(rates, nbytes, 15 * R * D + 2 * float((um < 0.1).sum()) + R),
            "decided_share": float(gs.ga_step(*args, kernel_cfg=cfg)[2].float().mean()),
            "geometry": _geometry(c, "ga_step", cfg, R, D, *args[:3], args[6], args[7],
                                  args[9])}


def _time_eval_select(c: Ctx, rates, gen, shape, dtype: str = "float32") -> dict:
    """eval_select on shifted Rosenbrock at ``shape`` with Metropolis
    thresholds (-100 ln u): kernel, plain, bound, the share of rows
    accepted and the geometry. Bound: pop and trial read, the population
    written; fit, thresh, shift read; fit and accepted written."""
    torch, be, es = c.torch, c.rt.bench_eval, c.rt.eval_select
    *lead, P, D = shape
    R = math.prod(lead) * P
    shift = c.rt.bm.shift_vector(D, device=c.dev)
    pop, trial = (_uniform(torch, gen, shape, -100.0, 100.0, c.dev) for _ in range(2))
    fit = be.bench_eval_ref(pop, "shifted_rosenbrock", shift, 390.0)
    th = -100.0 * torch.log(torch.rand((*lead, P), generator=gen)).to(c.dev)
    args, isz = _in_storage(c, "eval_select", (pop, fit, trial, th, "shifted_rosenbrock", shift,
                                               390.0), dtype)
    cfg = c.rt.KernelConfig(dtype=dtype)
    nbytes = isz * (3 * R * D + D) + 4 * 3 * R + 4 * R + R
    return {"shape": list(shape), "storage": dtype,
            "ms": time_ms(lambda: es.eval_select(*args, kernel_cfg=cfg)),
            "plain_ms": time_ms(lambda: es.eval_select_ref(*args, dtype=dtype)),
            **_bound(rates, nbytes, 12 * R * D + 3 * R),
            "decided_share": float(es.eval_select(*args, kernel_cfg=cfg)[2].float().mean()),
            "geometry": _geometry(c, "eval_select", cfg, R, D, args[0], args[2], args[5])}


def _time_pso_step(c: Ctx, rates, gen, shape, dtype: str = "float32") -> dict:
    """pso_step on shifted Rosenbrock at ``shape`` (``[I,] P, D``) with Fig.
    4's w, fp, fg and vmax 0.2 of the box: kernel, plain and bound. Bytes:
    x, v, pbest, r1, r2 in; x, v, pbest out; pbest_f, gbest, shift in;
    fitness, pbest_f out. Per lane: 11 operations for the update (two of
    them fused multiply-adds) and 12 for the evaluation."""
    torch, be = c.torch, c.rt.bench_eval
    *lead, P, D = shape
    R = math.prod(lead) * P
    shift = c.rt.bm.shift_vector(D, device=c.dev)
    x, v, pb = (_uniform(torch, gen, shape, -100.0, 100.0, c.dev) for _ in range(3))
    r1, r2 = (torch.rand(shape, generator=gen).to(c.dev) for _ in range(2))
    pbf = be.bench_eval_ref(pb, "shifted_rosenbrock", shift, 390.0)
    best = pbf.argmin(-1)[..., None, None].expand(*lead, 1, D)
    gbest = torch.gather(pb, -2, best).squeeze(-2).contiguous()
    args, isz = _in_storage(c, "pso_step", (x, v, pb, pbf, r1, r2, gbest, "shifted_rosenbrock",
                                            shift, 390.0, 0.6, 1.0, 1.0, 40.0, -100.0, 100.0),
                            dtype)
    cfg = c.rt.KernelConfig(dtype=dtype)
    return {"shape": list(shape), "storage": dtype,
            "ms": time_ms(lambda: c.rt.pso_step.pso_step(*args, kernel_cfg=cfg)),
            "plain_ms": time_ms(lambda: c.rt.pso_step.pso_step_ref(*args, dtype=dtype)),
            **_bound(rates, isz * (8 * R * D + (math.prod(lead) + 1) * D) + 4 * R + 4 * 2 * R,
                     (13 + 12) * R * D + R),
            "geometry": _geometry(c, "pso_step", cfg, R, D)}


def kernel_timings(c: Ctx, rates: dict[str, float]) -> None:
    """Time each kernel and its plain version at its main path's shape and
    work out its bound from this run's inputs."""
    gen = c.torch.Generator().manual_seed(1)
    for name, timer, shapes in (("bench_eval", _time_bench_eval, EVAL_TIMED),
                                ("de_step", _time_de_step, DE_TIMED),
                                ("eval_select", _time_eval_select, ES_TIMED),
                                ("ga_step", _time_ga_step, GA_TIMED)):
        rows = [timer(c, rates, gen, shape) for shape in shapes]
        bf16 = [timer(c, rates, gen, shape, "bfloat16") for shape in shapes[:STORAGE_TIMED]]
        c.kern[name].update({key: rows[0][key] for key in
                             ("ms", "plain_ms", "bound_ms", "bound_by")}, shapes=rows,
                            bf16_shapes=bf16)
        for r in rows + bf16:
            extra = f", decided_share {r['decided_share']:.6g}" if "decided_share" in r else ""
            log(f"timing {name} {r['storage']} at {tuple(r['shape'])}: kernel {r['ms']:.5f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
                f"{extra}, geometry {r['geometry']}")

    # pso_step at Table I's shape and at phase 17's group of two islands.
    rows = [_time_pso_step(c, rates, gen, shape) for shape in PSO_TIMED]
    bf16 = [_time_pso_step(c, rates, gen, shape, "bfloat16") for shape in PSO_TIMED]
    c.kern["pso_step"].update({key: rows[0][key] for key in
                               ("ms", "plain_ms", "bound_ms", "bound_by")}, shapes=rows,
                              bf16_shapes=bf16)
    for r in rows + bf16:
        log(f"timing pso_step {r['storage']} at {tuple(r['shape'])}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"geometry {r['geometry']}")
    model_kernel_timings(c, rates)
    grad_kernel_timings(c, rates)


def _alternate(old, new, reps: int) -> tuple[float, float, list[float]]:
    """Time ``old`` and ``new`` in turns (old, new, new, old): the mean of
    the two ``new`` readings, of the two ``old`` ones, and all four in
    order."""
    t = [time_ms(old, reps=reps), time_ms(new, reps=reps), time_ms(new, reps=reps),
         time_ms(old, reps=reps)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def sass_counts(c: Ctx) -> None:
    """Count the tensor-core instructions in the SASS of each redesigned
    kernel's library (cuobjdump -sass); fail if the tool is missing, if
    flash attention or its gradient has no HGMMA or the SSD scan or its
    gradient no HGMMA or HMMA."""
    b = c.rt._build
    try:
        tool = b.cuda_tool("cuobjdump")
    except RuntimeError as e:
        raise PhaseFailed(str(e)) from e
    for name, ops in TC_OPCODES.items():
        lib = b.library_path(TC_LIBRARY[name])
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300)
        require(sass.returncode == 0, f"cuobjdump -sass {lib.name} exited {sass.returncode}")
        counts = {op: len(re.findall(rf"\b{op}\.", sass.stdout)) for op in ops}
        c.kern[name]["sass"] = counts
        log(f"sass {lib.name}: {counts}")
        need = counts["HGMMA"] if name.startswith("flash_attention") else sum(counts.values())
        require(need > 0, f"{lib.name}: no tensor-core instruction ({counts}) in its SASS")


def model_kernel_timings(c: Ctx, rates: dict[str, float]) -> None:
    """flash_attention and ssd_scan at every case of the model phases' runs
    (``MODEL_RUNS``), bf16: kernel, plain version, library call and bound
    (``_time_flash_case``, ``_time_ssd_case``). A kernel's own row takes its
    first case (llama3.2-1b's serve prefill, batch 4 x 2048, 32 heads of 64;
    mamba2-370m's prefill, batch 4 x 2048, 32 heads, P 64, N 128, chunk
    256), where the kernel is timed in turns with the CUDA-core design
    through its C entry at bf16 (old, new, new, old)."""
    torch, rt = c.torch, c.rt
    fa, ss, b = rt.flash_attention, rt.ssd_scan, rt._build
    gen = torch.Generator(device=c.dev).manual_seed(3)
    bf16 = torch.bfloat16
    flash, ssd = _timed_cases(rt)
    kf, ks = c.kern["flash_attention"], c.kern["ssd_scan"]
    kf["shapes"] = [_time_flash_case(c, rates, gen, label, shape, mask)
                    for (shape, _, _, mask), label in flash.items()]
    ks["shapes"] = [_time_ssd_case(c, rates, gen, label, shape, N, H, Q)
                    for (shape, N, H, Q, _), label in ssd.items()]
    for k_ in (kf, ks):
        k_.update({key: k_["shapes"][0][key]
                   for key in ("plain_ms", "library_ms", "bound_ms", "bound_by")})

    (shape, T, _, (window, softcap, causal)) = next(iter(flash))
    BH, S, hd = shape
    q, k, v = (torch.randn(sh, generator=gen, device=c.dev).to(bf16)
               for sh in (shape, (BH, T, hd), (BH, T, hd)))
    old_out = torch.empty_like(q)

    def flash_cuda_cores():
        b.launch("flash_attention", c.dev, q, k, v, old_out, None, BH, S, T, hd,
                 fa.DTYPES[bf16], fa.scale_of(hd), int(causal), window, softcap)

    kf["ms"], kf["cuda_core_ms"], turns = _alternate(
        flash_cuda_cores, lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                                     softcap=softcap), reps=20)
    log(f"timing flash_attention CUDA-core design / tensor-core / tensor-core / CUDA-core: {turns}")
    del q, k, v, old_out

    (shape, N, H, Q, _) = next(iter(ssd))
    args = _ssd_inputs(c, gen, shape, N, H, "bfloat16")
    y_old = torch.empty_like(args[0])

    def ssd_cuda_cores():
        b.launch("ssd_scan", c.dev, *args, y_old, *shape, N, H, ss.DTYPES[bf16])

    ks["ms"], ks["cuda_core_ms"], turns = _alternate(
        ssd_cuda_cores, lambda: ss.ssd_scan(*args, chunk=Q), reps=20)
    log(f"timing ssd_scan CUDA-core design / tensor-core / tensor-core / CUDA-core: {turns}")
    del args, y_old
    for name, k_ in (("flash_attention", kf), ("ssd_scan", ks)):
        lib = k_["library_ms"]
        log(f"timing {name} at {tuple(k_['shapes'][0]['shape'])} bf16: kernel {k_['ms']:.4f} "
            f"ms, CUDA-core design {k_['cuda_core_ms']:.4f} ms, plain {k_['plain_ms']:.4f} ms, "
            f"bound {k_['bound_ms']:.4f} ms ({k_['bound_by']}), "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}")
    sass_counts(c)


def _time_flash_bwd_case(c: Ctx, rates, gen, label: str, shape, dtype: str, mask) -> dict:
    """flash_attention_bwd at one training case, S = T: the kernel (on the
    forward kernel's output and row log-sum-exp), its plain version
    (autograd of the plain forward), SDPA's backward where SDPA computes
    the same function (causal, no window, no softcap) and the bound: q, k,
    v, o, dO and the log-sum-exp read and dq, dk, dv written once; 10
    operations per kept (query, key) pair per head dim (S and dP
    recomputed, dV, dQ, dK) at the rate of the input's type."""
    torch, fa, fb = c.torch, c.rt.flash_attention, c.rt.flash_attention_bwd
    BH, S, hd = shape
    window, softcap, causal = mask
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=gen, device=c.dev).to(dt) for _ in range(4))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.forward_with_lse(q, k, v, **kw)
    ms = time_ms(lambda: fb.flash_attention_bwd(q, k, v, out, do, lse, **kw), reps=10)
    plain = time_ms(lambda: fb.flash_attention_bwd_ref(q, k, v, do, **kw), reps=2, warmup=1)
    lib = None
    if window == 0 and softcap == 0.0 and causal:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, k4, v4 = (t.view(1, BH, S, hd).clone().requires_grad_(True) for t in (q, k, v))
        o4 = sdpa(q4, k4, v4, is_causal=True)
        do4 = do.view(1, BH, S, hd)
        lib = time_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True),
                      reps=10)
    size = dt.itemsize
    nbytes = size * 8 * BH * S * hd + 4 * BH * S
    nops = 10 * BH * _causal_pairs(S, window) * hd if causal else 10 * BH * S * S * hd
    b_bytes, b_ops = nbytes / rates["bytes"], nops / rates[dtype]
    row = {"label": label, "shape": list(shape), "dtype": dtype, "mask": list(mask), "ms": ms,
           "plain_ms": plain, "library_ms": lib, "bound_ms": max(b_bytes, b_ops) * 1e3,
           "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
    log(f"timing flash_attention_bwd {json.dumps(row)}")
    return row


def _time_ssd_bwd_case(c: Ctx, rates, gen, label: str, shape, N: int, H: int,
                       dtype: str) -> dict:
    """ssd_scan_bwd at one training case: the kernel, its plain version
    (autograd of the plain recurrence) and the bound: x, dy, B and C (one
    row per H heads), dt and A read and dx, dB, dC, ddt, dA written once;
    8 BH S N P operations (the two recurrences and four contractions) at
    the rate of the input's type. No library call computes it."""
    torch, sb = c.torch, c.rt.ssd_scan_bwd
    BH, S, P = shape
    args = _ssd_inputs(c, gen, shape, N, H, dtype)
    dy = torch.randn(shape, generator=gen, device=c.dev).to(args[0].dtype)
    ms = time_ms(lambda: sb.ssd_scan_bwd(*args, dy), reps=10)
    plain = time_ms(lambda: sb.ssd_scan_bwd_ref(*args, dy), reps=2, warmup=1)
    size = args[0].dtype.itemsize
    nbytes = size * (3 * BH * S * P + 4 * (BH // H) * S * N) + 4 * (2 * BH * S + 2 * BH)
    nops = 8 * BH * S * N * P
    b_bytes, b_ops = nbytes / rates["bytes"], nops / rates[dtype]
    row = {"label": label, "shape": list(shape), "N": N, "heads": H, "dtype": dtype, "ms": ms,
           "plain_ms": plain, "library_ms": None, "bound_ms": max(b_bytes, b_ops) * 1e3,
           "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
    log(f"timing ssd_scan_bwd {json.dumps(row)}")
    return row


def grad_kernel_timings(c: Ctx, rates: dict[str, float]) -> None:
    """The backward kernels at every case the training phases launch them
    at (``train_cases``); a kernel's own row takes phase 23's (llama3.2-1b
    and mamba2-370m at 8 x 512, bf16), where the tensor-core kernel is also
    timed in turns with the CUDA-core design through its C entry at bf16
    (old, new, new, old) on the same inputs."""
    torch, rt, b = c.torch, c.rt, c.rt._build
    fa, fb, sb = rt.flash_attention, rt.flash_attention_bwd, rt.ssd_scan_bwd
    gen = torch.Generator(device=c.dev).manual_seed(5)
    bf16 = torch.bfloat16
    flash, ssd = {}, {}
    for r in _train_runs():
        cases = train_cases(c.rt, r)
        for case, _ in cases.get("flash_attention_bwd", ()):
            flash.setdefault(case, r.label)
        for case, _ in cases.get("ssd_scan_bwd", ()):
            ssd.setdefault(case, r.label)
    kf, ks = c.kern["flash_attention_bwd"], c.kern["ssd_scan_bwd"]
    kf["shapes"] = [_time_flash_bwd_case(c, rates, gen, label, shape, dtype, mask)
                    for (shape, _, dtype, mask), label in flash.items()]
    ks["shapes"] = [_time_ssd_bwd_case(c, rates, gen, label, shape, N, H, dtype)
                    for (shape, N, H, _, dtype), label in ssd.items()]
    for k_ in (kf, ks):
        k_.update({key: k_["shapes"][0][key]
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})

    (shape, _, dtype, (window, softcap, causal)) = next(iter(flash))
    require(dtype == "bfloat16", f"phase 23's flash case is {dtype}, not bfloat16")
    BH, S, hd = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device=c.dev).to(bf16) for _ in range(4))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.forward_with_lse(q, k, v, **kw)
    old = [torch.empty_like(t) for t in (q, k, v)]
    D = torch.empty((BH, S), dtype=torch.float32, device=c.dev)

    def flash_cuda_cores():
        b.launch("flash_attention_bwd", c.dev, q, k, v, out, do, lse, D, *old, BH, S, S, hd,
                 fa.DTYPES[bf16], fa.scale_of(hd), int(causal), window, softcap)

    kf["ms"], kf["cuda_core_ms"], turns = _alternate(
        flash_cuda_cores, lambda: fb.flash_attention_bwd(q, k, v, out, do, lse, **kw), reps=10)
    log(f"timing flash_attention_bwd CUDA-core design / tensor-core / tensor-core / CUDA-core: "
        f"{turns}")
    del q, k, v, do, out, lse, old, D

    (shape, N, H, _, dtype) = next(iter(ssd))
    require(dtype == "bfloat16", f"phase 23's ssd case is {dtype}, not bfloat16")
    BH, S, P = shape
    args = _ssd_inputs(c, gen, shape, N, H, dtype)
    dy = torch.randn(shape, generator=gen, device=c.dev).to(bf16)
    old = [torch.empty_like(t) for t in args]
    part = torch.empty((2, BH, S, N), dtype=torch.float32, device=c.dev)

    def ssd_cuda_cores():
        b.launch("ssd_scan_bwd", c.dev, *args, dy, *old[:3], part[0], part[1], *old[3:],
                 BH, S, P, N, H, rt.ssd_scan.DTYPES[bf16])

    ks["ms"], ks["cuda_core_ms"], turns = _alternate(
        ssd_cuda_cores, lambda: sb.ssd_scan_bwd(*args, dy), reps=10)
    log(f"timing ssd_scan_bwd CUDA-core design / tensor-core / tensor-core / CUDA-core: {turns}")
    del args, dy, old, part
    for name, k_ in (("flash_attention_bwd", kf), ("ssd_scan_bwd", ks)):
        lib = k_["library_ms"]
        log(f"timing {name} at {tuple(k_['shapes'][0]['shape'])} "
            f"{k_['shapes'][0]['dtype']}: kernel {k_['ms']:.4f} ms, CUDA-core design "
            f"{k_['cuda_core_ms']:.4f} ms, plain {k_['plain_ms']:.4f} ms, bound "
            f"{k_['bound_ms']:.4f} ms ({k_['bound_by']}), "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}")


def _timed_cases(rt) -> tuple[dict, dict]:
    """Every model-kernel case of the model phases' runs with the first run
    that launches it: flash {((BH, S, hd), T, dtype, mask): label}, ssd
    {((BH, S, P), N, H, chunk, dtype): label}."""
    flash, ssd = {}, {}
    for runs in MODEL_RUNS.values():
        for r in runs:
            for k, cases in model_cases(rt, r).items():
                for case, _ in cases:
                    (flash if k == "flash_attention" else ssd).setdefault(case, r.label)
    return flash, ssd


def _causal_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal mask of ``window`` (0: none) keeps over
    S = T positions."""
    w = S if window <= 0 or window >= S else window
    return w * (w + 1) // 2 + (S - w) * w


def _time_flash_case(c: Ctx, rates, gen, label: str, shape, mask) -> dict:
    """flash_attention at one case of the model phases, bf16, S = T: kernel, plain
    version, SDPA (only where it computes the same function: no softcap,
    no window) and the bound (q, k, v read and the output written once; 4
    operations per kept (query, key) pair per head dim)."""
    torch, fa = c.torch, c.rt.flash_attention
    BH, S, hd = shape
    window, softcap, causal = mask
    q, k, v = (torch.randn(shape, generator=gen, device=c.dev).to(torch.bfloat16)
               for _ in range(3))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=10)
    plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), reps=2, warmup=1)
    lib = None
    if window == 0 and softcap == 0.0 and causal:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, k4, v4 = (t.view(1, BH, S, hd) for t in (q, k, v))
        lib = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), reps=10)
    nbytes, nops = 2 * 4 * BH * S * hd, 4 * BH * _causal_pairs(S, window) * hd
    b_bytes, b_ops = nbytes / rates["bytes"], nops / rates["bfloat16"]
    out = {"label": label, "shape": list(shape), "mask": list(mask), "ms": ms,
           "plain_ms": plain, "library_ms": lib, "bound_ms": max(b_bytes, b_ops) * 1e3,
           "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
    log(f"timing flash_attention {json.dumps(out)}")
    return out


def _ssd_work(Qk: int, BH: int, H: int, S: int, P: int, N: int) -> tuple[int, int]:
    """(bytes, operations) of one ssd_scan: x read and y written (bf16), B
    and C once per batch row (bf16), dt and A (f32); the chunked form at
    the kernel's chunk Qk: C B^T on the causal half of each (Qk, Qk) tile
    once per batch row (the heads share it), its decay-weighted product
    with x dt per head, C times the carried state and the state update per
    head."""
    B, n_chunks = BH // H, -(-S // Qk)
    nbytes = 2 * 2 * BH * S * P + 2 * 2 * B * S * N + 4 * BH * S + 4 * BH
    nops = n_chunks * Qk * (Qk + 1) * (B * N + BH * P) + BH * n_chunks * 4 * Qk * N * P
    return nbytes, nops


def _time_ssd_case(c: Ctx, rates, gen, label: str, shape, N: int, H: int, chunk: int) -> dict:
    """ssd_scan at one prefill shape, bf16: kernel, plain version and the
    bound (``_ssd_work``); no library call computes it."""
    ss = c.rt.ssd_scan
    BH, S, P = shape
    args = _ssd_inputs(c, gen, shape, N, H, "bfloat16")
    ms = time_ms(lambda: ss.ssd_scan(*args, chunk=chunk), reps=10)
    plain = time_ms(lambda: ss.ssd_ref(*args), reps=2, warmup=1)
    nbytes, nops = _ssd_work(ss.TC_CHUNK, BH, H, S, P, N)
    b_bytes, b_ops = nbytes / rates["bytes"], nops / rates["bfloat16"]
    out = {"label": label, "shape": list(shape), "N": N, "heads": H, "ms": ms,
           "plain_ms": plain, "library_ms": None, "bound_ms": max(b_bytes, b_ops) * 1e3,
           "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
    log(f"timing ssd_scan {json.dumps(out)}")
    return out


# The kernels on csrc/eval_row.cuh, whose compiler reports the run prints.
ROW_KERNELS = ("bench_eval", "de_step", "ga_step", "eval_select")


def _demangled(sym: str) -> str:
    """``kernel<1,2,...>`` from an Itanium-mangled kernel template taking
    int and bool arguments (the last name of ``_ZN...``), else ``sym``."""
    if not sym.startswith("_ZN"):
        return sym
    i, name = 3, sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        n = int(sym[i:j])
        name, i = sym[j:j + n], j + n
    if sym[i:i + 1] != "I":
        return name
    args = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E", sym[i:sym.find("EE", i) + 1])]
    return f"{name}<{','.join(args)}>"


def ptxas_entries(report: str) -> list[dict]:
    """One entry per kernel of an ``nvcc -Xptxas -v`` report: its name with
    its template arguments, registers, static shared memory bytes and
    spill bytes (stores + loads)."""
    out, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"name": _demangled(m.group(1)), "registers": None, "smem": 0, "spill": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def ptxas_summary(entries: list[dict]) -> dict:
    """The kernels' count, register range, largest shared memory, total
    spills and the instantiations that spill, and each shifted-Rosenbrock
    instantiation (tag 4, the main path's) in full."""
    regs = [e["registers"] for e in entries if e["registers"] is not None]
    return {"kernels": len(entries),
            "registers": [min(regs), max(regs)] if regs else None,
            "max_smem_bytes": max((e["smem"] for e in entries), default=0),
            "spill_bytes": sum(e["spill"] for e in entries),
            "spilling": [f"{e['name']}: {e['spill']}" for e in entries if e["spill"]],
            "shifted_rosenbrock": [e for e in entries if "<4," in e["name"]]}


# Phases a second process of this script runs beside the first, on the same
# card: the model serving path (10-12, 19-22), the remaining engines and
# the hybrid (13-15) and phase 6's small DE runs against the CPU. The first
# process runs the rest (1-5, 7-9, 16-18) and then, alone on the card, the
# kernel timings. The second process takes half of torch's default CPU
# threads for the CPU sides of its card-vs-CPU phases.
# -- phase 25: bfloat16 population storage and the geometry tuner ------------------

# B: Table I's fused DE with KernelConfig(dtype="bfloat16") set only on
# ExecutorConfig.kernel, in turns with the float32 route; two islands of
# 64 x 200 with bfloat16 storage, card vs CPU.
STORAGE_RUNS = tuple(Run(f"Table I fused, {dt} storage", "de", 50,
                         {**DE_TABLE1, "fused": True}, profile=False, storage=dt)
                     for dt in ("bfloat16", "float32"))
STORAGE_VS_CPU = Run("de ring fused 2 x 64 x 200, bfloat16 storage", "de", 40,
                     {**DE_TABLE1, "fused": True}, seed=11, n_islands=2, pop=64, dim=200,
                     profile=False, storage="bfloat16")
# C: where the tuner's picks are compared, per kernel: Table I's rows (one
# island) and 8 islands' (the fused kernels' (I, P, D) state; GA's wave of
# P / 4), and for bench_eval also the hybrid's polish batch of 8,000 rows.
TUNER_SHAPES = {"bench_eval": ((POP, DIM), (8 * POP, DIM), (8_000, DIM)),
                "de_step": ((1, POP, DIM), (8, POP, DIM)),
                "eval_select": ((1, POP, DIM), (8, POP, DIM)),
                "pso_step": ((1, POP, DIM), (8, POP, DIM)),
                "ga_step": ((1, POP // 4, DIM), (8, POP // 4, DIM))}
STORAGES = ("float32", "bfloat16")
# Positions of each population kernel's (P, D) operands (the broadcast rows
# follow them in the same type) among its positional arguments, and of fn.
ROW_OPERANDS = {"bench_eval": (0,), "de_step": (0, 3), "eval_select": (0, 2),
                "pso_step": (0, 1, 2, 4, 5, 6), "ga_step": (0, 1, 2, 6, 7)}
FN_ARG = {"bench_eval": 1, "de_step": 5, "eval_select": 4, "pso_step": 7, "ga_step": 8}
# Phase 25's timings: a short spin ahead of 30 launches (a wrapper call
# costs the host under 0.1 ms).
TUNER_REPS, TUNER_SPIN = 30, 10_000_000


def _pop_args(c: Ctx, gen, name: str, shape, cast: str | None = None) -> tuple:
    """Positional arguments of population kernel ``name`` at ``shape`` on
    shifted Rosenbrock (the wrapper's and its plain version's), the ``(P,
    D)`` operands and the shift cast to ``cast`` if given: the main path's
    parameters, thresholds -100 ln u, two dead GA slots a row block."""
    torch, be, bm = c.torch, c.rt.bench_eval, c.rt.bm
    *lead, P, D = shape
    lead = tuple(lead)
    fn, lo, hi = "shifted_rosenbrock", -100.0, 100.0
    shift = bm.shift_vector(D, device=c.dev)
    U = lambda *sh: torch.rand(sh, generator=gen, device=c.dev)   # noqa: E731
    box = lambda *sh: U(*sh) * (hi - lo) + lo                      # noqa: E731
    fit_of = lambda x: be.bench_eval_ref(x, fn, shift, 390.0)     # noqa: E731
    if name == "bench_eval":
        rows = [box(*shape)]
        tail = (fn, shift, 390.0)
    elif name == "de_step":
        pop = box(*shape)
        idx = (torch.arange(P, device=c.dev) + 1
               + torch.randint(0, P - 1, (3, *lead, P), generator=gen, device=c.dev)) % P
        rows = [pop, fit_of(pop), idx, U(*shape),
                torch.randint(0, D, (*lead, P), generator=gen, device=c.dev)]
        tail = (fn, shift, 390.0, 0.5, 0.2, lo, hi)
    elif name == "eval_select":
        pop, trial = box(*shape), box(*shape)
        rows = [pop, fit_of(pop), trial, -100.0 * torch.log(U(*lead, P))]
        tail = (fn, shift, 390.0)
    elif name == "pso_step":
        x, pb = box(*shape), box(*shape)
        pbf = fit_of(pb)
        g = torch.gather(pb, -2, pbf.argmin(-1)[..., None, None].expand(
            *lead, 1, D)).squeeze(-2).contiguous()
        rows = [x, U(*shape) * 40.0 - 20.0, pb, pbf, U(*shape), U(*shape), g]
        tail = (fn, shift, 390.0, 0.6, 1.0, 1.0, 40.0, lo, hi)
    else:
        slot = box(*shape)
        slot_f = fit_of(slot)
        slot_f[..., :2] = torch.inf
        rows = [box(*shape), box(*shape), slot, slot_f,
                torch.randint(1, D, (*lead, P), generator=gen, device=c.dev), U(*lead, P),
                U(*shape), torch.randn(shape, generator=gen, device=c.dev)]
        tail = (fn, shift, 390.0, 0.7, 0.1, 20.0, lo, hi)
    if cast is not None:
        st = c.rt.autotune.STORAGE[cast]
        rows = [t.to(st) if i in ROW_OPERANDS[name] else t for i, t in enumerate(rows)]
        tail = (tail[0], tail[1].to(st), *tail[2:])
    return (*rows, *tail)


def _ulps(torch, got, want) -> tuple[bool, float]:
    """Stored elements: each within one bfloat16 ulp of the plain
    version's (NaN where NaN), and the share with equal bits."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    ok = bool((((g - w).abs() <= ulp) | (torch.isnan(g) & torch.isnan(w))).all())
    same = float((g.view(torch.int32) == w.view(torch.int32)).float().mean()) if g.numel() else 1.0
    return ok, same


def _check_stored(c: Ctx, name: str, label: str, dtype: str, got, want) -> float:
    """A kernel's stored (P, D) output against the plain version's: bitwise
    in float32 (the children, trials and positions carry no evaluation;
    de_step's mutation within 1e-5, as phase 1 holds it), within one ulp
    and the same bits on 99% of the elements in bfloat16."""
    torch = c.torch
    if got.numel() == 0:
        return 1.0
    pe = float((got.float() - want.float()).abs().nan_to_num().max())
    c.kern[name]["max_abs_err"] = max(c.kern[name]["max_abs_err"], pe)
    if dtype == "float32":
        require(pe < 1e-5 if name == "de_step" else pe == 0.0,
                f"{name} {label}: stored rows differ by {pe:.3g}")
        return 1.0
    ok, same = _ulps(torch, got, want)
    require(ok and same >= 0.99, f"{name} {label}: stored rows over one bfloat16 ulp "
            f"({ok}) or equal bits on {same:.4f} < 0.99")
    require(bool(torch.equal(got.to(torch.bfloat16).float(), got.float())),
            f"{name} {label}: stored rows not bfloat16-representable")
    return same


def _check_storage_case(c: Ctx, gen, name: str, shape, dtype: str) -> float:
    """Kernel ``name`` with KernelConfig(dtype=``dtype``) against its plain
    version at ``dtype`` on the same float32 inputs (the wrapper casts, as
    on the main path): fitness within phase 1's bounds, decisions equal on
    clear rows, stored rows as :func:`_check_stored`; the share of stored
    elements with equal bits."""
    torch, rt = c.torch, c.rt
    mod = getattr(rt, name)
    args = _pop_args(c, gen, name, shape)
    cfg = rt.KernelConfig(dtype=dtype)
    n_bf16 = mod.BF16_LAUNCHES
    got = getattr(mod, name)(*args, kernel_cfg=cfg)
    want = getattr(mod, f"{name}_ref")(*args, dtype=dtype)
    c.sync()
    require(mod.BF16_LAUNCHES == n_bf16 + (dtype == "bfloat16"),
            f"{name} {dtype}: the bfloat16 route was not counted")
    label = f"{dtype} {tuple(shape)}"
    if name == "bench_eval":
        rel = c.err(name, got, want)
        require(rel < 1e-5, f"{label}: bench_eval rel err {rel:.3g}")
        return 1.0
    s = lambda t: rt.bench_eval.storage(t, dtype)   # noqa: E731
    fn, shift, bias = args[FN_ARG[name]:FN_ARG[name] + 3]
    if name == "de_step":
        pop, fit, idx, u, jr = args[:5]
        trial = rt.de_step.trial_ref(s(pop), idx, s(u), jr, 0.5, 0.2, -100.0, 100.0)
        cand, comp, took, rtook = (rt.bench_eval.bench_eval_ref(trial, fn, s(shift), bias), fit,
                                   got[1] != fit, want[1] != fit)
        tol, stored, wstored, fits = 1e-5, got[0], want[0], (got[1], want[1])
    elif name == "eval_select":
        pop, fit, trial, th = args[:4]
        cand = rt.bench_eval.bench_eval_ref(trial, fn, shift, bias, dtype)
        comp, took, rtook = fit, got[2], want[2]
        tol, stored, wstored, fits = FUSED_TOL, got[0], want[0], (got[1], want[1])
        clear_th = _clear(torch, cand - fit, th) | ~torch.isfinite(th)
    elif name == "pso_step":
        pbf = args[3]
        cand, comp, took, rtook = want[2], pbf, got[4] != pbf, want[4] != pbf
        tol, stored, wstored, fits = FUSED_TOL, got[3], want[3], (got[2], want[2])
        for k in (0, 1):
            _check_stored(c, name, f"{label} {'xv'[k]}", dtype, got[k], want[k])
    else:
        slot_f = args[3]
        cand = torch.where(got[2], got[1], want[1])
        comp, took, rtook = slot_f, got[2], want[2]
        tol, stored, wstored, fits = FUSED_TOL, got[0], want[0], (got[1], want[1])
    clear = (cand.double() - comp.double()).abs() > tol * (comp.double().abs() + 1.0)
    clear |= ~torch.isfinite(comp)
    if name == "eval_select":
        clear &= clear_th
    near = _decide(c, name, label, took, rtook, clear)
    agree = took == rtook
    rel = c.err(name, fits[0][agree], fits[1][agree], absolute=False)
    require(rel < tol, f"{name} {label}: fitness rel err {rel:.3g}")
    same = _check_stored(c, name, label, dtype, stored[agree], wstored[agree])
    if near:
        log(f"phase 25: {name} {label}: near-tie rows deciding differently {near}")
    return same


def storage_check_shapes(c: Ctx) -> dict[str, set[tuple[int, ...]]]:
    """Every (kernel, shape) phase 25 launches: TUNER_SHAPES and their rows
    flattened to (R, D) (its measured sweep), and the runs of B."""
    out = {k: set(v) for k, v in TUNER_SHAPES.items()}
    for k, shapes in TUNER_SHAPES.items():
        out[k] |= {(math.prod(s[:-1]), s[-1]) for s in shapes}
    for r in (*STORAGE_RUNS, STORAGE_VS_CPU):
        for k, shapes in launch_shapes(r).items():
            out[k] |= shapes
    return out


def check_storage_kernels(c: Ctx) -> None:
    """A: the five population kernels in both storage types against their
    plain versions at every shape phase 25 launches them at."""
    gen = c.torch.Generator(device=c.dev).manual_seed(25)
    for name, shapes in storage_check_shapes(c).items():
        for dtype in STORAGES:
            same = [_check_storage_case(c, gen, name, shape, dtype) for shape in sorted(shapes)]
            log(f"phase 25: A, {name} {dtype} at {sorted(shapes)}: max rel err "
                f"{c.kern[name]['max_rel_err']:.3g}, least share of stored elements with "
                f"equal bits {min(same):.6f}")


def _storage_runs(c: Ctx) -> dict:
    """B: Table I's fused DE with bfloat16 storage on the main path (its
    launches, the bfloat16 route's, the best below the initial best), then
    in turns with the float32 route; the 2-island run card vs CPU."""
    rt = c.rt
    out = _run_main(c, 25, STORAGE_RUNS[0])
    bf16 = {k: getattr(rt, k).BF16_LAUNCHES for k in POP_KERNELS}
    require(bf16["de_step"] == out["launches"]["de_step"] > 0 and bf16["bench_eval"] >= 2,
            f"B: bfloat16 launches {bf16}, expected every de_step and bench_eval launch")
    ms, res = _in_turns(c, list(STORAGE_RUNS))
    for r in STORAGE_RUNS:
        arg = c.torch.as_tensor(res[r.label][0][0].arg)
        bits = bool(c.torch.equal(arg.to(c.torch.bfloat16).float(), arg.float()))
        require(bits == (r.storage == "bfloat16"),
                f"B: {r.label}: incumbent bfloat16-representable is {bits}")
    out["ms_per_gen_in_turns"] = ms
    out["best_in_turns"] = {k: v[0][0].value for k, v in res.items()}
    log(f"phase 25: B, {STORAGE_RUNS[0].label} in turns with {STORAGE_RUNS[1].label}: "
        f"ms/gen {json.dumps(ms)}, best {json.dumps(out['best_in_turns'])}, bfloat16 "
        f"launches {bf16}")
    _card_vs_cpu(c, 25, STORAGE_VS_CPU)
    return out


def _tuner_case(c: Ctx, gen, name: str, shape, dtype: str) -> dict:
    """C at one shape and storage type: the seconds of a first and of a
    cached ``choose``, the model's pick, the measured pick and
    launch_geometry's (pso_step: its fixed 256 threads), timed in turns
    (model, measured, heuristic, heuristic, measured, model) on inputs
    already in the storage type, so no cast is timed."""
    rt = c.rt
    at, be = rt.autotune, rt.bench_eval
    *lead, P, D = shape
    R = math.prod(lead) * P
    key = dict(dtype=dtype, device=c.dev)
    t0 = time.perf_counter()
    model = at.choose(name, R, D, "shifted_rosenbrock", **key)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(100):
        at.choose(name, R, D, "shifted_rosenbrock", **key)
    t_cached = (time.perf_counter() - t0) / 100
    measured = at.choose(name, R, D, "shifted_rosenbrock", measure=True, **key)
    if name == "pso_step":
        heur = rt.KernelConfig(threads=rt.pso_step.MAX_THREADS, dtype=dtype)
    else:
        g = be.launch_geometry(R, D, 16, be.sm_count(c.dev), at.STORAGE[dtype].itemsize)
        heur = rt.KernelConfig(vec=g.vec, warps_per_row=g.warps_per_row,
                               rows_per_block=g.rows_per_block, dtype=dtype)
    args = _pop_args(c, gen, name, shape, cast=dtype)
    fn = getattr(getattr(rt, name), name)
    picks = {"model": model, "measured": measured, "heuristic": heur}
    us = {k: [] for k in picks}
    for k in ("model", "measured", "heuristic", "heuristic", "measured", "model"):
        us[k].append(1e3 * time_ms(lambda: fn(*args, kernel_cfg=picks[k]),
                                   reps=TUNER_REPS, spin=TUNER_SPIN))
    pred = at.predict(name, R, D, model, "shifted_rosenbrock", card=at.rl.card_of(c.dev))
    return {"shape": list(shape), "storage": dtype, "choose_first_us": t_first * 1e6,
            "choose_cached_us": t_cached * 1e6,
            "picks": {k: {f: getattr(v, f) for f in at.GEOMETRY_FIELDS[name]}
                      for k, v in picks.items()},
            "us": {k: sum(v) / len(v) for k, v in us.items()}, "us_in_turns": us,
            "model_us": pred.t_total * 1e6}


def _tuner(c: Ctx) -> list[dict]:
    """C: the tuner at TUNER_SHAPES in both storage types, after a check
    that a second build of a shape class is a cache hit."""
    rt = c.rt
    at = rt.autotune
    at.clear_cache()
    pop = _pop_args(c, c.torch.Generator(device=c.dev).manual_seed(7), "bench_eval",
                    (POP, DIM))
    s0 = at.cache_stats()
    rt.bench_eval.bench_eval(*pop)
    s1 = at.cache_stats()
    rt.bench_eval.bench_eval(*pop)
    s2 = at.cache_stats()
    require(s1["misses"] == s0["misses"] + 1 and s2 == {**s1, "hits": s1["hits"] + 1},
            f"C: a second build was not a cache hit: {s0} {s1} {s2}")
    log(f"phase 25: C, cache on two builds of bench_eval {POP} x {DIM}: {s0} -> {s1} -> {s2}")
    gen = c.torch.Generator(device=c.dev).manual_seed(26)
    rows = []
    for name, shapes in TUNER_SHAPES.items():
        for dtype in STORAGES:
            for shape in shapes:
                r = _tuner_case(c, gen, name, shape, dtype)
                rows.append({"kernel": name, **r})
                log(f"phase 25: C, {name} {dtype} {tuple(shape)}: choose {r['choose_first_us']:.1f}"
                    f" us first, {r['choose_cached_us']:.2f} cached; picks {json.dumps(r['picks'])};"
                    f" us {json.dumps({k: round(v, 3) for k, v in r['us'].items()})}, model "
                    f"{r['model_us']:.2f}")
    stats = at.cache_stats()
    require(stats["measured"] == len(rows), f"C: {stats['measured']} measured sweeps, expected "
            f"{len(rows)}")
    log(f"phase 25: C, tuner cache {stats}")
    return rows


def phase_storage_tuner(c: Ctx) -> dict:
    """Phase 25: A, the bfloat16 storage route of the five population
    kernels against their plain versions (recorded as phase 1's checks, so
    the launches of B and C count as checked); B, Table I's fused DE with
    bfloat16 storage; C, the geometry tuner."""
    c.phase = 1
    try:
        check_storage_kernels(c)
    finally:
        c.phase = 25
    out = _storage_runs(c)
    out["tuner"] = _tuner(c)
    return out


SECOND_PROCESS_PHASES = frozenset({6, 10, 11, 12, 13, 14, 15, 19, 20, 21, 22, 23, 24})
# Seconds from the script's start after which the second process is killed
# (the script's whole limit is 1,200).
PART_TIMEOUT = 1100.0


class SecondProcess:
    """``chip_smoke.py --phases ... --part-out FILE`` started beside this
    process: its lines relayed to stdout whole, and at :meth:`join` its
    phases' launches, errors and launch shapes merged into ``c``."""

    def __init__(self, phases: set[int]):
        self.path = ROOT / "build" / "parts" / f"second-{os.getpid()}.pkl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.unlink(missing_ok=True)
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--phases", ",".join(str(n) for n in sorted(phases)),
             "--part-out", str(self.path)],
            stdout=subprocess.PIPE, text=True)
        self.relay = threading.Thread(target=self._relay, daemon=True)
        self.relay.start()

    def _relay(self) -> None:
        for line in self.proc.stdout:
            log(line.rstrip("\n"))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()

    def join(self, c: Ctx, timeout: float) -> bool:
        """Wait for the second process (killed after ``timeout`` seconds)
        and merge its record into ``c``; False if it failed."""
        try:
            rc = self.proc.wait(timeout=max(timeout, 1.0))
        except subprocess.TimeoutExpired:
            self.stop()
            log(f"FAILED: the second process was still running after {timeout:.0f} s")
            return False
        self.relay.join()
        if rc != 0 or not self.path.exists():
            log(f"FAILED: the second process exited {rc}")
            return False
        part = pickle.loads(self.path.read_bytes())
        for name, k in part["kern"].items():
            mine = c.kern[name]
            mine["launches"] += k["launches"]
            mine["max_abs_err"] = max(mine["max_abs_err"], k["max_abs_err"])
            mine["max_rel_err"] = max(mine["max_rel_err"], k["max_rel_err"])
        for num, shapes in part["shapes"].items():
            c.shapes.setdefault(num, set()).update(shapes)
        return part["ok"]


# The backward kernels' tensor-core libraries, by the kernel they serve.
TC_GRADIENT = {TC_LIBRARY[k]: k for k in GRADIENT_OF}


def log_ptxas(c: Ctx, _build) -> None:
    """The compiler's registers, shared memory and spills of every built
    library, logged and kept for the kernels line."""
    for name in (*KERNELS, *TC_LIBRARY.values()):
        if name in ROW_KERNELS:
            continue
        if name in GRADIENT_OF or name in TC_GRADIENT:
            # Both routes of a backward kernel, under the kernel's name.
            entries = ptxas_entries(_build.ptxas_report(name))
            c.kern[TC_GRADIENT.get(name, name)].setdefault("ptxas", {})[name] = entries
            log(f"ptxas {name}: {json.dumps(entries)}")
            continue
        if name.startswith("flash_attention"):
            # Every instance of both routes (the <256> ones among them):
            # registers, shared memory and spills.
            entries = ptxas_entries(_build.ptxas_report(name))
            c.kern["flash_attention"].setdefault("ptxas", {})[name] = entries
            log(f"ptxas {name}: {json.dumps(entries)}")
            continue
        regs = [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                if "registers" in ln]
        log(f"ptxas {name}: " + " | ".join(regs[:3]) + (" ..." if len(regs) > 3 else ""))
    for name in ROW_KERNELS:
        entries = ptxas_entries(_build.ptxas_report(name))
        c.kern[name]["ptxas"] = ptxas_summary(entries)
        log(f"ptxas {name}: {json.dumps(c.kern[name]['ptxas'])}")
    for name in POP_KERNELS:
        # The bfloat16 storage build of each population kernel.
        entries = ptxas_entries(_build.ptxas_report(f"{name}_bf16"))
        c.kern[name]["ptxas_bf16"] = ptxas_summary(entries)
        log(f"ptxas {name}_bf16: {json.dumps(c.kern[name]['ptxas_bf16'])}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(str(n) for n in range(1, 26)),
                    help="comma-separated phases to run (default: all)")
    # Internal: run as the second process, writing the record to this file.
    ap.add_argument("--part-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    part_out = args.part_out
    first = part_out is None       # the first process, not the second

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    rt = port_modules()
    _build = rt._build

    if not first:
        torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    kind = torch.cuda.get_device_name(0)
    rates = card_rates(kind)
    if first:
        log(f"card: {smi_line} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    c = Ctx(torch, rt)
    t_build = time.perf_counter()
    for name in KERNELS:               # the first builds every source at once
        _build.library(name)
    if first:
        log(f"build: {time.perf_counter() - t_build:.1f} s into {_build.build_dir()}")
        log_ptxas(c, _build)

    ok = True
    record_launch_shapes(c)
    steps = {1: phase_kernels, 2: phase_prng,
             **{n: run_main_phase(n) for n in MAIN_RUNS},
             **{n: card_vs_cpu_phase(n) for n in CARD_VS_CPU_RUNS},
             **{n: run_model_phase(n) for n in MODEL_RUNS},
             **{n: model_card_vs_cpu_phase(n) for n in CARD_VS_CPU_MODEL_RUNS},
             **{n: run_train_phase(n) for n in TRAIN_RUNS},
             **{n: train_card_vs_cpu_phase(n) for n in CARD_VS_CPU_TRAIN_RUNS},
             15: phase_hybrid, 16: phase_service, 17: phase_portfolio_async,
             18: phase_mesh, 25: phase_storage_tuner}
    # The second process's phases run beside this process's.
    second = phases & SECOND_PROCESS_PHASES if first else set()
    part = SecondProcess(second) if second and phases - second else None
    mine = phases - second if part else phases
    try:
        for num in sorted(steps):
            if num not in mine:
                continue
            c.phase = num
            t0 = time.perf_counter()
            try:
                steps[num](c)
            except PhaseFailed as e:
                ok = False
                log(f"phase {num} FAILED: {e}")
            log(f"phase {num}: {time.perf_counter() - t0:.1f} s")
        c.phase = None
        if part:
            t0 = time.perf_counter()
            ok = part.join(c, PART_TIMEOUT - (t0 - t_start)) and ok
            log(f"the second process ({', '.join(str(n) for n in sorted(second))}) ended "
                f"{time.perf_counter() - t0:.1f} s after this one's phases")
    finally:
        if part:
            part.stop()
    if not first:
        log(f"the second process's phases: {time.perf_counter() - t_start:.1f} s from its "
            "start")
        Path(part_out).write_bytes(pickle.dumps({
            "ok": ok, "shapes": c.shapes,
            "kern": {k: {f: v[f] for f in ("launches", "max_abs_err", "max_rel_err")}
                     for k, v in c.kern.items()}}))
        return 0
    if 1 in phases:
        try:
            kernel_timings(c, rates)
        except PhaseFailed as e:
            ok = False
            log(f"kernel timings FAILED: {e}")
        # Every shape a later phase launched a kernel at was checked in phase 1.
        checked = c.shapes.get(1, set())
        for num in sorted(phases - {1}):
            unchecked = sorted(c.shapes.get(num, set()) - checked)
            if unchecked:
                ok = False
                log(f"FAILED: phase {num} launched kernels at shapes phase 1 "
                    f"did not check against the plain versions: {unchecked}")
    # The main-path phases that must launch each kernel.
    for name, need in main_path_phases().items():
        if need & phases and c.kern[name]["launches"] == 0:
            ok = False
            log(f"FAILED: the main path never launched {name}")

    rows = []
    for name in KERNELS:
        k = c.kern[name]
        replaces = (PALLAS_SITES[name] if name in PALLAS_SITES else
                    f"{PALLAS_SITES[GRADIENT_OF[name]]} (its gradient; port-only, the JAX "
                    "package has no backward kernel)")
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{TC_LIBRARY.get(name, name)}.cu",
            "replaces": replaces, "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "max_rel_err": k["max_rel_err"],
            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
            "bound_ms": k.get("bound_ms"), "bound_by": k.get("bound_by"),
            "library_ms": k.get("library_ms")}
        if name in POP_KERNELS:
            # Every timed shape with its bound and geometry, in float32 and
            # bfloat16 storage (csrc/<name>_bf16.cu), and the compiler's
            # registers, shared memory and spills.
            row.update(shapes=k.get("shapes"), bf16_shapes=k.get("bf16_shapes"),
                       bf16_source=f"src/repro_torch/kernels/csrc/{name}_bf16.cu",
                       ptxas=k.get("ptxas"), ptxas_bf16=k.get("ptxas_bf16"))
        if name in TC_LIBRARY:
            # The CUDA-core design at the same shape (the float32 route), and
            # the tensor-core instructions in the bf16 route's SASS.
            row.update(cuda_core_ms=k.get("cuda_core_ms"), float32_source=f"src/repro_torch/kernels/"
                       f"csrc/{name}.cu", sass=k.get("sass"), shapes=k.get("shapes"),
                       ptxas=k.get("ptxas"))
        if name == "flash_attention":
            row.update(max_row_err=k.get("max_row_err"), planted_faults=k.get("planted_faults"))
        if name in GRADIENT_OF:
            row.update(shapes=k.get("shapes"), ptxas=k.get("ptxas"))
        rows.append(row)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included")
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
