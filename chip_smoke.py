#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py              # all phases
    python3 chip_smoke.py --phases 1,2 # a subset, for a quick check

The kernels are built from ``src/repro_torch/kernels/csrc`` with nvcc into
``build/`` on first use. Phases (any failure exits non-zero):

  1. each kernel against its plain PyTorch version on the card;
  2. the threefry draws on the card, bitwise against the CPU;
  3. Table I fused: 1 island, pop 800, shifted Rosenbrock-1000, 200 gens;
  4. Table I unfused: sync, 20 gens, and chunked, 100 gens
     (benchmarks/table1_de_scaling.py's setup);
  5. 8 islands x pop 800 x dim 1000, ring migration, fused, 100 gens;
  6. small runs (fused, sync, chunked) on the card against the same runs
     on the CPU.

Phases 3-5 are the main path: each run resets the kernels' launch counters,
drives ``IslandOptimizer.minimize`` and reads the counters right after. Each
phase then profiles a few rounds of a further run, init excluded, for the
device's busy time and idle share.
Before the last line it prints the card's name and power limit and one JSON
line describing every kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Data-sheet rates of the H100 SXM (NVIDIA H100 data sheet): memory bytes/s
# and dense float32 FLOP/s outside the tensor cores.
CARD_RATES = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}

# The main path's sizes: Table I's population and dimension, and the
# generations each main-path phase runs.
POP, DIM, SYNC_EVERY = 800, 1000, 10
GENS = {"fused": 200, "sync": 20, "chunked": 100, "islands": 100}

# bench_eval shapes checked against the plain version in phase 1: Table I's
# population, the chunked path's 100-row chunks, odd sizes, and the 8-island
# init (a grid of several waves).
EVAL_SHAPES = ((800, 1000), (130, 1000), (37, 100), (5, 1), (6400, 1000))

PALLAS_SITES = {
    "bench_eval": "src/repro/kernels/bench_eval.py:136",
    "de_step": "src/repro/kernels/de_step.py:85",
}


class PhaseFailed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str) -> tuple[float, float]:
    if name not in CARD_RATES:
        raise PhaseFailed(f"no data-sheet rates for card {name!r}")
    return CARD_RATES[name]


def time_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back runs, by CUDA
    events. A spin kernel first holds the card while the host enqueues the
    runs, so the events time the device work and not the host's launch
    rate (a ctypes launch costs the host tens of microseconds)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)     # ~0.1 s of device cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_rounds(c: "Ctx", make_opt, f, seed: int, timed: int = 2,
                   profiled: int = 2) -> dict:
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
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
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
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    gens = profiled * every
    busy_ms = sum(r[0] for r in rows) / 1e3 / gens
    wall_ms = (marks["profiled"] - marks["timed"]) * 1e3 / (timed * every)
    ours = {name: sum(t for t, k, _ in rows if f"{name}_kernel" in k) / 1e3 / gens
            for name in ("bench_eval", "de_step")}
    return {"timed_gens": timed * every, "profiled_gens": gens,
            "wall_ms_per_gen": wall_ms,
            "profiled_wall_ms_per_gen": (marks["end"] - marks["profiled"]) * 1e3 / gens,
            "device_busy_ms_per_gen": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else None,
            "device_launches_per_gen": sum(r[2] for r in rows) / gens,
            "port_kernels_device_ms_per_gen": ours,
            "top": [{"name": k[:160], "device_ms": t / 1e3, "count": n}
                    for t, k, n in rows[:6]]}


class Ctx:
    """What the phases share: modules, device, and the per-kernel record.
    ``max_abs_err`` is the fitness error for bench_eval and the population
    error for de_step (whose fitness error is kept relative)."""

    def __init__(self, torch, rt, dev: str = "cuda"):
        self.torch = torch
        self.rt = rt
        self.dev = torch.device(dev)
        self.kern = {k: {"launches": 0, "max_abs_err": 0.0, "max_rel_err": 0.0}
                     for k in ("bench_eval", "de_step")}

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
        self.rt.bench_eval.LAUNCHES = 0
        self.rt.de_step.LAUNCHES = 0

    def counts(self) -> dict[str, int]:
        return {"bench_eval": self.rt.bench_eval.LAUNCHES,
                "de_step": self.rt.de_step.LAUNCHES}

    def add_launches(self, counts: dict[str, int]) -> None:
        for k, v in counts.items():
            self.kern[k]["launches"] += v


def _uniform(torch, gen, shape, lo, hi, dev):
    return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev)


def port_modules() -> types.SimpleNamespace:
    """The port's modules the phases use, imported from ``src/``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.core import ExecutorConfig, IslandConfig, IslandOptimizer, de
    from repro_torch.functions import benchmarks as bm
    from repro_torch.kernels import _build, bench_eval, de_step
    return types.SimpleNamespace(
        prng=prng, de=de, bm=bm, bench_eval=bench_eval, de_step=de_step,
        _build=_build, ExecutorConfig=ExecutorConfig, IslandConfig=IslandConfig,
        IslandOptimizer=IslandOptimizer)


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
    100:200 of it, a view with a storage offset as the chunked path passes."""
    pop = _uniform(c.torch, gen, shape, lo, hi, c.dev)
    out = [(str(tuple(shape)), pop)]
    if tuple(shape) == (POP, DIM):
        view = pop[100:200]
        require(view.storage_offset() > 0, "row slice has no storage offset")
        out.append((f"rows 100:200 of {tuple(shape)}", view))
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
    log(f"phase 1: bench_eval 10 tags x {len(EVAL_SHAPES)} shapes + a row view, "
        f"shifted at 800 and 6400 rows + a row view: max rel err "
        f"{c.kern['bench_eval']['max_rel_err']:.3g}")

    cases = (("shifted_rosenbrock", (800, 1000)), ("rastrigin", (99, 333)),
             ("shifted_rosenbrock", (8, 800, 1000)))
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


def _table1_opt(c: Ctx, gens: int, n_islands: int = 1, round_callback=None,
                **params):
    """Table I's engine (pop 800, dim 1000, w 0.5, px 0.2, sync_every 10)
    for ``gens`` generations on the ``cuda`` backend."""
    rt = c.rt
    mig = "ring" if n_islands > 1 else "none"
    cfg = rt.IslandConfig(n_islands=n_islands, pop=POP, dim=DIM,
                          migration=mig, sync_every=SYNC_EVERY,
                          max_evals=n_islands * POP * (gens + 1))
    return rt.IslandOptimizer(
        rt.de.make, cfg, params={"w": 0.5, "px": 0.2, **params},
        exec_cfg=rt.ExecutorConfig(backend="cuda"),
        round_callback=round_callback, device=c.dev)


def _profile(c: Ctx, f, seed: int, n_islands: int = 1, **params) -> dict:
    """profile_rounds over Table I's engine with ``params``."""
    return profile_rounds(
        c, lambda gens, cb: _table1_opt(c, gens, n_islands, cb, **params), f, seed)


def _drive(c: Ctx, opt, f, seed: int):
    """Warm up with a one-round run of the same engine, then reset the
    counters, drive the full run and read the counters right after."""
    prng = c.rt.prng
    cfg = opt.cfg
    warm = type(opt)(opt.algo_maker, dataclasses.replace(
        cfg, max_evals=cfg.n_islands * cfg.pop * (cfg.sync_every + 1)),
        params=opt.params, exec_cfg=opt.exec_cfg, device=c.dev)
    warm.minimize(f, prng.PRNGKey(seed))
    c.sync()
    c.reset()
    t0 = time.perf_counter()
    res = opt.minimize(f, prng.PRNGKey(seed))
    c.sync()
    wall = time.perf_counter() - t0
    counts = c.counts()
    c.add_launches(counts)
    return res, wall, counts


def _init_best(c: Ctx, f, n_islands: int, seed: int) -> float:
    """Best fitness of the initial population the engine draws for ``seed``
    (the same keys as ``minimize``), by the plain objective."""
    prng = c.rt.prng
    ik = prng.split(prng.PRNGKey(seed, c.dev))[1]
    keys = prng.split(ik, n_islands) if n_islands > 1 else ik[None]
    pop = prng.uniform(keys, (POP, DIM), f.lo, f.hi)
    return float(f.fn(pop).min())


def phase_table1_fused(c: Ctx) -> dict:
    f = c.rt.bm.make_shifted_rosenbrock(DIM)
    opt = _table1_opt(c, GENS["fused"], fused=True)
    res, wall, counts = _drive(c, opt, f, 0)
    init_best = _init_best(c, f, 1, 0)
    require(counts["de_step"] == res.n_gens,
            f"de_step launched {counts['de_step']} times for {res.n_gens} gens")
    require(counts["bench_eval"] == 2,
            f"bench_eval launched {counts['bench_eval']} times, expected 2 at init")
    require(math.isfinite(res.value) and res.value < init_best,
            f"best {res.value} not below initial best {init_best}")
    out = {"gens": res.n_gens, "ms_per_gen": wall / res.n_gens * 1e3,
           "best": res.value, "init_best": init_best, "launches": counts}
    log(f"phase 3: Table I fused: {json.dumps(out)}")
    log(f"phase 3: profile, init excluded: {json.dumps(_profile(c, f, 0, fused=True))}")
    return out


def phase_table1_unfused(c: Ctx) -> dict:
    """Table I unfused: sync, then chunked (benchmarks/table1_de_scaling.py).
    The executor's retry evaluates every batch twice, so sync makes 2
    bench_eval launches per generation and chunked 2 per chunk."""
    f = c.rt.bm.make_shifted_rosenbrock(DIM)
    outs = {}
    for mode, per_gen in (("sync", 2), ("chunked", 16)):
        opt = _table1_opt(c, GENS[mode], barrier_mode=mode)
        res, wall, counts = _drive(c, opt, f, 0)
        require(counts["bench_eval"] == 2 + per_gen * res.n_gens,
                f"{mode}: bench_eval launched {counts['bench_eval']} times, "
                f"expected 2 + {per_gen} x {res.n_gens}")
        require(counts["de_step"] == 0, f"{mode} run launched de_step")
        require(math.isfinite(res.value), f"{mode}: best {res.value} not finite")
        out = outs[mode] = {
            "gens": res.n_gens, "ms_per_gen": wall / res.n_gens * 1e3,
            "best": res.value,
            "bench_eval_launches_per_gen": (counts["bench_eval"] - 2) / res.n_gens,
            "launches": counts}
        log(f"phase 4: Table I {mode}: {json.dumps(out)}")
    prof = _profile(c, f, 0, barrier_mode="chunked")
    log(f"phase 4: chunked profile, init excluded: {json.dumps(prof)}")
    return outs


def phase_islands(c: Ctx) -> dict:
    f = c.rt.bm.make_shifted_rosenbrock(DIM)
    opt = _table1_opt(c, GENS["islands"], n_islands=8, fused=True)
    res, wall, counts = _drive(c, opt, f, 1)
    init_best = _init_best(c, f, 8, 1)
    require(counts["de_step"] == res.n_gens,
            f"de_step launched {counts['de_step']} times for {res.n_gens} gens")
    require(math.isfinite(res.value) and res.value < init_best,
            f"best {res.value} not below initial best {init_best}")
    out = {"gens": res.n_gens, "ms_per_gen": wall / res.n_gens * 1e3,
           "best": res.value, "launches": counts}
    log(f"phase 5: 8 islands fused ring: {json.dumps(out)}")
    prof = _profile(c, f, 1, n_islands=8, fused=True)
    log(f"phase 5: profile, init excluded: {json.dumps(prof)}")
    return out


def phase_card_vs_cpu(c: Ctx) -> None:
    """4 islands x pop 60 x dim 100 on the card and on the CPU. Pop 60 makes
    chunks of 7 rows, so the ninth chunk is clamped onto the eighth."""
    import numpy as np
    rt = c.rt
    I, P, D, gens = 4, 60, 100, 40
    csz = P // 8
    n_chunks = -(-P // csz)
    require(P % csz != 0, "chunks do not overlap")
    f = rt.bm.make_shifted_rosenbrock(D)
    cases = (({"fused": True}, P, {"de_step": gens, "bench_eval": 2}),
             ({"barrier_mode": "sync"}, P, {"de_step": 0, "bench_eval": 2 + 2 * gens}),
             ({"barrier_mode": "chunked"}, csz * n_chunks,
              {"de_step": 0, "bench_eval": 2 + 2 * n_chunks * gens}))
    for params, evals_per_gen, want_counts in cases:
        res = {}
        for dev in (c.dev, "cpu"):
            cfg = rt.IslandConfig(n_islands=I, pop=P, dim=D, migration="ring",
                                  sync_every=SYNC_EVERY,
                                  max_evals=I * (P + evals_per_gen * gens))
            opt = rt.IslandOptimizer(rt.de.make, cfg,
                                     params={"w": 0.5, "px": 0.2, **params},
                                     exec_cfg=rt.ExecutorConfig(backend="cuda"),
                                     device=dev)
            c.reset()
            res[dev] = opt.minimize(f, rt.prng.PRNGKey(11))
            if dev == c.dev:
                counts = c.counts()
        a, b = res[c.dev], res["cpu"]
        rel = float(np.max(np.abs(a.history - b.history) / np.abs(b.history)))
        require(rel < 1e-4, f"card vs cpu {params}: history rel diff {rel:.3g}")
        require(a.n_evals == b.n_evals and a.n_gens == b.n_gens == gens,
                f"card vs cpu {params}: accounting differs")
        require(counts == want_counts,
                f"card vs cpu {params}: launches {counts}, expected {want_counts}")
        log(f"phase 6: card vs cpu {params}: history rel diff {rel:.3g}, "
            f"n_gens {a.n_gens}, n_evals {a.n_evals}, card launches {counts}")


def kernel_timings(c: Ctx, bw: float, flops: float) -> None:
    """Time each kernel and its plain version at the Table I shape and work
    out its bound from this run's inputs."""
    torch, rt = c.torch, c.rt
    be, ds = rt.bench_eval, rt.de_step
    gen = torch.Generator().manual_seed(1)
    P, D = 800, 1000
    shift = rt.bm.shift_vector(D, device=c.dev)
    pop = _uniform(torch, gen, (P, D), -100.0, 100.0, c.dev)
    ev = (pop, "shifted_rosenbrock", shift, 390.0)
    k = c.kern["bench_eval"]
    k["ms"] = time_ms(lambda: be.bench_eval(*ev))
    k["plain_ms"] = time_ms(lambda: be.bench_eval_ref(*ev))
    nbytes = 4 * (P * D + D + P)
    nops = 12 * P * D      # sub shift, +1, x0*x0, sub, square, *100, 1-x0, square, 2 adds, sum
    k.update(bound_ms=max(nbytes / bw, nops / flops) * 1e3,
             bound_by="bytes" if nbytes / bw >= nops / flops else "operations")

    fit = be.bench_eval_ref(*ev)
    u = torch.rand((P, D), generator=gen).to(c.dev)
    idx = ((torch.arange(P) + 1 + torch.randint(0, P - 1, (3, P), generator=gen)) % P).to(c.dev)
    jr = torch.randint(0, D, (P,), generator=gen).to(c.dev)
    args = (pop, fit, idx, u, jr, "shifted_rosenbrock", shift, 390.0, 0.5, 0.2,
            -100.0, 100.0)
    k = c.kern["de_step"]
    k["ms"] = time_ms(lambda: ds.de_step(*args))
    k["plain_ms"] = time_ms(lambda: ds.de_step_ref(*args))
    # pop, u in; pop out; fit, idx, jrand, shift in; fit out.
    nbytes = 4 * 3 * P * D + 8 * 4 * P + 4 * (D + 2 * P)
    n_cross = float(((u < 0.2).sum() + P))  # lanes that build a mutant
    nops = 12 * P * D + 4 * n_cross
    k.update(bound_ms=max(nbytes / bw, nops / flops) * 1e3,
             bound_by="bytes" if nbytes / bw >= nops / flops else "operations")
    for name in ("bench_eval", "de_step"):
        k = c.kern[name]
        log(f"timing {name} at (800, 1000): kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated phases to run (default: all)")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    rt = port_modules()
    _build = rt._build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    kind = torch.cuda.get_device_name(0)
    bw, flops = card_rates(kind)
    log(f"card: {smi_line} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    c = Ctx(torch, rt)
    t_build = time.perf_counter()
    _build.library("bench_eval")
    _build.library("de_step")
    log(f"build: {time.perf_counter() - t_build:.1f} s into {_build.build_dir()}")
    for name in ("bench_eval", "de_step"):
        regs = [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                if "registers" in ln]
        log(f"ptxas {name}: " + " | ".join(regs[:3]) + (" ..." if len(regs) > 3 else ""))

    ok = True
    steps = ((1, phase_kernels), (2, phase_prng), (3, phase_table1_fused),
             (4, phase_table1_unfused), (5, phase_islands), (6, phase_card_vs_cpu))
    for num, fn in steps:
        if num not in phases:
            continue
        t0 = time.perf_counter()
        try:
            fn(c)
        except PhaseFailed as e:
            ok = False
            log(f"phase {num} FAILED: {e}")
        log(f"phase {num}: {time.perf_counter() - t0:.1f} s")
    if 1 in phases:
        kernel_timings(c, bw, flops)
    if {3, 5} & phases and c.kern["de_step"]["launches"] == 0:
        ok = False
        log("FAILED: the main path never launched de_step")
    if {3, 4, 5} & phases and c.kern["bench_eval"]["launches"] == 0:
        ok = False
        log("FAILED: the main path never launched bench_eval")

    rows = []
    for name in ("bench_eval", "de_step"):
        k = c.kern[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": PALLAS_SITES[name], "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "max_rel_err": k["max_rel_err"],
            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
            "bound_ms": k.get("bound_ms"), "bound_by": k.get("bound_by"),
            "library_ms": None})
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
