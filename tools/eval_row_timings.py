#!/usr/bin/env python3
"""Time bench_eval and de_step: against an older build of the same kernels,
over launch geometries, and against the launch floor.

Run from the root of a checkout on a machine with a Hopper GPU:

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/old
    python3 tools/eval_row_timings.py --old build/old/src/repro_torch/kernels/csrc

- ``floor``: the same timing of bench_eval on one row of one lane, and of
  a one-element ``zero_()``: what a launch costs the card when nothing is
  read.
- ``ab`` (with ``--old``): the older sources (``bench_eval.cu``,
  ``de_step.cu`` and what they include: the one-block-per-row design
  before ``eval_row.cuh``) built with the same nvcc flags into
  ``build/ab/`` and called through their own C entries, timed in turns
  with the wrappers (old, new, new, old).
- ``sweep``: each kernel through its C entry at every geometry the kernel
  takes (16-byte or scalar slots, warps per row x rows per block up to 8
  warps, de_step's slots per thread), beside the one
  ``launch_geometry`` picks.

Shapes: Table I's population (800 x 1000) and the other shape the main
path launches each kernel at (bench_eval: the chunked path's 100-row
chunk; de_step: phase 5's 8 x 800 x 1000 stack), on shifted Rosenbrock
with Table I's w and px. Every time is ``chip_smoke.time_ms`` (CUDA events
over back-to-back launches behind a spin kernel, L2-warm). Each output is
held against the plain version before it is timed. Prints the card's name
and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.functions import benchmarks as bm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import de_step as ds  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The older C entries: no geometry arguments.
OLD_SIGNATURES = {
    "bench_eval": ("bench_eval_launch", (_P, _P, _P, _I, _I, _I, _F, _P)),
    "de_step": ("de_step_launch", (*(_P,) * 8, _I, _I, _I, _I, *(_F,) * 5, _P)),
}
FN, BIAS, W_DE, PX, LO, HI = "shifted_rosenbrock", 390.0, 0.5, 0.2, -100.0, 100.0
TAG = be.EVAL_TAGS.index(FN)


def build_old(src: Path) -> dict:
    """Build the older bench_eval.cu and de_step.cu; their launch entries."""
    out = ROOT / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.cuda_tool("nvcc")
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-I", str(src), "-o", str(out / f"lib{name}.so"),
         str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in OLD_SIGNATURES}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the older {name}.cu:\n{log[-4000:]}")
        fn_name, argtypes = OLD_SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), fn_name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, *args) -> None:
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def _rel(a, b) -> float:
    return float(((a.double() - b.double()).abs() / (b.double().abs() + 1.0)).max())


class EvalCase:
    """bench_eval on a (P, D) population."""

    def __init__(self, gen, P, D, dev):
        self.P, self.D = P, D
        self.pop = cs._uniform(torch, gen, (P, D), -100.0, 100.0, dev)
        self.shift = bm.shift_vector(D, device=dev)
        self.out = torch.empty(P, device=dev)
        self.want = be.bench_eval_ref(self.pop, FN, self.shift, BIAS)

    def new(self):
        return be.bench_eval(self.pop, FN, self.shift, BIAS)

    def old(self, fn):
        _call(fn, self.pop, self.shift, self.out, self.P, self.D, TAG, BIAS)
        return self.out

    def at(self, vec, W, R, K=None):
        _build.launch("bench_eval", self.pop.device, self.pop, self.shift, self.out,
                      self.P, self.D, TAG, BIAS, vec, W, R)
        return self.out

    def err(self, got) -> float:
        return _rel(got, self.want)


class DeCase:
    """de_step on a ([I,] P, D) population."""

    def __init__(self, gen, shape, dev):
        *lead, P, D = shape
        self.P, self.D, self.R = P, D, P * (lead[0] if lead else 1)
        self.pop = cs._uniform(torch, gen, shape, -100.0, 100.0, dev)
        self.shift = bm.shift_vector(D, device=dev)
        self.fit = be.bench_eval_ref(self.pop, FN, self.shift, BIAS)
        self.u = torch.rand(shape, generator=gen).to(dev)
        self.idx = ((torch.arange(P) + 1
                     + torch.randint(0, P - 1, (3, *lead, P), generator=gen)) % P).to(dev)
        self.jr = torch.randint(0, D, (*lead, P), generator=gen).to(dev)
        self.npop, self.nfit = torch.empty_like(self.pop), torch.empty_like(self.fit)
        self.kw = (FN, self.shift, BIAS, W_DE, PX, LO, HI)
        self.want = ds.de_step_ref(self.pop, self.fit, self.idx, self.u, self.jr, *self.kw)

    def _args(self):
        return (self.pop, self.fit, self.idx, self.u, self.jr, self.shift, self.npop,
                self.nfit, self.R, self.P, self.D, TAG, BIAS, W_DE, PX, LO, HI)

    def new(self):
        return ds.de_step(self.pop, self.fit, self.idx, self.u, self.jr, *self.kw)

    def old(self, fn):
        _call(fn, *self._args())
        return self.npop, self.nfit

    def at(self, vec, W, R, K):
        slots = self.D // 4 if vec else self.D
        staged = int(slots <= 32 * W * K)
        _build.launch("de_step", self.pop.device, *self._args(), vec, W, R, K, staged)
        return self.npop, self.nfit

    def err(self, got) -> float:
        """Population and fitness error where the selections agree."""
        (gp, gf), (rp, rf) = got, self.want
        agree = (gf != self.fit) == (rf != self.fit)
        return max(float((gp - rp).abs()[agree].max()), _rel(gf[agree], rf[agree]))


def geometries(name: str, D: int):
    """Every geometry the kernel takes at D (de_step: staged ones only)."""
    for vec in (1, 0):
        for W in (1, 2, 4, 8):
            for R in (1, 2, 4, 8):
                if W * R > be.MAX_BLOCK_WARPS:
                    continue
                slots = D // 4 if vec else D
                iters = -(-slots // (32 * W))
                if name == "bench_eval":
                    yield vec, W, R, None
                elif iters <= be.MAX_SLOTS:
                    yield vec, W, R, be.slots_per_thread(iters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path,
                    help="directory of the older bench_eval.cu and de_step.cu")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eval_row_timings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    reps = args.reps
    result = {}

    one = EvalCase(gen, 1, 1, dev)
    tiny = torch.zeros(1, device=dev)
    result["floor"] = {"bench_eval_1x1_ms": cs.time_ms(one.new, reps=reps),
                       "zero_1_ms": cs.time_ms(tiny.zero_, reps=reps)}

    cases = [("bench_eval", (P, 1000), EvalCase(gen, P, 1000, dev)) for P in (800, 100)]
    cases += [("de_step", shape, DeCase(gen, shape, dev))
              for shape in ((800, 1000), (8, 800, 1000))]
    old = build_old(args.old) if args.old else None
    rows = []
    for name, shape, case in cases:
        row = {"kernel": name, "shape": list(shape),
               "geometry": be.geometry_for(case.R if name == "de_step" else case.P, case.D,
                                           case.pop, case.shift)._asdict(),
               "err_new": case.err(case.new())}
        if old:
            row["err_old"] = case.err(case.old(old[name]))
            row["new_ms"], row["old_ms"], row["turns_old_new_new_old"] = cs._alternate(
                lambda: case.old(old[name]), case.new, reps)
        else:
            row["new_ms"] = cs.time_ms(case.new, reps=reps)
        if not args.no_sweep:
            sweep = []
            for vec, W, R, K in geometries(name, case.D):
                err = case.err(case.at(vec, W, R, K))
                sweep.append({"vec": vec, "W": W, "R": R, "K": K, "err": err,
                              "ms": cs.time_ms(lambda: case.at(vec, W, R, K), reps=reps)})
            row["sweep"] = sorted(sweep, key=lambda s: s["ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    result["kernels"] = rows
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"eval_row_timings": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
