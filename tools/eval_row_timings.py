#!/usr/bin/env python3
"""Time the kernels on csrc/eval_row.cuh (bench_eval, de_step, ga_step,
eval_select): against an older build of the same kernels, over launch
geometries, and against the launch floor.

Run from the root of a checkout on a machine with a Hopper GPU:

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/old
    python3 tools/eval_row_timings.py --old build/old/src/repro_torch/kernels/csrc

- ``floor``: the same timing of bench_eval on one row of one lane, and of
  a one-element ``zero_()``: what a launch costs the card when nothing is
  read.
- ``old_ms``/``new_ms`` (with ``--old``): the older sources of the
  kernels (the one-block-per-row design over ``eval_tile.cuh``, whose C
  entries take no geometry) built with the same nvcc flags into
  ``build/ab/``, timed in turns (old, new, new, old) with the current
  kernels at the geometry their wrapper picks; both through their C
  entries, on the same input and output tensors. ``wrapper_ms``: the
  current kernel through its wrapper, which allocates its outputs.
- ``sweep``: each kernel through its C entry at every geometry the kernel
  takes (16-byte or scalar slots, warps per row x rows per block up to 8
  warps, the staged kernels' slots per thread), beside the one the
  wrapper launches (``tuned_geometry``).

Shapes: every shape the main path launches each kernel at. bench_eval:
Table I's population (800 x 1000) and the chunked path's 100-row chunk;
de_step: 800 x 1000 and phase 5's 8 x 800 x 1000; ga_step: GA's wave of
200 offspring at pop 800, 8 islands of it and the 8-island steady state
(8 x 1 x 1000); eval_select: SA's 800 x 1000. All on shifted Rosenbrock
with Table I's w and px, GA's pc and pm, SA's Metropolis thresholds.
``--ga-dead`` makes a share of ga_step's slots dead, so that about as many
children take their slot as in the engine's runs.
Every time is ``chip_smoke.time_ms`` (CUDA events over back-to-back
launches behind a spin kernel, L2-warm). Each output is held against the
plain version before it is timed (``err``: 0 where rows are bit-exact,
decisions agree on clear rows and fitness is within 1e-4 relative; at
least 1 where a clear row decided differently). Prints the card's name
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
from repro_torch.kernels import eval_select as es  # noqa: E402
from repro_torch.kernels import ga_step as gs  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The older C entries: no geometry arguments.
OLD_SIGNATURES = {
    "bench_eval": ("bench_eval_launch", (_P, _P, _P, _I, _I, _I, _F, _P)),
    "de_step": ("de_step_launch", (*(_P,) * 8, _I, _I, _I, _I, *(_F,) * 5, _P)),
    "ga_step": ("ga_step_launch", (*(_P,) * 12, _I, _I, _I, *(_F,) * 6, _P)),
    "eval_select": ("eval_select_launch", (*(_P,) * 8, _I, _I, _I, _F, _P)),
}
FN, BIAS, W_DE, PX, LO, HI = "shifted_rosenbrock", 390.0, 0.5, 0.2, -100.0, 100.0
PC, PM, SIGMA = 0.7, 0.1, 20.0
TAG = be.EVAL_TAGS.index(FN)


def _nvcc(src: Path, out: Path) -> subprocess.Popen:
    """Start nvcc on ``src`` into ``out``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS,
         "-I", str(src.parent), "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(proc: subprocess.Popen, out: Path, signature, what: str):
    """Wait for ``proc``; the launch entry of the library it built."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what}:\n{log[-4000:]}")
    fn_name, argtypes = signature
    fn = getattr(ctypes.CDLL(str(out)), fn_name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def build_old(src: Path, names) -> dict:
    """Build the older sources of kernels ``names``; their launch entries."""
    out = ROOT / "build" / "ab"
    procs = {n: _nvcc(src / f"{n}.cu", out / f"lib{n}.so") for n in names}
    return {n: _load(p, out / f"lib{n}.so", OLD_SIGNATURES[n], f"the older {n}.cu")
            for n, p in procs.items()}


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


class _Deciding:
    """A kernel that writes rows, a fitness and a take/accept flag: its
    error against the plain version (``want``) on candidates ``cand``
    compared with ``comp``."""

    def err(self, got) -> float:
        (gr, gf, gd), (rr, rf, rd) = got, self.want
        agree = gd == rd
        d = (self.cand.double() - self.comp.double()).abs()
        clear = ~(d <= 1e-4 * (self.comp.double().abs() + 1.0))
        if not bool(agree[clear].all()):
            return 1.0 + float((~agree & clear).sum())
        return max(float((gr - rr).abs()[agree].max()), _rel(gf[agree], rf[agree]))

    def at(self, vec, W, R, K):
        slots = self.D // 4 if vec else self.D
        _build.launch(self.name, self.dev, *self._args(), vec, W, R, K,
                      int(slots <= 32 * W * K))
        return self.out

    def old(self, fn):
        _call(fn, *self._args())
        return self.out


class GaCase(_Deciding):
    """ga_step on ([I,] N, D) offspring: two parents, the slot rows they
    compete for, GA's pc and pm, a sigma of a tenth of the box; a share
    ``dead`` of the slots is dead (fitness +inf: every child takes it), as
    aging leaves them in the engine's runs."""

    name = "ga_step"

    def __init__(self, gen, shape, dev, dead=0.0):
        *lead, N, D = shape
        self.dev, self.D, self.R = dev, D, N * (lead[0] if lead else 1)
        self.p1, self.p2, self.slot = (cs._uniform(torch, gen, shape, LO, HI, dev)
                                       for _ in range(3))
        self.shift = bm.shift_vector(D, device=dev)
        self.slot_f = be.bench_eval_ref(self.slot, FN, self.shift, BIAS)
        self.slot_f[(torch.rand((*lead, N), generator=gen) < dead).to(dev)] = torch.inf
        self.cut = torch.randint(1, D, (*lead, N), generator=gen).to(dev)
        self.co = torch.rand((*lead, N), generator=gen).to(dev)
        self.um = torch.rand(shape, generator=gen).to(dev)
        self.nz = torch.randn(shape, generator=gen).to(dev)
        self.inputs = (self.p1, self.p2, self.slot, self.slot_f, self.cut, self.co, self.um,
                       self.nz, FN, self.shift, BIAS, PC, PM, SIGMA, LO, HI)
        self.out = (torch.empty_like(self.slot), torch.empty_like(self.slot_f),
                    torch.empty_like(self.slot_f, dtype=torch.bool))
        self.want = gs.ga_step_ref(*self.inputs)
        child = torch.clamp(gs.crossover(self.p1, self.p2, self.cut, self.co, PC)
                            + torch.where(self.um < PM, SIGMA * self.nz, 0.0), LO, HI)
        self.cand, self.comp = be.bench_eval_ref(child, FN, self.shift, BIAS), self.slot_f

    def _args(self):
        return (self.p1, self.p2, self.slot, self.slot_f, self.cut, self.co, self.um,
                self.nz, self.shift, *self.out, self.R, self.D, TAG, BIAS, PC, PM, SIGMA,
                LO, HI)

    def geometry(self):
        return be.tuned_geometry("ga_step", None, self.R, self.D, FN, self.p1, self.p2,
                                 self.slot, self.um, self.nz, self.shift, self.out[0])

    def new(self):
        return gs.ga_step(*self.inputs)


class EsCase(_Deciding):
    """eval_select on a (P, D) population, Metropolis thresholds (-100 ln
    u)."""

    name = "eval_select"

    def __init__(self, gen, shape, dev):
        P, D = shape
        self.dev, self.D, self.R = dev, D, P
        self.pop, self.trial = (cs._uniform(torch, gen, shape, LO, HI, dev) for _ in range(2))
        self.shift = bm.shift_vector(D, device=dev)
        self.fit = be.bench_eval_ref(self.pop, FN, self.shift, BIAS)
        self.th = -100.0 * torch.log(torch.rand(P, generator=gen)).to(dev)
        self.inputs = (self.pop, self.fit, self.trial, self.th, FN, self.shift, BIAS)
        self.out = (torch.empty_like(self.pop), torch.empty_like(self.fit),
                    torch.empty_like(self.fit, dtype=torch.bool))
        self.want = es.eval_select_ref(*self.inputs)
        self.cand = be.bench_eval_ref(self.trial, FN, self.shift, BIAS)
        self.comp = self.fit + torch.where(self.th > 0, self.th, 0.0)

    def _args(self):
        return (self.pop, self.fit, self.trial, self.th, self.shift, *self.out, self.R,
                self.D, TAG, BIAS)

    def geometry(self):
        return be.tuned_geometry("eval_select", None, self.R, self.D, FN, self.pop, self.trial,
                                 self.shift, self.out[0])

    def new(self):
        return es.eval_select(*self.inputs)


def geometries(name: str, D: int):
    """Every geometry the kernel takes at D (the staged kernels: staged
    ones only)."""
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


SHAPES = {"bench_eval": ((800, 1000), (100, 1000)),
          "de_step": ((800, 1000), (8, 800, 1000)),
          "ga_step": ((200, 1000), (8, 200, 1000), (8, 1, 1000)),
          "eval_select": ((800, 1000),)}


def _case(name, gen, shape, dev, dead):
    if name == "bench_eval":
        return EvalCase(gen, *shape, dev)
    if name == "ga_step":
        return GaCase(gen, shape, dev, dead)
    return {"de_step": DeCase, "eval_select": EsCase}[name](gen, shape, dev)


def _geometry(name, case):
    if name == "bench_eval":
        return be.tuned_geometry("bench_eval", None, case.P, case.D, FN, case.pop, case.shift)
    if name == "de_step":
        return be.tuned_geometry("de_step", None, case.R, case.D, FN, case.pop, case.u,
                                 case.shift)
    return case.geometry()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path,
                    help="directory of the older sources of the kernels")
    ap.add_argument("--kernels", default=",".join(SHAPES),
                    help="comma-separated kernels to time (default: all four)")
    ap.add_argument("--ga-dead", type=float, default=0.0,
                    help="share of ga_step's slots that are dead (default 0)")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eval_row_timings: no CUDA device", file=sys.stderr)
        return 2
    names = args.kernels.split(",")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    reps = args.reps
    result = {}

    one = EvalCase(gen, 1, 1, dev)
    tiny = torch.zeros(1, device=dev)
    result["floor"] = {"bench_eval_1x1_ms": cs.time_ms(one.new, reps=reps),
                       "zero_1_ms": cs.time_ms(tiny.zero_, reps=reps)}

    old = build_old(args.old, names) if args.old else None
    rows = []
    for name in names:
        for shape in SHAPES[name]:
            case = _case(name, gen, shape, dev, args.ga_dead)
            g = _geometry(name, case)
            picked = (int(g.vec), g.warps_per_row, g.rows_per_block, g.slots_per_thread)
            row = {"kernel": name, "shape": list(shape), "geometry": g._asdict(),
                   "err_new": case.err(case.new())}
            if isinstance(case, _Deciding):
                row["decided_share"] = float(case.want[2].float().mean())
            if old:
                row["err_old"] = case.err(case.old(old[name]))
                row["new_ms"], row["old_ms"], row["turns_old_new_new_old"] = cs._alternate(
                    lambda: case.old(old[name]), lambda: case.at(*picked), reps)
            row["wrapper_ms"] = cs.time_ms(case.new, reps=reps)
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
