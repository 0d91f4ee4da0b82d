#!/usr/bin/env python3
"""Time de_step and pso_step with four formulations of their box clip, in
turns, on one card.

The kernels clip with ``popt::clip`` (``csrc/eval_tile.cuh``). This tool
copies ``csrc`` once per formulation into ``build/clip/<name>/``, replaces
the body of ``clip`` there, builds ``de_step.cu`` and ``pso_step.cu`` with
the package's nvcc flags, and times every build's C entry on the same
tensors at Table I's shape (800 x 1000, shifted Rosenbrock), in turns:
each formulation once in order, then once in reverse, ``--rounds`` times.

    python3 tools/clip_timings.py [--rounds 2] [--reps 200]

Formulations (only ``fminf`` turns a NaN into ``lo``; jnp.clip keeps it):
  fminf    fminf(fmaxf(x, lo), hi)                    de/pso's clip before
  select   x != x ? x : fminf(fmaxf(x, lo), hi)       ga_step's clip before
  ptx      max.NaN.f32 then min.NaN.f32 (inline PTX)  the clip in the tree
  compare  r = x < lo ? lo : x;  r > hi ? hi : r

Each output is held against the plain version first (the inputs hold no
NaN, so every formulation must agree). Times are ``chip_smoke.time_ms``
(CUDA events over back-to-back launches behind a spin kernel, L2-warm).
Prints the card's name and power limit, then one JSON line with each
formulation's times and the registers ptxas reports for the instantiation
the main path runs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
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
from repro_torch.kernels import pso_step as ps  # noqa: E402

BODIES = {
    "fminf": "return fminf(fmaxf(x, lo), hi);",
    "select": "return x != x ? x : fminf(fmaxf(x, lo), hi);",
    "ptx": None,   # the tree's own body
    "compare": "const float r = x < lo ? lo : x; return r > hi ? hi : r;",
}
CLIP = re.compile(r"(__device__ __forceinline__ float clip\(float x, float lo, float hi\) \{)"
                  r"(.*?)(\n\})", re.S)
FN, TAG, BIAS = "shifted_rosenbrock", 4, 390.0
P, D = cs.POP, cs.DIM
MAIN = {"de_step": "de_step_staged<4,4,2>", "pso_step": "pso_step_kernel<4>"}


def build(name: str, body: str | None) -> dict:
    """Copy csrc with ``clip``'s body replaced; build de_step and pso_step
    there (ptxas report kept); their launch entries and registers."""
    out = ROOT / "build" / "clip" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    if body is not None:
        hdr = out / "eval_tile.cuh"
        text, n = CLIP.subn(lambda m: m.group(1) + "\n  " + body + m.group(3),
                            hdr.read_text())
        if n != 1:
            raise RuntimeError("clip() not found in eval_tile.cuh")
        hdr.write_text(text)
    procs = {k: subprocess.Popen(
        [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(out),
         "-o", str(out / f"lib{k}.so"), str(out / f"{k}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in MAIN}
    fns, regs = {}, {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}/{k}.cu:\n{log[-4000:]}")
        fn_name, argtypes = _build.SIGNATURES[k]
        fn = getattr(ctypes.CDLL(str(out / f"lib{k}.so")), fn_name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        fns[k] = fn
        entry = {e["name"]: e for e in cs.ptxas_entries(log)}.get(MAIN[k])
        regs[k] = entry["registers"] if entry else None
    return {"fns": fns, "registers": regs}


def _call(fn, args) -> None:
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def cases(dev) -> dict:
    """(C-entry arguments, outputs, plain outputs) of each kernel."""
    gen = torch.Generator().manual_seed(3)
    shift = bm.shift_vector(D, device=dev)
    pop = cs._uniform(torch, gen, (P, D), -100.0, 100.0, dev)
    fit = be.bench_eval_ref(pop, FN, shift, BIAS)
    u = torch.rand((P, D), generator=gen).to(dev)
    idx = ((torch.arange(P) + 1 + torch.randint(0, P - 1, (3, P), generator=gen)) % P).to(dev)
    jr = torch.randint(0, D, (P,), generator=gen).to(dev)
    npop, nfit = torch.empty_like(pop), torch.empty_like(fit)
    g = be.geometry_for(P, D, pop, u, shift, npop)
    de_args = (pop, fit, idx, u, jr, shift, npop, nfit, P, P, D, TAG, BIAS, 0.5, 0.2,
               -100.0, 100.0, int(g.vec), g.warps_per_row, g.rows_per_block,
               g.slots_per_thread, int(g.staged))
    de_want = ds.de_step_ref(pop, fit, idx, u, jr, FN, shift, BIAS, 0.5, 0.2, -100.0, 100.0)
    x, v, pb = (cs._uniform(torch, gen, (P, D), -100.0, 100.0, dev) for _ in range(3))
    r1, r2 = (torch.rand((P, D), generator=gen).to(dev) for _ in range(2))
    pbf = be.bench_eval_ref(pb, FN, shift, BIAS)
    gb = pb[int(pbf.argmin())].contiguous()
    outs = [torch.empty_like(x) for _ in range(2)] + [torch.empty_like(pbf),
                                                     torch.empty_like(x), torch.empty_like(pbf)]
    kw = (BIAS, 0.6, 1.0, 1.0, 40.0, -100.0, 100.0)
    ps_args = (x, v, pb, pbf, r1, r2, gb, shift, *outs, P, P, D, TAG, *kw)
    ps_want = ps.pso_step_ref(x, v, pb, pbf, r1, r2, gb, FN, shift, *kw)
    return {"de_step": (de_args, (npop, nfit), de_want),
            "pso_step": (ps_args, tuple(outs), ps_want)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("clip_timings: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    builds = {n: build(n, b) for n, b in BODIES.items()}
    data = cases(dev)
    for n, b in builds.items():          # every build agrees with the plain version
        for k, (cargs, outs, want) in data.items():
            _call(b["fns"][k], cargs)
            torch.cuda.synchronize()
            for got, ref in zip(outs, want):
                rel = float(((got.double() - ref.double()).abs()
                             / (ref.double().abs() + 1.0)).max())
                if not rel < 1e-4:
                    raise RuntimeError(f"{n}/{k}: rel err {rel:.3g} against plain")
    times = {n: {k: [] for k in MAIN} for n in BODIES}
    order = list(BODIES)
    for _ in range(args.rounds):
        for n in order + order[::-1]:
            for k, (cargs, _, _) in data.items():
                fn = builds[n]["fns"][k]
                times[n][k].append(cs.time_ms(lambda: _call(fn, cargs), reps=args.reps))
    out = {n: {k: {"ms": sum(t) / len(t), "each_ms": t,
                   "registers": builds[n]["registers"][k]} for k, t in ts.items()}
           for n, ts in times.items()}
    print(smi)
    print(json.dumps({"shape": [P, D], "clip": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
