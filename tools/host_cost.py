"""Host and device cost of the population kernels' wrappers, for comparing two trees.

Imports ``repro_torch`` from ``--src`` (a tree's ``src/``), so the same
script times the current tree and an older one unpacked beside it (``git
archive``). Run it in turns, one process a tree (old, new, new, old); each
process prints one JSON line:

- ``host_us``: host microseconds per wrapper call, ``CALLS`` calls back to
  back with one synchronise at the end (the kernels take 3-6 µs, the host
  tens, so this is the wrapper's own cost: argument checks, geometry,
  allocation, launch). bench_eval at the chunked path's 100 x 1000 and
  Table I's 800 x 1000, de_step at 800 x 1000; the best of ``REPS``.
- ``device_us``: bench_eval's kernel at 100 and 800 rows, CUDA events over
  ``SAMPLE`` launches behind a spin kernel, best of ``REPS``.
- ``geometry_us`` (a tree with ``tuned_geometry``): host microseconds of
  the geometry step alone, in one process and in turns, best of ``REPS``
  rounds of ``CALLS`` calls each: ``launch_geometry`` as the wrappers took
  it before the tuner (pointer alignment, SM count, the arithmetic)
  against ``tuned_geometry`` (pointer alignment, ``autotune.resolve``'s
  cached lookup, ``geometry``), for bench_eval at 800 x 1000.
- ``chunked_ms_per_gen``: Table I's chunked DE (``launch.table1``, pop 800,
  dim 1000, shifted Rosenbrock; 16 bench_eval launches a generation) for
  ``--gens`` generations after a warm-up run, host clock, each of ``RUNS``.

    python tools/host_cost.py --src src [--gens 50] [--label new]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CALLS = 2000
REPS = 5
SAMPLE = 20
RUNS = 2
SPIN_CYCLES = 5_000_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src/ directory")
    ap.add_argument("--gens", type=int, default=50)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.configs.popt_bench import CONFIG
    from repro_torch.functions import benchmarks as bm
    from repro_torch.kernels import bench_eval as be
    from repro_torch.kernels import de_step as ds
    from repro_torch.launch import table1

    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shift = bm.shift_vector(1000, device=dev)
    fn = "shifted_rosenbrock"

    def rows(P):
        return torch.rand(P, 1000, generator=gen, device=dev) * 200.0 - 100.0

    pop100, pop800 = rows(100), rows(800)
    fit = be.bench_eval(pop800, fn, shift, 390.0)
    u = torch.rand(800, 1000, generator=gen, device=dev)
    i = torch.arange(800, device=dev)
    idx = torch.stack([(i + 1) % 800, (i + 2) % 800, (i + 3) % 800])
    jr = torch.zeros(800, dtype=torch.int64, device=dev)
    calls = {
        "bench_eval 100 x 1000": lambda: be.bench_eval(pop100, fn, shift, 390.0),
        "bench_eval 800 x 1000": lambda: be.bench_eval(pop800, fn, shift, 390.0),
        "de_step 800 x 1000": lambda: ds.de_step(pop800, fit, idx, u, jr, fn, shift, 390.0),
    }
    host = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / CALLS)
        host[name] = best * 1e6
    device = {}
    stream = torch.cuda.current_stream(dev)
    for name in ("bench_eval 100 x 1000", "bench_eval 800 x 1000"):
        best = float("inf")
        for _ in range(REPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)
            start.record(stream)
            for _ in range(SAMPLE):
                calls[name]()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / SAMPLE)
        device[name] = best
    geometry = {}
    if hasattr(be, "tuned_geometry"):
        steps = {
            "launch_geometry": lambda: be.launch_geometry(
                800, 1000, be.pointer_alignment(pop800, shift),
                torch.cuda.get_device_properties(dev).multi_processor_count,
                pop800.element_size()),
            "tuned_geometry": lambda: be.tuned_geometry("bench_eval", None, 800, 1000, fn,
                                                        pop800, shift),
        }
        geometry = {name: float("inf") for name in steps}
        for _ in range(REPS):
            for name, step in steps.items():
                step()
                t0 = time.perf_counter()
                for _ in range(CALLS):
                    step()
                geometry[name] = min(geometry[name], (time.perf_counter() - t0) / CALLS * 1e6)
    table1.measure_single_device(CONFIG, 10, device=dev)
    chunked = [table1.measure_single_device(CONFIG, args.gens, device=dev)["ms_per_gen"]
               for _ in range(RUNS)]
    print(json.dumps({"label": args.label, "src": args.src, "host_us": host,
                      "device_us": device, "geometry_us": geometry,
                      "chunked_ms_per_gen": chunked,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
