"""popt-bench — the paper's own production workload (§V.A, Table I); a copy
of ``repro.configs.popt_bench``.

Single-island DDE on the CEC'2008 shifted Rosenbrock in 1000 dimensions,
population 800, 20000 generations, px=0.2, w=0.5, "non-determinism-ok".

``HYBRID_CONFIG`` is the same workload with the memetic polish layer on —
the paper's DDE+ASD-style hybrid: a sparse cadence and a small top-k keep
the polish share of the budget low, because one ASD event in 1000-D costs
``steps * (4*1000 + 8)`` evaluations per polished point.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PoptBenchConfig:
    dim: int = 1000
    pop: int = 800
    n_gens: int = 20_000
    w: float = 0.5
    px: float = 0.2
    strategy: str = "rand1bin"
    barrier_mode: str = "chunked"   # "non-determinism-ok" = true
    function: str = "shifted_rosenbrock"
    # hybrid memetic layer (IslandConfig.polish*); "none" = plain DDE
    polish: str = "none"
    polish_every: int = 8
    polish_topk: int = 2
    polish_steps: int = 2


CONFIG = PoptBenchConfig()
HYBRID_CONFIG = PoptBenchConfig(polish="asd")
