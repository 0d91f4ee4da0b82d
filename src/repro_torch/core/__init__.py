"""The paper's engine in PyTorch: island DE, GA, PSO, SA, EA, FA, BH and MC
with their executor, migration, heterogeneous portfolios, async islands, the
memetic polish layer, the coupling of optimizers, the jobs axis and the
multi-job scheduler."""
from repro_torch.core import bh, de, ea, fa, ga, mc, pso, sa  # noqa: F401
from repro_torch.core import portfolio  # noqa: F401
from repro_torch.core.api import (  # noqa: F401
    ObserverHub, OptimizeResult, Optimizer, OptRequest, OptResponse, lexi_min)
from repro_torch.core.executor import ExecutorConfig, make_batch_evaluator  # noqa: F401
from repro_torch.core.islands import (  # noqa: F401
    AsyncSchedule, BucketStepper, IslandConfig, IslandOptimizer,
    MetaHeuristic)
from repro_torch.core.pipeline import (  # noqa: F401
    explore_then_polish, explore_then_polish_many)
from repro_torch.core.portfolio import AuxSlot, PolicySpec, Portfolio  # noqa: F401
from repro_torch.core.scheduler import (  # noqa: F401
    AbandonRun, SchedulerOverloaded, ShapeBucketScheduler, UnknownJob)

ALGORITHMS = {
    "de": de.make,
    "ga": ga.make,
    "pso": pso.make,
    "sa": sa.make,
    "fa": fa.make,
    "ea": ea.make,
    "bh": bh.make,
    "mc": mc.make,
}
