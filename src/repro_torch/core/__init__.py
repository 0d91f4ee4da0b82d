"""The paper's engine in PyTorch: island DE, GA, PSO and SA with their
executor and migration."""
from repro_torch.core import de, ga, pso, sa  # noqa: F401
from repro_torch.core.api import OptimizeResult, Optimizer, lexi_min  # noqa: F401
from repro_torch.core.executor import ExecutorConfig, make_batch_evaluator  # noqa: F401
from repro_torch.core.islands import (  # noqa: F401
    IslandConfig, IslandOptimizer, MetaHeuristic)

ALGORITHMS = {
    "de": de.make,
    "ga": ga.make,
    "pso": pso.make,
    "sa": sa.make,
}
