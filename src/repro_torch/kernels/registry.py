"""Per-function kernel registry (a copy of ``repro.kernels.registry``).

Maps benchmark-function names (keys of ``functions.benchmarks.FUNCTIONS`` plus
``shifted_rosenbrock``) to the kernel specs that can evaluate them. The
executor's ``cuda`` backend and the fused DE step both consult this table, so
adding a kernel body for a new testbed function is one ``register()`` call
(plus its device functions in ``csrc/eval_tile.cuh`` and
``csrc/eval_row.cuh``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """How the kernel layer evaluates one benchmark function.

    ``eval_tag`` is the branch selector of ``csrc/eval_tile.cuh`` and
    ``csrc/eval_row.cuh``; it is usually the function name itself but kept
    separate so several registered names can share one kernel body (e.g.
    shifted variants).  ``fused_de``
    marks the objective as usable inside the fused whole-generation kernels
    (``de_step`` now; the name predates the non-DE kernels, which reuse the
    same row evaluation, so one flag gates the lot and every current tag
    qualifies).
    """

    name: str
    eval_tag: str
    fused_de: bool = True


_REGISTRY: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    """Add (or replace) a function's kernel spec; returns it for chaining."""
    _REGISTRY[spec.name] = spec
    return spec


def supported(name: str) -> bool:
    """True when a kernel is registered for function ``name``."""
    return name in _REGISTRY


def registered() -> tuple[str, ...]:
    """Names with a kernel implementation, in registration order."""
    return tuple(_REGISTRY)


def get_spec(name: str) -> KernelSpec:
    """Kernel spec for ``name``; KeyError (with guidance) if unregistered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no kernel registered for function {name!r}; "
            f"registered: {sorted(_REGISTRY)} "
            f"(use ExecutorConfig(backend='torch') for unregistered functions)"
        ) from None


# The §V.B testbed coverage.  weierstrass is deliberately absent: its b^k
# arguments (3^20 ~ 3.5e9) exceed f32 argument-reduction precision, so a
# reordered kernel summation cannot hold a meaningful parity bound.
for _name in (
    "sphere",
    "rastrigin",
    "rosenbrock",
    "ackley",
    "shifted_rosenbrock",
    "griewank",
    "schwefel",
    "levy",
    "dropwave",
    "michalewicz",
):
    register(KernelSpec(name=_name, eval_tag=_name))
