"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper (``bench_eval``, ``de_step``, ``eval_select``, ``pso_step``,
``ga_step``, ``flash_attention``, ``ssd_scan``, and the two gradients
``flash_attention_bwd`` and ``ssd_scan_bwd``) dispatches on the tensor's
device: the plain version for a CPU tensor, the kernel (built from ``csrc/``
at first use) for a CUDA tensor. Importing this package builds nothing.

Exports: ``autotune`` (``KernelConfig`` and the geometry tuner), ``ops``
(the seven kernel functions), ``registry`` (``KernelSpec``, ``get_spec``).
Unlike ``repro.kernels``, the package does not bind the seven function
names over their modules: ``repro_torch.kernels.bench_eval`` is the module
(with its plain version, counters and geometry), and the functions are
``ops.bench_eval`` and the like.
"""
from repro_torch.kernels import autotune, ops, registry  # noqa: F401
from repro_torch.kernels.autotune import KernelConfig  # noqa: F401
from repro_torch.kernels.registry import KernelSpec, get_spec  # noqa: F401
