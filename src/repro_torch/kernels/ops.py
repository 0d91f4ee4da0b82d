"""The seven kernel entries in one namespace, as ``repro.kernels.ops`` has them.

Each is the wrapper of its module: a CPU tensor runs the plain PyTorch
version, a CUDA tensor the hand-written kernel. The reference's
``use_pallas`` switch has no counterpart: the tensor's device chooses, and
each module's ``*_ref`` is its plain version.
"""
from __future__ import annotations

from repro_torch.kernels.bench_eval import bench_eval  # noqa: F401
from repro_torch.kernels.de_step import de_step  # noqa: F401
from repro_torch.kernels.eval_select import eval_select  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.ga_step import ga_step  # noqa: F401
from repro_torch.kernels.pso_step import pso_step  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
