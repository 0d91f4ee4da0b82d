"""Roofline terms on the card: the ``Roofline`` record and the H100's rates.

Counterpart of the ``Roofline`` record of ``repro.parallel.roofline``, with
the card's constants in place of the TPU's. ``kernels.autotune`` builds one
record per candidate geometry.

Not ported yet: ``analyze``, ``hlo_costs`` and ``collective_bytes``, the
half of the reference module that reads a compiled XLA program. They serve
the planning tools (``launch/dryrun.py``), which come later and will say
what takes the place of HLO on the card.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

# NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit: HBM bandwidth, and
# the peak rates of the CUDA cores in float32 and the tensor cores in
# bfloat16 (dense), bytes and operations a second.
HBM_BW = 3.35e12
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_BF16 = 989e12
# The shortest time of a kernel launched back to back on that card, seconds
# (an empty kernel, timed by tools/eval_row_timings.py).
LAUNCH_FLOOR_S = 2.21e-6


@dataclasses.dataclass
class Roofline:
    flops: float               # per device
    hbm_bytes: float           # per device
    coll_bytes: float          # per device
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    peak_bytes: float          # per-device high-water mark (a block's shared memory here)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Card:
    """The card a geometry is chosen for: its name, compute capability and
    streaming multiprocessors. :func:`card_of` reads them from a device."""

    name: str
    capability: tuple[int, int]
    sms: int


@functools.cache
def card_of(device: torch.device) -> Card:
    """The :class:`Card` of CUDA ``device``, from its device properties."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no card behind {device}: the tuner reads a CUDA device")
    props = torch.cuda.get_device_properties(device)
    return Card(props.name, (props.major, props.minor), props.multi_processor_count)


def roofline(flops: float, hbm_bytes: float, peak_bytes: float = 0.0, *,
             peak_flops: float = PEAK_FLOPS_F32) -> Roofline:
    """The record of a kernel that does ``flops`` at ``peak_flops`` and
    moves ``hbm_bytes`` at :data:`HBM_BW`; no collectives."""
    t_c = flops / peak_flops
    t_m = hbm_bytes / HBM_BW
    return Roofline(flops=flops, hbm_bytes=hbm_bytes, coll_bytes=0.0, t_compute=t_c,
                    t_memory=t_m, t_collective=0.0,
                    bottleneck="compute" if t_c >= t_m else "memory",
                    peak_bytes=float(peak_bytes))
