"""popt4jlib on PyTorch and CUDA — the port of the ``repro`` JAX package.

Module names follow ``repro`` so each counterpart is easy to find. The
package imports torch, numpy and the standard library only; its CUDA kernels
(``kernels/csrc``) are compiled at first use, never at import.

Entry points run on the card unless the caller passes ``device="cpu"``:
:func:`resolve_device` is the one place that rule lives.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and no GPU is present — there is no silent fallback to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no GPU is available; pass device=\"cpu\" "
            "to run the plain PyTorch path on the CPU")
    return dev
