"""The gradient of the Mamba2 SSD scan: the ``ssd_scan_bwd`` CUDA kernel
and its plain version.

The JAX package has no backward kernel (its training path differentiates
the jnp chunked form); the port's models send the scan through the
``ssd_scan`` kernel, whose gradient on the card is this kernel
(``csrc/ssd_scan_bwd.cu``): from the scan's inputs and dy it returns dxh
(xh's type), ddt and dA (float32) and dBm, dCm ``(R, S, N)`` (Bm's type),
each B/C row's gradient summed over the H heads that share it in head
order, computed in float32 without atomics (two runs give the same bits).
The plain version is autograd of
:func:`repro_torch.kernels.ssd_scan.ssd_ref`, as ``jax.grad`` of
``repro.kernels.ref.ssd_ref`` is the reference's. ``ssd_scan``'s autograd
function calls :func:`ssd_scan_bwd`; a CPU tensor goes to the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import DTYPES, MAX_BWD_P, check_inputs, ssd_ref

# Kernel launches in this process (plain-version calls are not counted).
LAUNCHES = 0


def ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy):
    """Plain PyTorch version: autograd of the plain recurrence. Returns
    (dxh, ddt, dA, dBm, dCm) in the inputs' types."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (xh, dt, A, Bm, Cm)]
        return torch.autograd.grad(ssd_ref(*ins), ins, dy)


def ssd_scan_bwd(xh, dt, A, Bm, Cm, dy):
    """xh, dy ``(BH, S, P)``; dt ``(BH, S)`` and A ``(BH,)`` float32; Bm, Cm
    ``(R, S, N)`` with R dividing BH. Returns (dxh, ddt, dA, dBm, dCm)."""
    if not _build.on_card("ssd_scan_bwd", xh, dims=(3,)):
        return ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy)
    check_inputs(xh, dt, A, Bm, Cm)
    BH, S, P = xh.shape
    R, N = Bm.shape[0], Bm.shape[-1]
    if P > MAX_BWD_P:
        raise ValueError(f"ssd_scan_bwd takes head dims up to {MAX_BWD_P}, got {P}")
    dev = xh.device
    _build.check_inputs(dev, ("dy", dy, (BH, S, P)), dtype=xh.dtype)
    dx, ddt, dA = torch.empty_like(xh), torch.empty_like(dt), torch.empty_like(A)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    if dx.numel() == 0:
        return dx, ddt.zero_(), dA.zero_(), dBm.zero_(), dCm.zero_()
    part = torch.empty((2, BH, S, N), dtype=torch.float32, device=dev)
    global LAUNCHES
    _build.launch("ssd_scan_bwd", dev, xh, dt, A, Bm, Cm, dy, dx, ddt, dA, part[0], part[1],
                  dBm, dCm, BH, S, P, N, BH // R, DTYPES[xh.dtype])
    LAUNCHES += 1
    return dx, ddt, dA, dBm, dCm
