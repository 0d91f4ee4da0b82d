"""The gradient of the Mamba2 SSD scan: the ``ssd_scan_bwd`` CUDA kernels
and their plain version.

The JAX package has no backward kernel (its training path differentiates
the jnp chunked form); the port's models send the scan through the
``ssd_scan`` kernel, whose gradient on the card is a kernel too: from the
scan's inputs and dy it returns dxh (xh's type), ddt and dA (float32) and
dBm, dCm ``(R, S, N)`` (Bm's type), each B/C row's gradient summed over the
H heads that share it in a fixed order, without atomics (two runs give the
same bits). A CPU tensor goes to the plain version, autograd of
:func:`repro_torch.kernels.ssd_scan.ssd_ref`, as ``jax.grad`` of
``repro.kernels.ref.ssd_ref`` is the reference's. A CUDA tensor goes to a
kernel by its type:

- bfloat16: the chunked form on the tensor cores in
  ``csrc/ssd_scan_bwd_tc.cu`` (mma.sync, chunks of ``TC_CHUNK`` steps in
  parallel, the chunk-entry states and their gradients in two short
  sequential passes, dB and dC summed over :func:`head_groups`' groups of
  heads), counted in ``TC_LAUNCHES``;
- float32: the recurrence on the CUDA cores in ``csrc/ssd_scan_bwd.cu``,
  whose float32 arithmetic the float32 bound of 1e-4 needs.

Both take every N of ``STATE_SIZES`` and head dims up to ``MAX_BWD_P``. A
``meta`` tensor gets empty gradients and a tally of the kernel's work
(``kernels.meta``). A launch that fails raises; nothing falls back to
another kernel or to the plain version. ``ssd_scan``'s autograd function
calls :func:`ssd_scan_bwd`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.ssd_scan import (DTYPES, MAX_BWD_P, TC_CHUNK, check_inputs,
                                          ssd_ref)

# Kernel launches in this process (plain-version calls are not counted), and
# those of them that went to the tensor-core kernel.
LAUNCHES = 0
TC_LAUNCHES = 0

# Blocks the tensor-core kernel's chunk pass fills at most: one wave of an
# H100's 132 SMs (one block of 512 threads an SM).
TC_TARGET_BLOCKS = 132


def head_groups(R: int, n_chunks: int, H: int) -> int:
    """Groups the H heads of each B/C row are split into by the tensor-core
    kernel's chunk pass (one block per chunk, B/C row and group, walking
    its heads in order): the largest divisor G of H with ``R * n_chunks *
    G <= TC_TARGET_BLOCKS`` (one wave), else 1. dB and dC are summed over a
    group's heads in order, then over the groups in order."""
    return max((G for G in range(1, H + 1)
                if H % G == 0 and R * n_chunks * G <= TC_TARGET_BLOCKS), default=1)


def ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy):
    """Plain PyTorch version: autograd of the plain recurrence. Returns
    (dxh, ddt, dA, dBm, dCm) in the inputs' types."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (xh, dt, A, Bm, Cm)]
        return torch.autograd.grad(ssd_ref(*ins), ins, dy)


def ssd_scan_bwd(xh, dt, A, Bm, Cm, dy):
    """xh, dy ``(BH, S, P)``; dt ``(BH, S)`` and A ``(BH,)`` float32; Bm, Cm
    ``(R, S, N)`` with R dividing BH. Returns (dxh, ddt, dA, dBm, dCm)."""
    if not (_build.on_meta("ssd_scan_bwd", xh, dims=(3,))
            or _build.on_card("ssd_scan_bwd", xh, dims=(3,))):
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
    if dev.type == "meta":
        meta.tally("ssd_scan_bwd", *meta.ssd_bwd_work(BH, R, S, P, N, xh.element_size()))
        return dx, ddt, dA, dBm, dCm
    H = BH // R
    global LAUNCHES, TC_LAUNCHES
    if xh.dtype == torch.bfloat16:
        nC = -(-S // TC_CHUNK)
        G = head_groups(R, nC, H)
        # The chunk-entry states and their gradients, P padded to 8.
        states = torch.empty((2, BH, max(nC - 1, 1), N, -(-P // 8) * 8),
                             dtype=torch.bfloat16, device=dev)
        dA_part = torch.empty((BH, nC), dtype=torch.float32, device=dev)
        part = torch.empty((2, R, G, S, N), dtype=torch.float32, device=dev)
        _build.launch("ssd_scan_bwd_tc", dev, xh, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm,
                      states[0], states[1], dA_part, part, BH, S, P, N, H, H // G)
        TC_LAUNCHES += 1
    else:
        part = torch.empty((2, BH, S, N), dtype=torch.float32, device=dev)
        _build.launch("ssd_scan_bwd", dev, xh, dt, A, Bm, Cm, dy, dx, ddt, dA, part[0],
                      part[1], dBm, dCm, BH, S, P, N, H, DTYPES[xh.dtype])
    LAUNCHES += 1
    return dx, ddt, dA, dBm, dCm
