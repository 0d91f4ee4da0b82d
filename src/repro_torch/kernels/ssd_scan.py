"""The Mamba2 SSD scan: the ``ssd_scan`` CUDA kernel and its plain version.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas kernel) and of
``repro.kernels.ref.ssd_ref``: ``y_t = C_t . state_t`` with
``state_t = exp(dt_t A) state_{t-1} + B_t (x) (x_t dt_t)`` from a zero
float32 state, per row of xh ``(BH, S, P)``.

Bm and Cm are ``(BH, S, N)`` as in the Pallas signature, or ``(R, S, N)``
with ``BH = R * H``: row ``bh`` then reads row ``bh // H``, as Mamba2's one
B/C group is shared by the H heads of a batch row. The model passes them so;
expanding them to ``(BH, S, N)`` first would write and read H copies of
each, more memory traffic than the scan's own. A CPU tensor goes to
:func:`ssd_ref`. A CUDA tensor goes to a kernel chosen by its type:
bfloat16 to the chunked form on the tensor cores in ``csrc/ssd_scan_tc.cu``
(its own chunk of 64 steps, whatever ``chunk`` says; C B^T once per B/C row
and chunk into float32 scratch), float32 to the recurrence on the CUDA
cores in ``csrc/ssd_scan.cu``, whose float32 arithmetic the float32 bound
of 1e-4 needs. A ``meta`` tensor takes the card's route, autograd
included, up to the launch, which it replaces by a tally of the kernel's
work (``kernels.meta``).

On the card the wrapper takes part in autograd: when grad is enabled and
an input requires it, the backward is the ``ssd_scan_bwd`` kernel
(``kernels/ssd_scan_bwd.py``, head dims up to ``MAX_BWD_P``). On the CPU
the plain version is differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, meta

# Kernel launches in this process (plain-version calls are not counted), and
# those of them that went to the tensor-core (bfloat16) kernel.
LAUNCHES = 0
TC_LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (16, 32, 64, 128)   # N the kernels are built for
TC_CHUNK = 64                      # steps per chunk of the tensor-core kernel
MAX_BWD_P = 64                     # head dims the backward kernel takes


def per_row(m: torch.Tensor, BH: int) -> torch.Tensor:
    """Bm or Cm ``(R, S, N)`` expanded to ``(BH, S, N)``: row bh is row
    ``bh // (BH // R)``."""
    R = m.shape[0]
    if R == BH:
        return m
    if R < 1 or BH % R:
        raise ValueError(f"B/C rows {R} do not divide the scan rows {BH}")
    return m.repeat_interleave(BH // R, dim=0)


def ssd_ref(xh, dt, A, Bm, Cm):
    """Plain PyTorch version: the sequential recurrence in float32."""
    BH, S, P = xh.shape
    x, d, a = xh.float(), dt.float(), A.float()
    B, C = per_row(Bm, BH).float(), per_row(Cm, BH).float()
    state = torch.zeros((BH, B.shape[-1], P), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        dA = torch.exp(d[:, t] * a)
        state = state * dA[:, None, None] + B[:, t, :, None] * (x[:, t] * d[:, t, None])[:, None, :]
        ys.append(torch.einsum("bn,bnp->bp", C[:, t], state))
    if not ys:
        return torch.empty_like(xh)
    return torch.stack(ys, dim=1).to(xh.dtype)


def check_inputs(xh, dt, A, Bm, Cm) -> None:
    """Raise ValueError unless the kernels take these inputs on the card."""
    BH, S, P = xh.shape
    if xh.dtype not in DTYPES:
        raise ValueError(f"ssd_scan takes {list(DTYPES)}, got {xh.dtype}")
    R, N = Bm.shape[0], Bm.shape[-1]
    if N not in STATE_SIZES or R < 1 or BH % R:
        raise ValueError(f"ssd_scan: state size {N} (one of {STATE_SIZES}) and "
                         f"B/C rows {R} (dividing {BH})")
    dev = xh.device
    _build.check_inputs(dev, ("xh", xh, (BH, S, P)), ("Bm", Bm, (R, S, N)),
                        ("Cm", Cm, (R, S, N)), dtype=xh.dtype)
    _build.check_inputs(dev, ("dt", dt, (BH, S)), ("A", A, (BH,)))


def _launch(xh, dt, A, Bm, Cm):
    """The forward kernel on checked inputs."""
    BH, S, P = xh.shape
    R, N = Bm.shape[0], Bm.shape[-1]
    dev = xh.device
    y = torch.empty_like(xh)
    if y.numel() == 0:
        return y
    if dev.type == "meta":
        meta.tally("ssd_scan", *meta.ssd_work(BH, R, S, P, N, xh.element_size(), TC_CHUNK))
        return y
    global LAUNCHES, TC_LAUNCHES
    if xh.dtype == torch.bfloat16:
        cb = torch.empty((R, -(-S // TC_CHUNK), TC_CHUNK, TC_CHUNK),
                         dtype=torch.float32, device=dev)
        _build.launch("ssd_scan_tc", dev, xh, dt, A, Bm, Cm, y, cb, BH, S, P, N,
                      BH // R)
        TC_LAUNCHES += 1
    else:
        _build.launch("ssd_scan", dev, xh, dt, A, Bm, Cm, y, BH, S, P, N, BH // R,
                      DTYPES[xh.dtype])
    LAUNCHES += 1
    return y


class _SsdScan(torch.autograd.Function):
    """The forward kernel, keeping its inputs; the backward kernel for the
    gradient."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm):
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        return _launch(xh, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy):
        # Imported here: the backward module imports this one.
        from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd
        return ssd_scan_bwd(*ctx.saved_tensors, dy.contiguous())


def ssd_scan(xh, dt, A, Bm, Cm, chunk=128):
    """xh ``(BH, S, P)``; dt ``(BH, S)`` and A ``(BH,)`` float32; Bm, Cm
    ``(BH, S, N)`` or ``(BH // H, S, N)``. S must be a multiple of
    ``chunk``, as in the Pallas kernel. Returns y ``(BH, S, P)`` in xh's
    type, differentiable on every device (on the card for P up to
    ``MAX_BWD_P``)."""
    BH, S, P = xh.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk "
                         f"{chunk}: pad the sequence to the chunk size")
    if not (_build.on_meta("ssd_scan", xh, dims=(3,))
            or _build.on_card("ssd_scan", xh, dims=(3,))):
        return ssd_ref(xh, dt, A, Bm, Cm)
    check_inputs(xh, dt, A, Bm, Cm)
    ins = (xh, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        if P > MAX_BWD_P:
            raise ValueError(f"ssd_scan: the backward kernel takes head dims up to "
                             f"{MAX_BWD_P}, got {P}")
        return _SsdScan.apply(*ins)
    return _launch(*ins)
