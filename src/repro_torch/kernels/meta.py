"""The model kernels' work, and their route for ``meta`` tensors.

A ``meta`` tensor has a shape and a type and no data: the planning tools
(``parallel.roofline``, ``launch.dryrun``) trace a whole step on them.
``flash_attention``, ``ssd_scan`` and their two gradients take such a
tensor on a route of their own: it checks the inputs as the card's route
does, returns empty outputs of the kernel's shapes, launches nothing and
counts in no ``LAUNCHES``, and adds the kernel's work to every active tally
(:data:`TALLIES`). The work is what the kernels' bounds in ``PERF.md`` and
``chip_smoke.py`` count: each input read once and each output written once,
and the operations (two a multiply-add)

  flash_attention      4 hd a kept (query, key) pair a row
  flash_attention_bwd  10 hd a kept pair a row (S and dP recomputed, dV, dQ, dK)
  ssd_scan             the chunked form at the tensor-core kernel's chunk
  ssd_scan_bwd         8 BH S N P

whatever the input's type (the float32 routes do the same products on the
CUDA cores, the recurrence in place of the chunked form).
"""
from __future__ import annotations

import functools

import numpy as np

# Objects with ``kernel(name, flops, nbytes)``, told of every call of a
# meta route (``parallel.roofline.count`` adds itself while it is active).
TALLIES: list = []


def tally(name: str, flops: float, nbytes: float) -> None:
    for t in TALLIES:
        t.kernel(name, flops, nbytes)


@functools.lru_cache(maxsize=256)
def kept_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash kernels keep for S queries at positions
    0..S-1 over T keys at 0..T-1: key j for query i when ``j <= i`` (if
    causal) and ``i - j < window`` (if ``window > 0``)."""
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(S, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(BH: int, S: int, T: int, hd: int, itemsize: int, causal: bool,
               window: int, lse: bool) -> tuple[float, float]:
    """(operations, bytes) of one ``flash_attention``: q, k, v read, the
    output (and, when training, each row's float32 log-sum-exp) written."""
    nbytes = itemsize * 2 * BH * (S + T) * hd + (4 * BH * S if lse else 0)
    return 4.0 * BH * kept_pairs(S, T, causal, window) * hd, float(nbytes)


def flash_bwd_work(BH: int, S: int, T: int, hd: int, itemsize: int, causal: bool,
                   window: int) -> tuple[float, float]:
    """(operations, bytes) of one ``flash_attention_bwd``: q, k, v, the
    output, its gradient and the log-sum-exp read, dq, dk, dv written."""
    nbytes = itemsize * 4 * BH * (S + T) * hd + 4 * BH * S
    return 10.0 * BH * kept_pairs(S, T, causal, window) * hd, float(nbytes)


def ssd_work(BH: int, R: int, S: int, P: int, N: int, itemsize: int,
             chunk: int) -> tuple[float, float]:
    """(operations, bytes) of one ``ssd_scan``: x read and y written, B and
    C once per B/C row, dt and A (float32); the chunked form at ``chunk``:
    C B^T on the causal half of each (chunk, chunk) tile once per B/C row,
    its decay-weighted product with x dt per row, C times the carried state
    and the state update per row."""
    n_chunks = -(-S // chunk)
    nbytes = itemsize * (2 * BH * S * P + 2 * R * S * N) + 4 * BH * S + 4 * BH
    nops = (n_chunks * chunk * (chunk + 1) * (R * N + BH * P)
            + BH * n_chunks * 4 * chunk * N * P)
    return float(nops), float(nbytes)


def ssd_bwd_work(BH: int, R: int, S: int, P: int, N: int,
                 itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one ``ssd_scan_bwd``: x, dy, B and C, dt and
    A read, dx, dB, dC, ddt and dA written; 8 BH S N P operations (the two
    recurrences and four contractions)."""
    nbytes = itemsize * (3 * BH * S * P + 4 * R * S * N) + 4 * (2 * BH * S + 2 * BH)
    return 8.0 * BH * S * N * P, float(nbytes)
