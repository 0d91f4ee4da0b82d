"""Counter-based threefry2x32 keys, bit-exact with ``jax.random``.

The engine's trajectories depend on its random draws, so the port reproduces
JAX's default PRNG exactly: the same seed gives the same bits in both
packages, and tests compare trajectories rather than statistics. This matches
``jax.random`` with ``jax_threefry_partitionable=True`` (the default since
jax 0.5).

A key is an ``int64`` tensor of shape ``(..., 2)`` holding two uint32 words.
Keys may be batched: every function accepts leading key dimensions and maps
over them (the counterpart of ``vmap`` over ``split``/``uniform``/``randint``),
so all islands draw in one call. uint32 arithmetic is emulated in int64 with
``& 0xFFFFFFFF`` after each add, shift and multiply; ``torch.uint32`` lacks
the operators this needs. Draws run on the key's device and give the same
bits on the CPU and on the card.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rounds(x0: torch.Tensor, x1: torch.Tensor, rots: tuple[int, ...]):
    for r in rots:
        x0 = (x0 + x1) & M32
        x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
        x1 = x0 ^ x1
    return x0, x1


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable uint32-in-int64 operands. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Key ``(2,)`` from a non-negative integer seed, as ``jax.random.PRNGKey``."""
    if seed < 0 or seed >= 2 ** 63:
        raise ValueError(f"seed must lie in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64,
                        device=device)


def _bits_pair(key: torch.Tensor, shape: tuple[int, ...]):
    """Both threefry words for the flat counters of ``shape``, per key:
    ``(..., *shape)`` each. The counter's high word is ``idx >> 32``."""
    n = 1
    for s in shape:
        n *= s
    if n >= 2 ** 32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    tail = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + tail)
    k2 = key[..., 1].reshape(key.shape[:-1] + tail)
    return threefry2x32(k1, k2, torch.zeros_like(idx), idx)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(..., 2)`` -> ``(..., num, 2)`` new keys, as ``jax.random.split``."""
    b1, b2 = _bits_pair(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``(..., 2)`` key with the uint32 ``data`` folded in, as
    ``jax.random.fold_in``."""
    z = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], z, z + (int(data) & M32))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element: ``(..., *shape)`` uint32 values in int64."""
    b1, b2 = _bits_pair(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 draws in ``[minval, maxval)``, as ``jax.random.uniform``:
    the top 23 bits fill a mantissa with exponent 0, giving ``[1, 2)``.

    XLA contracts ``floats * (hi - lo) + lo`` into one fused multiply-add;
    the product of two float32 values is exact in float64, so computing it
    there and rounding once gives the fused result on every device."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # Bounds as float32 values held in Python floats: no host-to-device copy.
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    scaled = (floats.double() * span + lo).float()
    return torch.clamp(scaled, min=lo)


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """int64 draws in ``[minval, maxval)``, as ``jax.random.randint`` with
    int32: two 32-bit words per value folded into the span by the same
    mod-2**32 multiplier arithmetic."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError("randint bounds must fit int32")
    span = 1 if maxval <= minval else maxval - minval
    if span >= 2 ** 31:
        raise ValueError("randint span must be below 2**31")
    ks = split(key)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    return off % span + minval
