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

``normal`` and ``categorical`` pass the uniform bits through ``erf_inv`` and
``log``, whose float32 results XLA computes with its own approximations. The
port follows XLA's ``erf_inv`` polynomial step by step and takes ``log`` in
float64, so its draws are within a few ulps of ``jax.random``'s rather than
equal to them (bounds in ``tests/test_torch_prng.py``), and still equal bit
for bit between the CPU and the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import f32

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


def _bits_pair(key: torch.Tensor, shape: tuple[int, ...], start: int = 0):
    """Both threefry words for the flat counters of ``shape``, per key:
    ``(..., *shape)`` each. The counter's high word is ``idx >> 32``.
    ``start`` offsets the counters: a block of rows of a larger draw, whose
    bits equal that draw's rows."""
    n = 1
    for s in shape:
        n *= s
    if start < 0 or start + n >= 2 ** 32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    idx = torch.arange(start, start + n, dtype=torch.int64, device=key.device).reshape(shape)
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


def random_bits(key: torch.Tensor, shape: tuple[int, ...], start: int = 0,
                width: int = 32) -> torch.Tensor:
    """``width`` (8, 16 or 32) random bits per element: ``(..., *shape)``
    unsigned values in int64, the flat counters from ``start``, as
    ``jax.random.bits`` gives them for uint8, uint16 and uint32: the
    narrower draws are the low bits of the 32-bit word."""
    if width not in (8, 16, 32):
        raise ValueError(f"random_bits width must be 8, 16 or 32, got {width}")
    b1, b2 = _bits_pair(key, tuple(shape), start)
    bits = b1 ^ b2
    return bits if width == 32 else bits & ((1 << width) - 1)


# The 16-bit float types: (random bits drawn, mantissa bits, the bits of
# 1.0). jax.random draws 8 bits for a type of fewer than 8 mantissa bits.
_FLOAT16 = {torch.bfloat16: (8, 7, 0x3F80), torch.float16: (16, 10, 0x3C00)}


def _round16(v: float, dtype: torch.dtype) -> float:
    """A Python float rounded to a 16-bit type, as a Python float."""
    return torch.tensor(float(v), dtype=dtype).item()


def _uniform16(key, shape, minval, maxval, start, dtype) -> torch.Tensor:
    """``jax.random.uniform`` in a 16-bit type: the bounds and their span
    rounded to the type; ``floats * span + lo`` with the product rounded
    to bfloat16 before the add, as XLA on the CPU computes it, where
    float16 adds to its exact product and rounds once. A bfloat16 or
    float16 operation of torch computes in float32 and rounds its result,
    on every device; the operands here are values of the type."""
    width, nmant, one = _FLOAT16[dtype]
    bits = random_bits(key, shape, start, width)
    floats = ((bits >> (width - nmant)) | one).to(torch.int16).view(dtype) - 1.0
    lo, hi = _round16(minval, dtype), _round16(maxval, dtype)
    span = _round16(hi - lo, dtype)
    if dtype == torch.bfloat16:
        out = floats * span + lo
    else:
        out = (floats.float() * span + lo).to(dtype)
    return torch.clamp(out, min=lo)


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0, start: int = 0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Draws in ``[minval, maxval)``, as ``jax.random.uniform``: the top 23
    bits fill a mantissa with exponent 0, giving ``[1, 2)``.

    XLA contracts ``floats * (hi - lo) + lo`` into one fused multiply-add,
    which ``f32.fma`` reproduces on every device. ``dtype`` bfloat16 or
    float16 draws as :func:`_uniform16`."""
    if dtype in _FLOAT16:
        return _uniform16(key, shape, minval, maxval, start, dtype)
    bits = random_bits(key, shape, start)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # Bounds as float32 values held in Python floats: no host-to-device copy.
    lo = f32.const(minval)
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(f32.fma(floats, span, lo), min=lo)


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


# XLA's ErfInv32 (M. Giles, "Approximating the erfinv function", GPU Gems
# vol. 2): one polynomial in w = -log1p(-x*x) below 5, one in sqrt(w) above.
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = f32.const(np.sqrt(2.0))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_TINY = float(np.finfo(np.float32).tiny)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` on (-1, 1), in XLA's order of operations: Horner
    steps as fused multiply-adds (XLA contracts them), ``log1p`` and
    ``sqrt`` rounded once from float64. ``normal`` never passes +-1, where XLA's version returns +-inf."""
    w = -f32.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, f32.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for a, b in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = f32.fma(p, w, torch.where(lt, a, b))
    return p * x


def normal(key: torch.Tensor, shape: tuple[int, ...], scale: float = 1.0,
           loc: torch.Tensor | float | None = None, start: int = 0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal draws ``(..., *shape)``, as ``jax.random.normal``:
    ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on ``(nextafter(-1, 0),
    1)``; the flat counters from ``start``.

    ``scale`` and ``loc`` give ``loc + scale * normal(key, shape)`` as XLA
    computes that expression with a constant ``scale``: it folds ``scale``
    into the ``sqrt(2)`` factor, and contracts the add of ``loc`` into one
    fused multiply-add.

    In bfloat16 or float16 (no ``scale`` or ``loc``), ``u`` is the type's
    uniform draw and XLA rounds ``erf_inv(u)``, taken in float32, to the
    type before the product with ``sqrt(2)`` in the type."""
    if dtype in _FLOAT16:
        if scale != 1.0 or loc is not None:
            raise ValueError("16-bit normal draws take no scale or loc")
        lo = -1.0 + 2.0 ** -(_FLOAT16[dtype][1] + 1)     # nextafter(-1, 0)
        u = uniform(key, shape, lo, 1.0, start, dtype)
        return _erf_inv(u.float()).to(dtype) * _round16(np.sqrt(2.0), dtype)
    e = _erf_inv(uniform(key, shape, _NORMAL_LO, 1.0, start))
    c = f32.const(np.float32(scale) * np.float32(_SQRT2))
    return e * c if loc is None else f32.fma(e, c, loc)


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 standard Gumbel draws ``(..., *shape)``, as
    ``jax.random.gumbel``: ``-log(-log(u))`` for ``u`` uniform on
    ``[tiny, 1)``, each ``log`` rounded once from float64."""
    return -f32.log(-f32.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape: tuple[int, ...]) -> torch.Tensor:
    """int64 samples ``(..., *shape)`` from ``softmax(logits)`` over its last
    axis, as ``jax.random.categorical(key, logits, shape=shape)`` (with
    replacement): the argmax of ``gumbel + logits``. ``logits`` is
    ``(..., n)``: one distribution per key."""
    n = logits.shape[-1]
    g = gumbel(key, (*shape, n))
    lg = logits.reshape(logits.shape[:-1] + (1,) * len(shape) + (n,))
    return torch.argmax(g + lg, dim=-1)
