"""Benchmark test functions from popt4jlib §V.B (a)–(k), in PyTorch.

The counterpart of ``repro.functions.benchmarks``. Every function is written
batched over leading axes: it maps a ``(..., dim)`` float32 tensor to
``(...)``, which takes the place of ``vmap`` over a population. Definitions
follow the classical (unshifted, unrotated) forms the paper uses, plus the
CEC'2008 shifted Rosenbrock of §V.A; LND1–LND7 are Haarala's large-scale
nonsmooth problems [14].

Scalar constants are applied in the JAX package's order (``2π`` folded in
double precision first, integer powers by repeated squaring) so that the two
packages agree to float32 rounding.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import weakref
from typing import Callable

import torch

from repro_torch import prng

Tensor = torch.Tensor

# Stable identity tokens for objective callables (see fn_token): weak
# references, so tokening never extends an objective's lifetime, and a
# monotonic counter, so a token is never reused the way ``id()`` is.
_FN_TOKENS: "weakref.WeakKeyDictionary[Callable, int]" = weakref.WeakKeyDictionary()
_FN_TOKEN_PINS: list[tuple[Callable, int]] = []   # non-weakref-able callables
_FN_TOKEN_COUNTER = itertools.count()


def fn_token(fn: Callable) -> int:
    """GC-stable identity token for an objective callable (evaluator caches
    key on it; ``id(fn)`` is unsound because CPython recycles addresses)."""
    try:
        tok = _FN_TOKENS.get(fn)
        if tok is None:
            tok = next(_FN_TOKEN_COUNTER)
            _FN_TOKENS[fn] = tok
        return tok
    except TypeError:
        for obj, tok in _FN_TOKEN_PINS:
            if obj is fn:
                return tok
        tok = next(_FN_TOKEN_COUNTER)
        _FN_TOKEN_PINS.append((fn, tok))
        return tok


@dataclasses.dataclass(frozen=True)
class Function:
    """popt4jlib ``FunctionIntf``: a real-valued objective on a box.

    ``fn`` maps ``(..., dim)`` -> ``(...)``. ``shift``/``bias`` carry the
    CEC'2008 offset (a CPU float32 tensor) so the ``cuda`` evaluation backend
    can hand it to the kernel, whose tags implement the unshifted forms.
    """

    name: str
    fn: Callable[[Tensor], Tensor]
    lo: float
    hi: float
    f_star: float = 0.0  # known global optimum value (for reporting only)
    smooth: bool = True
    shift: Tensor | None = dataclasses.field(default=None, compare=False)
    bias: float = 0.0
    # Per-device copies of ``shift``, made on first use.
    _shift_copies: dict = dataclasses.field(default_factory=dict, compare=False,
                                            repr=False)

    def __call__(self, x: Tensor) -> Tensor:
        return self.fn(x)

    def eval_population(self, pop: Tensor) -> Tensor:
        """Evaluate a ``(P, dim)`` population -> ``(P,)`` fitness."""
        return self.fn(pop)

    def shift_on(self, device: torch.device) -> Tensor | None:
        """The shift vector on ``device`` (copied once per device)."""
        if self.shift is None:
            return None
        return on_device(self.shift, device, self._shift_copies)

    def cache_token(self) -> tuple:
        """Evaluator cache key: name, callable identity, shift by content,
        and bias."""
        shift = None if self.shift is None else self.shift.numpy().tobytes()
        return (self.name, fn_token(self.fn), shift, self.bias)


def on_device(t: Tensor, device: torch.device, copies: dict) -> Tensor:
    """``t`` on ``device``, copied once and kept in ``copies`` (keyed by
    device), so an objective's constant moves to the card once."""
    if t.device == device:
        return t
    hit = copies.get(device)
    if hit is None:
        hit = copies[device] = t.to(device)
    return hit


def _arange1(x: Tensor) -> Tensor:
    return torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)


def _pow20(s: Tensor) -> Tensor:
    """``s ** 20`` as ``lax.integer_pow`` computes it: ``s**4 * s**16``."""
    s2 = s * s
    s4 = s2 * s2
    s16 = (s4 * s4) * (s4 * s4)
    return s4 * s16


# ---------------------------------------------------------------------------
# (a)–(j): smooth/classic benchmark functions
# ---------------------------------------------------------------------------

def ackley(x: Tensor) -> Tensor:
    s1 = torch.sqrt(torch.mean(x * x, dim=-1))
    s2 = torch.mean(torch.cos((2.0 * math.pi) * x), dim=-1)
    return -20.0 * torch.exp(-0.2 * s1) - torch.exp(s2) + 20.0 + math.e


def rastrigin(x: Tensor) -> Tensor:
    d = x.shape[-1]
    return 10.0 * d + torch.sum(x * x - 10.0 * torch.cos((2.0 * math.pi) * x),
                                dim=-1)


def rosenbrock(x: Tensor) -> Tensor:
    x0, x1 = x[..., :-1], x[..., 1:]
    a = x1 - x0 * x0
    b = 1.0 - x0
    return torch.sum(100.0 * (a * a) + b * b, dim=-1)


def dropwave(x: Tensor) -> Tensor:
    # n-D generalization of the classic 2-D DropWave.
    s = torch.sum(x * x, dim=-1)
    return -(1.0 + torch.cos(12.0 * torch.sqrt(s))) / (0.5 * s + 2.0)


def schwefel(x: Tensor) -> Tensor:
    d = x.shape[-1]
    return 418.9829 * d - torch.sum(x * torch.sin(torch.sqrt(torch.abs(x))),
                                    dim=-1)


def griewank(x: Tensor) -> Tensor:
    i = _arange1(x)
    return (torch.sum(x * x, dim=-1) / 4000.0
            - torch.prod(torch.cos(x / torch.sqrt(i)), dim=-1) + 1.0)


def trid(x: Tensor) -> Tensor:
    a = x - 1.0
    return torch.sum(a * a, dim=-1) - torch.sum(x[..., 1:] * x[..., :-1], dim=-1)


def michalewicz(x: Tensor) -> Tensor:
    i = _arange1(x)
    return -torch.sum(torch.sin(x) * _pow20(torch.sin(i * x * x / math.pi)),
                      dim=-1)


def sphere(x: Tensor) -> Tensor:
    return torch.sum(x * x, dim=-1)


def levy(x: Tensor) -> Tensor:
    w = 1.0 + (x - 1.0) / 4.0
    wi = w[..., :-1]
    s0 = torch.sin(math.pi * w[..., 0])
    t1 = s0 * s0
    si = torch.sin(math.pi * wi + 1.0)
    t2 = torch.sum((wi - 1.0) * (wi - 1.0) * (1.0 + 10.0 * (si * si)), dim=-1)
    wd = w[..., -1]
    sd = torch.sin((2.0 * math.pi) * wd)
    t3 = (wd - 1.0) * (wd - 1.0) * (1.0 + sd * sd)
    return t1 + t2 + t3


def weierstrass(x: Tensor, a: float = 0.5, b: float = 3.0,
                kmax: int = 20) -> Tensor:
    d = x.shape[-1]
    k = torch.arange(kmax + 1, dtype=x.dtype, device=x.device)
    ak = torch.pow(torch.tensor(a, dtype=x.dtype, device=x.device), k)
    bk = torch.pow(torch.tensor(b, dtype=x.dtype, device=x.device), k)
    inner = torch.sum(ak * torch.cos((2.0 * math.pi) * bk * (x[..., None] + 0.5)),
                      dim=-1)
    const = torch.sum(ak * torch.cos(math.pi * bk))
    return torch.sum(inner, dim=-1) - d * const


# ---------------------------------------------------------------------------
# (k): LND1–LND7 — Haarala's large-scale nonsmooth problems [14]
# ---------------------------------------------------------------------------

def lnd1_maxq(x: Tensor) -> Tensor:
    """MAXQ: max_i x_i^2."""
    return torch.amax(x * x, dim=-1)


def lnd2_mxhilb(x: Tensor) -> Tensor:
    """MXHILB: max_i |sum_j x_j / (i+j-1)|."""
    d = x.shape[-1]
    i = torch.arange(1, d + 1, device=x.device)[:, None]
    j = torch.arange(1, d + 1, device=x.device)[None, :]
    H = (1.0 / (i + j - 1.0)).to(x.dtype)
    return torch.amax(torch.abs(x @ H.T), dim=-1)


def lnd3_chained_lq(x: Tensor) -> Tensor:
    """Chained LQ: sum_i max{-x_i - x_{i+1}, -x_i - x_{i+1} + x_i^2 + x_{i+1}^2 - 1}."""
    a, b = x[..., :-1], x[..., 1:]
    t = -a - b
    return torch.sum(torch.maximum(t, t + a * a + b * b - 1.0), dim=-1)


def lnd4_chained_cb3_i(x: Tensor) -> Tensor:
    """Chained CB3 I: sum_i max of the three convex pieces."""
    a, b = x[..., :-1], x[..., 1:]
    a2 = a * a
    p1 = a2 * a2 + b * b
    p2 = (2.0 - a) * (2.0 - a) + (2.0 - b) * (2.0 - b)
    p3 = 2.0 * torch.exp(-a + b)
    return torch.sum(torch.maximum(torch.maximum(p1, p2), p3), dim=-1)


def lnd5_chained_cb3_ii(x: Tensor) -> Tensor:
    """Chained CB3 II: max of the three summed pieces."""
    a, b = x[..., :-1], x[..., 1:]
    a2 = a * a
    s1 = torch.sum(a2 * a2 + b * b, dim=-1)
    s2 = torch.sum((2.0 - a) * (2.0 - a) + (2.0 - b) * (2.0 - b), dim=-1)
    s3 = torch.sum(2.0 * torch.exp(-a + b), dim=-1)
    return torch.maximum(torch.maximum(s1, s2), s3)


def lnd6_active_faces(x: Tensor) -> Tensor:
    """Number of Active Faces: max_i { g(-sum x), g(x_i) }, g(y)=ln(|y|+1)."""
    def g(y: Tensor) -> Tensor:
        return torch.log(torch.abs(y) + 1.0)
    return torch.maximum(torch.amax(g(x), dim=-1), g(-torch.sum(x, dim=-1)))


def lnd7_brown2(x: Tensor) -> Tensor:
    """Nonsmooth generalized Brown function 2:
    sum_i |x_i|^{x_{i+1}^2+1} + |x_{i+1}|^{x_i^2+1}, with |x|^p computed as
    exp(p*log(|x|+eps)) for numeric stability at 0."""
    a, b = x[..., :-1], x[..., 1:]
    eps = 1e-12
    powa = torch.exp((b * b + 1.0) * torch.log(torch.abs(a) + eps))
    powb = torch.exp((a * a + 1.0) * torch.log(torch.abs(b) + eps))
    return torch.sum(powa + powb, dim=-1)


# ---------------------------------------------------------------------------
# §V.A: CEC'2008 shifted Rosenbrock (F_bias = 390)
# ---------------------------------------------------------------------------

def shift_vector(dim: int, seed: int = 2008, lo: float = -90.0,
                 hi: float = 90.0, device: str | torch.device = "cpu") -> Tensor:
    """Deterministic stand-in for the CEC'2008 shift data file: the same
    float32 bits as the JAX package's ``jax.random.uniform`` draw."""
    return prng.uniform(prng.PRNGKey(seed, device), (dim,), lo, hi)


def make_shifted_rosenbrock(dim: int, seed: int = 2008, bias: float = 390.0,
                            shift: Tensor | None = None) -> Function:
    """CEC'2008 shifted Rosenbrock, ``rosenbrock(x - o + 1) + bias``, with
    ``o = shift_vector(dim, seed)`` unless a ``(dim,)`` ``shift`` is given."""
    o = shift_vector(dim, seed) if shift is None else shift.float().cpu()
    if tuple(o.shape) != (dim,):
        raise ValueError(f"shift has shape {tuple(o.shape)}, expected ({dim},)")
    copies: dict = {}

    def fn(x: Tensor) -> Tensor:
        z = x - on_device(o, x.device, copies) + 1.0
        return rosenbrock(z) + bias

    return Function("shifted_rosenbrock", fn, -100.0, 100.0, f_star=bias,
                    shift=o, bias=bias, _shift_copies=copies)


# ---------------------------------------------------------------------------
# Registry — the §V.B testbed (domains follow the classical definitions).
# ---------------------------------------------------------------------------

FUNCTIONS: dict[str, Function] = {
    "ackley": Function("ackley", ackley, -32.768, 32.768),
    "rastrigin": Function("rastrigin", rastrigin, -5.12, 5.12),
    "rosenbrock": Function("rosenbrock", rosenbrock, -100.0, 100.0),
    "dropwave": Function("dropwave", dropwave, -5.12, 5.12, f_star=-1.0),
    "schwefel": Function("schwefel", schwefel, -500.0, 500.0),
    "griewank": Function("griewank", griewank, -600.0, 600.0),
    "trid": Function("trid", trid, -100.0, 100.0, f_star=float("-inf")),
    "michalewicz": Function("michalewicz", michalewicz, 0.0, math.pi,
                            f_star=float("-inf")),
    "sphere": Function("sphere", sphere, -100.0, 100.0),
    "levy": Function("levy", levy, -10.0, 10.0),
    "weierstrass": Function("weierstrass", weierstrass, -0.5, 0.5),
    "lnd1": Function("lnd1", lnd1_maxq, -10.0, 10.0, smooth=False),
    "lnd2": Function("lnd2", lnd2_mxhilb, -10.0, 10.0, smooth=False),
    "lnd3": Function("lnd3", lnd3_chained_lq, -10.0, 10.0, smooth=False),
    "lnd4": Function("lnd4", lnd4_chained_cb3_i, -10.0, 10.0, smooth=False),
    "lnd5": Function("lnd5", lnd5_chained_cb3_ii, -10.0, 10.0, smooth=False),
    "lnd6": Function("lnd6", lnd6_active_faces, -10.0, 10.0, smooth=False),
    "lnd7": Function("lnd7", lnd7_brown2, -1.0, 1.0, smooth=False),
}


def get(name: str, dim: int | None = None) -> Function:
    if name == "shifted_rosenbrock":
        if dim is None:
            raise ValueError("shifted_rosenbrock needs dim for its shift vector")
        return make_shifted_rosenbrock(dim)
    return FUNCTIONS[name]
