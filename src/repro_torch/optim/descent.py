"""popt4jlib.GradientDescent — classical saddle-point methods in PyTorch
(counterpart of ``repro.optim.descent``).

  ASD   steepest descent + Armijo rule with restarts
        (Fig.4 params: rho=0.1, beta=0.8, gamma=1, gtol=1e-6)
  FCG   conjugate gradient, Fletcher-Reeves or Polak-Ribiere updates, restarts
        (the paper's Fletcher line search is realized as Armijo backtracking,
        as in the reference)
  AVD   alternating-variables descent with expanding coordinate probes and
        optional quantization of variables (box + discrete sets)
  BFGS  Newton's method with dense BFGS updates + Armijo steps

All methods are budget-capped in *function evaluations* (Fig.4 protocol) and
use Richardson numeric gradients by default (4D evaluations per gradient,
charged to the budget exactly as the paper does).

The module has two faces (popt4jlib ``LocalOptimizerIntf``):

* standalone optimizers (``asd``/``fcg``/``avd``/``bfgs``) — multistart,
  budget-driven runs for Fig.4-style experiments. The reference runs each as
  one ``lax.while_loop``; here the loop runs on the host and reads its
  condition from the device once per iteration (and once per Armijo
  backtrack). That synchronisation is the cost of a data-dependent loop
  in eager PyTorch, not a fallback: every evaluation stays on the device;
* the **batched polish layer** (``PolishConfig`` / ``make_polish``) — a
  fixed-iteration, fixed-shape, deterministic variant of the same four
  methods that refines a ``(K, dim)`` batch of candidates. It routes every
  probe and line-search trial through a pluggable batch evaluator (the
  engine's, so on the card every probe batch runs the ``bench_eval``
  kernel), reads nothing back to the host and has a statically known
  evaluation cost (``polish_evals_per_point``).

Arithmetic follows XLA's roundings where they decide a trajectory
(``repro_torch.f32``): ``x + t * d`` with a traced ``t`` is one fused
multiply-add, a division by a constant is a product with its float32
reciprocal. Norms, dot products and BFGS's matrix products are summed in
float64 and rounded once, so they give the same bits on the CPU and on the
card (a float32 sum in another order would move a polished point by an ulp,
which the next Richardson gradient amplifies by about f / (2h |g|)).
``argmax`` and ``argmin`` take the first index on ties, in both packages.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import f32, prng
from repro_torch.core.api import OptimizeResult
from repro_torch.functions.benchmarks import Function
from repro_torch.optim.numgrad import make_grad, richardson

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DescentConfig:
    """Standalone descent-run parameters: eval budget, Armijo line search,
    gradient cost model and the AVD quantization/probe controls."""

    max_evals: int = 100_000
    rho: float = 0.1          # Armijo sufficient-decrease
    beta: float = 0.8         # Armijo backtracking factor
    gamma: float = 1.0        # Armijo initial step
    gtol: float = 1e-6
    max_backtracks: int = 40
    grad_mode: str = "richardson"   # richardson | autodiff
    cg_update: str = "fr"     # fr | pr
    avd_quantum: float = 0.0  # >0: variables restricted to multiples of quantum
    avd_expansions: int = 8


def _dot(a: Tensor, b: Tensor, keepdim: bool = False) -> Tensor:
    """``sum(a * b)`` over the last axis, summed in float64, rounded once."""
    return torch.sum(a.double() * b.double(), dim=-1, keepdim=keepdim).float()


def _norm(a: Tensor, keepdim: bool = False) -> Tensor:
    """The Euclidean norm over the last axis, in float64, rounded once."""
    return torch.sqrt(torch.sum(torch.square(a.double()), dim=-1, keepdim=keepdim)).float()


def _mul(a: float, b: float) -> float:
    """The float32 product of two float32 values, as a Python float."""
    return f32.const(a * b)


def _armijo(fn, x: Tensor, fx: Tensor, g: Tensor, d: Tensor,
            cfg: DescentConfig) -> tuple[Tensor, Tensor, int]:
    """Backtracking Armijo along d. Returns (x_new, f_new, evals_used).

    The direction is normalized so the initial trial step ``gamma`` is a
    *distance* in the box. The step ``t`` is a float32 value kept on the
    host; each backtrack reads the Armijo test from the device."""
    d = d / torch.clamp(_norm(d), min=1e-30)
    gd = _dot(g, d)
    rho, beta = f32.const(cfg.rho), f32.const(cfg.beta)

    def bound(t: float) -> Tensor:
        return f32.fma(_mul(rho, t), gd, fx)

    t = f32.const(cfg.gamma)
    f_t = fn(f32.fma(t, d, x))
    k = 0
    while k < cfg.max_backtracks and bool(f_t > bound(t)):
        t = _mul(t, beta)
        f_t = fn(f32.fma(t, d, x))
        k += 1
    ok = f_t <= bound(t)
    return (torch.where(ok, f32.fma(t, d, x), x), torch.where(ok, f_t, fx), k + 1)


def _descend(f: Function, x0: Tensor, key: Tensor, cfg: DescentConfig,
             method: str, cg_update: str) -> OptimizeResult:
    """Restarted ASD/FCG from ``x0``: each iteration an Armijo step and a
    new gradient; a converged or stalled iterate restarts from a uniform
    point drawn from the iteration's key. Budget-capped."""
    lo, hi = f.lo, f.hi
    grad_fn = make_grad(f.fn, cfg.grad_mode)
    gtol = f32.const(cfg.gtol)
    fx = f.fn(x0)
    g, ge = grad_fn(x0)
    x, d, gg_prev = x0, -g, _dot(g, g)
    evals = ge + 1
    best_x, best_f = x0, fx
    while evals < cfg.max_evals:
        x1, f1, ls_evals = _armijo(f.fn, x, fx, g, d, cfg)
        g1, ge = grad_fn(x1)
        gg1 = _dot(g1, g1)
        if method == "fcg":
            if cg_update == "fr":
                b = gg1 / torch.clamp(gg_prev, min=1e-30)
            else:  # PR+
                b = torch.clamp(_dot(g1, g1 - g) / torch.clamp(gg_prev, min=1e-30), min=0.0)
            d1 = f32.fma(b, d, -g1)
            d1 = torch.where(_dot(d1, g1) < 0, d1, -g1)  # keep descent
        else:
            d1 = -g1
        # multistart: restart from a random point when converged/stalled
        done = bool((f32.sqrt(gg1) < gtol) | (f1 >= fx - f32.const(1e-15)))
        ks = prng.split(key)
        key = ks[0]
        evals += ls_evals + ge
        if done:
            x = prng.uniform(ks[1], (x0.shape[-1],), lo, hi)
            fx = f.fn(x)
            g, ger = grad_fn(x)
            d, gg_prev = -g, _dot(g, g)
            evals += ger + 1
        else:
            x, fx, g, d, gg_prev = x1, f1, g1, d1, gg1
        better = fx < best_f
        best_x, best_f = torch.where(better, x, best_x), torch.where(better, fx, best_f)
    return OptimizeResult(arg=best_x.cpu().numpy(), value=float(best_f),
                          n_evals=int(evals))


def _directional(f: Function, key: Tensor, dim: int, cfg: DescentConfig,
                 method: str) -> OptimizeResult:
    """Shared restarted descent for ASD and FCG, from a uniform start."""
    ks = prng.split(key)
    x0 = prng.uniform(ks[0], (dim,), f.lo, f.hi)
    return _descend(f, x0, ks[1], cfg, method, cfg.cg_update)


def asd(f: Function, key: Tensor, dim: int,
        cfg: DescentConfig = DescentConfig()) -> OptimizeResult:
    """ArmijoSteepestDescent: multistart steepest descent, budget-capped."""
    return _directional(f, key, dim, cfg, "asd")


def fcg(f: Function, key: Tensor, dim: int,
        cfg: DescentConfig = DescentConfig()) -> OptimizeResult:
    """FletcherConjugateGradient: multistart nonlinear CG (FR or PR+)."""
    return _directional(f, key, dim, cfg, "fcg")


# ---------------------------------------------------------------------------
# Batched polish layer — popt4jlib LocalOptimizerIntf inside the island engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolishConfig:
    """Fixed-shape local-descent polish of a candidate batch.

    A polish is *iteration*-capped: ``steps`` descent iterations, each
    costing a statically known number of evaluations (see
    :func:`polish_evals_per_point`), so the engine can charge polish work to
    its budget in advance. The backtracking loop of ``_armijo`` becomes a
    *ladder*: all ``n_ladder`` trial steps are evaluated as one batch, and
    the largest Armijo-admissible step wins — falling back to the best
    improving trial, or to the incumbent itself, so polish is monotone.
    """

    method: str = "asd"       # asd | fcg | avd | bfgs
    steps: int = 3            # descent iterations per polish call
    n_ladder: int = 8         # line-search trial steps, gamma * beta^j
    gamma: float = 1.0        # largest trial step (a distance)
    beta: float = 0.5         # ladder decay
    rho: float = 1e-4         # Armijo sufficient-decrease slope
    grad_h: float = 1e-4      # Richardson probe step
    avd_span: float = 0.1     # AVD: largest probe, as a fraction of (hi - lo)

    def __post_init__(self) -> None:
        if self.method not in ("asd", "fcg", "avd", "bfgs"):
            raise ValueError(f"unknown polish method {self.method!r}")


def polish_evals_per_point(dim: int, cfg: PolishConfig) -> int:
    """Function evaluations one polished point costs — exact, by construction.

    Gradient methods: per step, one Richardson gradient (4·dim probes) plus
    ``n_ladder`` line-search trials. AVD: per step, a ±ladder probe on every
    coordinate (2·dim·n_ladder), from which the single best move is taken.
    """
    if cfg.method == "avd":
        return cfg.steps * 2 * dim * cfg.n_ladder
    return cfg.steps * (4 * dim + cfg.n_ladder)


def _ladder(scale: float, beta: float, n: int, like: Tensor) -> Tensor:
    """``scale * beta ** arange(n)`` in float32 (a float32 power, as the
    reference's ``beta ** jnp.arange(n, dtype)``), on ``like``'s device."""
    j = torch.arange(n, dtype=torch.float32)
    return (f32.const(scale) * f32.pow(beta, j)).to(like.device)


def _batched_richardson(evaluate, x: Tensor, h: float) -> Tensor:
    """Richardson 4th-order gradients for a (K, D) batch, all 4·K·D probe
    points in ONE evaluator call."""
    K, D = x.shape
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    xb = x[:, None, :]
    hs, h2 = f32.const(h) * eye, f32.const(2 * h) * eye
    probes = torch.cat([xb + hs, xb - hs, xb + h2, xb - h2], dim=1)   # (K, 4D, D)
    vals = evaluate(probes.reshape(K * 4 * D, D)).reshape(K, 4, D)
    return richardson(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3], h)


def _take(a: Tensor, j: Tensor) -> Tensor:
    """Row ``j[k]`` of ``a[k]`` for each k: ``a`` is ``(K, N, ...)``."""
    return a[torch.arange(a.shape[0], device=a.device), j]


def _ladder_search(evaluate, x: Tensor, fx: Tensor, g: Tensor, d: Tensor,
                   lo: float, hi: float, cfg: PolishConfig) -> tuple[Tensor, Tensor]:
    """Batched Armijo ladder along per-row directions ``d``.

    Evaluates the whole geometric ladder ``gamma·beta^j`` at once, accepts the
    largest admissible step per row (or the best improving trial when none
    passes Armijo — box clipping can break the slope condition near a bound),
    and never moves a row uphill."""
    K, D = x.shape
    L = cfg.n_ladder
    dn = d / torch.clamp(_norm(d, keepdim=True), min=1e-30)
    gd = _dot(g, dn)                                        # (K,)
    ts = _ladder(cfg.gamma, cfg.beta, L, x)
    cand = torch.clamp(f32.fma(ts[None, :, None], dn[:, None, :], x[:, None, :]), lo, hi)
    fc = evaluate(cand.reshape(K * L, D)).reshape(K, L)
    ok = fc <= f32.fma((f32.const(cfg.rho) * ts)[None, :], gd[:, None], fx[:, None])
    j = torch.where(ok.any(dim=1), torch.argmax(ok.to(torch.uint8), dim=1),
                    torch.argmin(fc, dim=1))
    xj, fj = _take(cand, j), _take(fc, j)
    better = fj < fx
    return torch.where(better[:, None], xj, x), torch.where(better, fj, fx)


def make_polish(f: Function, evaluate, dim: int,
                cfg: PolishConfig = PolishConfig()):
    """Build ``polish(xs (K, dim), fs (K,)) -> (xs', fs')`` for objective ``f``.

    Deterministic and fixed-shape, with no host synchronisation. ``evaluate``
    is a ``(N, dim) -> (N,)`` batch evaluator — pass the engine's
    ``make_batch_evaluator`` product so polish probes hit the same torch/cuda
    backend as generation steps, or ``None`` for the plain ``f.fn``. Rows
    are independent, so a batch gives each row what it alone would get.

    ASD/FCG(FR)/BFGS carry direction/curvature memory across the ``steps``
    iterations of one call and restart fresh each call; AVD takes the
    single best coordinate move of a ±ladder on every coordinate per step.
    """
    if evaluate is None:
        evaluate = f.fn
    lo, hi = f.lo, f.hi
    L = cfg.n_ladder

    if cfg.method == "avd":
        span = cfg.avd_span * (hi - lo)

        def polish_avd(xs: Tensor, fs: Tensor) -> tuple[Tensor, Tensor]:
            K, D = xs.shape
            ts = _ladder(span, cfg.beta, L, xs)                   # (L,)
            eye = torch.eye(D, dtype=xs.dtype, device=xs.device)
            sign = torch.tensor([1.0, -1.0], dtype=xs.dtype, device=xs.device)
            # (1, D, 2, L, D): per coordinate, ± each ladder step
            moves = (eye[None, :, None, None, :] * ts[None, None, None, :, None]
                     * sign[None, None, :, None, None])
            for _ in range(cfg.steps):
                cand = torch.clamp(xs[:, None, None, None, :] + moves, lo, hi)
                fc = evaluate(cand.reshape(K * D * 2 * L, D)).reshape(K, D * 2 * L)
                j = torch.argmin(fc, dim=1)
                fj, xj = _take(fc, j), _take(cand.reshape(K, D * 2 * L, D), j)
                better = fj < fs
                xs, fs = torch.where(better[:, None], xj, xs), torch.where(better, fj, fs)
            return xs, fs

        return polish_avd

    method = cfg.method

    def polish_grad(xs: Tensor, fs: Tensor) -> tuple[Tensor, Tensor]:
        K, D = xs.shape
        x, fx = xs, fs
        if method == "fcg":
            d_prev = torch.zeros_like(xs)
            gg_prev = torch.full((K,), torch.inf, dtype=xs.dtype, device=xs.device)
        elif method == "bfgs":
            eye = torch.eye(D, dtype=xs.dtype, device=xs.device).expand(K, D, D)
            x_prev, g_prev, H = xs, torch.zeros_like(xs), eye
        for _ in range(cfg.steps):
            g = _batched_richardson(evaluate, x, cfg.grad_h)
            if method == "fcg":
                gg = _dot(g, g)
                b = gg / gg_prev           # first step: gg_prev = inf -> b = 0
                d = f32.fma(b[:, None], d_prev, -g)
                dg = _dot(d, g)
                d = torch.where((dg < 0)[:, None], d, -g)    # keep descent
                d_prev, gg_prev = d, gg
            elif method == "bfgs":
                s, y = x - x_prev, g - g_prev
                sy = _dot(s, y)
                ok = sy > 1e-10            # first step: s = 0 -> H stays I
                r = torch.where(ok, torch.ones_like(sy) / torch.where(ok, sy, 1.0), 0.0)
                V = eye - r[:, None, None] * s[:, :, None] * y[:, None, :]
                Vd = V.double()
                H1 = (Vd @ H.double() @ Vd.transpose(1, 2)).float() + (
                    r[:, None, None] * s[:, :, None] * s[:, None, :])
                H = torch.where(ok[:, None, None], H1, H)
                d = -(H.double() @ g.double()[:, :, None])[:, :, 0].float()
                dg = _dot(d, g)
                d = torch.where((dg < 0)[:, None], d, -g)
                x_prev, g_prev = x, g
            else:                          # asd
                d = -g
            x, fx = _ladder_search(evaluate, x, fx, g, d, lo, hi, cfg)
        return x, fx

    return polish_grad


# ---------------------------------------------------------------------------
# AVD — AlternatingVariablesDescent
# ---------------------------------------------------------------------------

def avd(f: Function, key: Tensor, dim: int,
        cfg: DescentConfig = DescentConfig()) -> OptimizeResult:
    """One variable at a time with doubling probe steps both ways; a stalled
    sweep triggers a random restart. ``avd_quantum`` > 0 restricts moves to
    integer multiples of the quantum (the paper's discrete-variable support).
    A sweep's probes depend on each other, so they run one by one on the
    device; the host reads one value per sweep (the stall test)."""
    lo, hi = f.lo, f.hi
    q = cfg.avd_quantum
    step0 = 0.1 * (hi - lo) if q <= 0 else q
    inv_q = f32.const(1.0 / f32.const(q)) if q > 0 else 0.0

    def snap(v: Tensor) -> Tensor:
        # round(v / q) * q, with XLA's product by the reciprocal of q.
        return v if q <= 0 else torch.round(v * inv_q) * f32.const(q)

    # The ladder both coarser and finer than step0, each step a float32.
    ladder = [float(snap(torch.tensor(f32.const(step0 * 2.0 ** j))))
              for j in range(-cfg.avd_expansions, cfg.avd_expansions + 1)]

    def sweep(x: Tensor, fx: Tensor) -> tuple[Tensor, Tensor]:
        for i in range(dim):
            for sgn in (1.0, -1.0):
                for st in ladder:
                    cand = x.clone()
                    cand[i] = torch.clamp(x[i] + sgn * st, lo, hi)
                    fc = f.fn(cand)
                    better = fc < fx
                    x, fx = torch.where(better, cand, x), torch.where(better, fc, fx)
        return x, fx

    ks = prng.split(key)
    key = ks[1]
    x = snap(prng.uniform(ks[0], (dim,), lo, hi))
    fx = f.fn(x)
    evals, bx, bf = 1, x, fx
    per_sweep = dim * 2 * len(ladder)
    while evals < cfg.max_evals:
        x1, f1 = sweep(x, fx)
        evals += per_sweep
        stalled = bool(f1 >= fx - f32.const(1e-15))
        ks = prng.split(key)
        key = ks[0]
        if stalled:
            x = snap(prng.uniform(ks[1], (dim,), lo, hi))
            fx = f.fn(x)
            evals += 1
        else:
            x, fx = x1, f1
        best = fx < bf
        bx, bf = torch.where(best, x, bx), torch.where(best, fx, bf)
    return OptimizeResult(arg=bx.cpu().numpy(), value=float(bf), n_evals=evals)


# ---------------------------------------------------------------------------
# BFGS — Newton's method with BFGS updates + Armijo
# ---------------------------------------------------------------------------

def bfgs(f: Function, key: Tensor, dim: int,
         cfg: DescentConfig = DescentConfig()) -> OptimizeResult:
    """Quasi-Newton descent with dense BFGS updates + Armijo steps."""
    lo, hi = f.lo, f.hi
    grad_fn = make_grad(f.fn, cfg.grad_mode)
    gtol = f32.const(cfg.gtol)
    ks = prng.split(key)
    key = ks[1]
    x = prng.uniform(ks[0], (dim,), lo, hi)
    fx = f.fn(x)
    g, ge = grad_fn(x)
    eye = torch.eye(dim, dtype=x.dtype, device=x.device)
    H, bx, bf, evals = eye, x, fx, ge + 1
    while evals < cfg.max_evals:
        d = -(H.double() @ g.double()).float()
        d = torch.where(_dot(d, g) < 0, d, -g)
        x1, f1, ls = _armijo(f.fn, x, fx, g, d, cfg)
        g1, ge = grad_fn(x1)
        s, y = x1 - x, g1 - g
        sy = _dot(s, y)
        ok = sy > 1e-10
        rho_ = torch.where(ok, torch.ones_like(sy) / torch.where(ok, sy, 1.0), 0.0)
        V = (eye - rho_ * torch.outer(s, y)).double()
        H1 = torch.where(ok, (V @ H.double() @ V.T).float() + rho_ * torch.outer(s, s), H)
        done = bool(_norm(g1) < gtol)
        ks = prng.split(key)
        key = ks[0]
        evals += ls + ge
        if done:
            x = prng.uniform(ks[1], (dim,), lo, hi)
            fx = f.fn(x)
            g, ger = grad_fn(x)
            H = eye
            evals += ger + 1
        else:
            x, fx, g, H = x1, f1, g1, H1
        best = fx < bf
        bx, bf = torch.where(best, x, bx), torch.where(best, fx, bf)
    return OptimizeResult(arg=bx.cpu().numpy(), value=float(bf), n_evals=evals)
