"""Adam — popt4jlib.GradientDescent.stochastic.Adam [9], in two forms
(counterpart of ``repro.optim.adam``).

1. ``adam_minimize``: the paper's FunctionIntf optimizer (budget-capped,
   Richardson or autodiff gradients) for the Fig.4-style testbed.
2. ``init``/``update``: Adam(W) over a tree of tensors (nested dicts) for
   the LM training substrate, with decoupled weight decay, global-norm
   clipping and a warmup+cosine schedule. ``update_`` writes params and
   moments in place (the reference's train step donates its params and
   state, so a step holds one copy of them); ``update`` is ``update_`` on
   copies, the given trees left as they were.

Division by a constant is a product with its float32 reciprocal and
``b ** step`` a float32 power, as the reference rounds them
(``repro_torch.f32``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import f32, prng
from repro_torch.core.api import OptimizeResult
from repro_torch.functions.benchmarks import Function
from repro_torch.optim.numgrad import make_grad
from repro_torch.parallel import ctx

Tensor = torch.Tensor
Tree = Any   # a tensor, or a dict of trees


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """Adam hyperparameters: moments, decoupled weight decay, global-norm
    clip and the warmup+cosine learning-rate schedule."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0          # global-norm clip; <=0 disables
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamState(NamedTuple):
    """Optimizer state: step count plus first/second moment trees."""

    step: Tensor
    mu: Tree
    nu: Tree


def tree_map(fn: Callable[..., Tensor], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list[Tensor]:
    """The leaves in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init(params: Tree) -> AdamState:
    """Zero-initialized AdamState shaped like ``params`` (float32 moments)."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    leaf = tree_leaves(params)[0]
    step = ctx.like(torch.zeros((), dtype=torch.int32, device=leaf.device), leaf)
    return AdamState(step=step, mu=zeros, nu=tree_map(torch.clone, zeros))


def _over(x: Tensor, n: int) -> Tensor:
    """``x / n`` for a constant ``n``, as XLA computes it."""
    return x * f32.const(1.0 / f32.const(n))


def schedule(step: Tensor, cfg: AdamConfig) -> Tensor:
    """Linear warmup then cosine decay to min_lr_frac * lr."""
    warm = torch.clamp(_over((step + 1).float(), max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(_over((step - cfg.warmup_steps).float(),
                             max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = (cfg.min_lr_frac
           + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(f32.const(math.pi) * prog)))
    return cfg.lr * warm * cos


def update(grads: Tree, state: AdamState, params: Tree,
           cfg: AdamConfig) -> tuple[Tree, AdamState]:
    """One Adam(W) step: returns (new_params, new_state), ``params`` and
    ``state`` untouched (:func:`update_` on copies of them)."""
    params, mu, nu = (tree_map(torch.clone, t) for t in (params, state.mu, state.nu))
    return params, update_(grads, AdamState(step=state.step, mu=mu, nu=nu), params, cfg)


def update_(grads: Tree, state: AdamState, params: Tree, cfg: AdamConfig) -> AdamState:
    """One Adam(W) step in place: ``params`` and the moments of ``state``
    are overwritten leaf by leaf, and the new state, whose moments are the
    same tensors, is returned. Each product and sum is rounded as the
    reference's pure update rounds it; only one leaf's temporaries live at
    a time."""
    step = state.step + 1
    scale = None
    if cfg.grad_clip > 0:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - f32.pow(cfg.b1, step.float())
    bc2 = 1 - f32.pow(cfg.b2, step.float())
    lr = schedule(state.step, cfg)
    for g, p, m, v in zip(*map(tree_leaves, (grads, params, state.mu, state.nu))):
        g = (g if scale is None else g * scale).float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        delta = lr * (m / bc1 / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float())
        p.copy_((p.float() - delta).to(p.dtype))
    return AdamState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# FunctionIntf form (Fig.4 testbed)
# ---------------------------------------------------------------------------

def adam_minimize(f: Function, key: Tensor, dim: int, max_evals: int = 100_000,
                  lr: float = 0.05, grad_mode: str = "richardson",
                  b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> OptimizeResult:
    """Budget-capped Adam on a FunctionIntf objective (Fig.4 protocol). The
    loop's length depends only on the evaluation counts, so it runs on the
    host without reading the device."""
    lo, hi = f.lo, f.hi
    grad_fn = make_grad(f.fn, grad_mode)
    x = prng.uniform(key, (dim,), lo, hi)
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    bx, bf = x, f.fn(x)
    t, evals = 0, 1
    while evals < max_evals:
        g, ge = grad_fn(x)
        t += 1
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        tt = torch.tensor(float(t))
        mh = m / float(1 - f32.pow(b1, tt))
        vh = v / float(1 - f32.pow(b2, tt))
        x = torch.clamp(x - lr * mh / (torch.sqrt(vh) + eps), lo, hi)
        fx = f.fn(x)
        best = fx < bf
        bx, bf = torch.where(best, x, bx), torch.where(best, fx, bf)
        evals += ge + 1
    return OptimizeResult(arg=bx.cpu().numpy(), value=float(bf), n_evals=evals)
